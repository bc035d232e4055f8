"""The yardstick: the card's published peaks and the arithmetic of an NA
launch's least time.

``bound``, ``k1_bound`` and ``fused_bound`` are frozen copies of
``chip_smoke.py``'s (lines 1329-1334, 1082-1099 and 1114-1131), unchanged
but for the imports; ``na_bound`` feeds them one semantic graph's work as
the problem states it, with no layout: a 1-byte mask and a 4-byte id for
each valid slot, a 4-byte row pointer a destination plus one, θ_u* of each
distinct source row, θ_*v, each distinct kept h' row once, and the output.
"""
from __future__ import annotations

import torch

# published peaks of one NVIDIA H100 SXM (dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores: the port runs TF32 off


def bound(nbytes: int, nops: int):
    """(least ms, what bounds it, bytes, operations) on the published H100
    peaks."""
    b_ms, o_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_F32_FLOPS * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", nbytes, nops


def k1_bound(msk, nbr, ety, theta_src, theta_rel, theta_dst, alpha, ids, table_bytes: int = 0):
    """A K1's bound from this run's inputs: the bytes of every slot's mask,
    the ids (and edge types) of the valid slots, the theta_src rows they
    reference, theta_rel, theta_dst, the row tables and the outputs; the
    operations of a head sum (two adds a head with theta_rel) and a compare
    a valid slot, and six an output alpha. Returns (bound, valid slots,
    distinct source rows)."""
    valid = int(msk.sum())
    src_rows = int(torch.unique(nbr[msk]).numel())
    heads = theta_src.shape[1]
    rel = theta_rel is not None
    nbytes = msk.numel() * msk.element_size() + valid * (nbr.element_size() + (ety.element_size() if rel else 0)) \
        + (src_rows * heads + (theta_rel.numel() if rel else 0) + theta_dst.numel()) * 4 + table_bytes \
        + (alpha.numel() + ids.numel()) * 4
    nops = valid * ((2 if rel else 1) * heads + 1) + alpha.numel() * 6
    return bound(nbytes, nops), valid, src_rows


def fused_bound(k1, alpha, ids, h_proj, out):
    """A fused launch's bound: its K1's bytes and operations (``k1``, from
    ``k1_bound``) less the alpha and ids writes and the six operations an
    output alpha, which it need not make, plus six operations a retained
    slot and head (its softmax runs on retained slots only), each distinct
    retained h' row once, the output, and an FMA a retained slot and
    output."""
    _, _, nbytes, nops = k1
    retained = ids[ids >= 0]
    heads, hdim = h_proj.shape[1], h_proj.shape[1] * h_proj.shape[2]
    nbytes += -(alpha.numel() + ids.numel()) * 4 + int(torch.unique(retained).numel()) * hdim * 4 + out.numel() * 4
    nops += (int(retained.numel()) * heads - alpha.numel()) * 6 + 2 * int(retained.numel()) * hdim
    return bound(nbytes, nops)


def na_bound(src: torch.Tensor, kept_src: torch.Tensor, n_dst: int, h_shape):
    """The least time of one semantic graph's NA (``fused_bound``'s tuple):
    ``src`` the global source id of every valid slot, ``kept_src`` of every
    kept slot, ``h_shape`` the projected table's (N, H, dh)."""
    n, heads, dh = h_shape
    meta = "meta"
    msk = torch.ones(src.shape, dtype=torch.bool, device=src.device)
    nbr = src.to(torch.int32)
    theta_src = torch.empty((n, heads), device=meta)
    theta_dst = torch.empty((n_dst, heads), device=meta)
    alpha = torch.empty((kept_src.numel(), heads), device=meta)
    ids = kept_src.to(torch.int32)
    k1 = k1_bound(msk, nbr, None, theta_src, None, theta_dst, alpha, ids, (n_dst + 1) * 4)[0]
    return fused_bound(k1, alpha, ids, torch.empty((n, heads, dh), device=meta),
                       torch.empty((n_dst, heads, dh), device=meta))
