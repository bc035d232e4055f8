"""Plain PyTorch versions of the CUDA kernels in ``csrc/``.

They walk the same layouts with the same rule as the kernels:

  * :func:`prune_plain` (grouped K1) streams each row's candidates one
    column at a time, vectorized over all grouped rows, through the
    ``min_replace`` step of ``kernels/common.py`` (first-minimum eviction,
    strict ``>``), copies bypass rows straight into their slots, and
    flushes LeakyReLU + masked softmax at the end. The head sum is taken
    left to right, as the kernel takes it, so kernel and plain ranks — and
    the retained ids — are bit-identical.
  * :func:`aggregate_plain` (grouped K2) accumulates ``alpha · h'[id]`` over
    each row's own ``k_eff`` slots in slot order.
  * :func:`flat_prune_plain` and :func:`flat_aggregate_plain` are the same
    two steps over one flat ``(T, D)`` padded-CSC table with one domain
    width ``k`` for every row and no bypass.
  * :func:`prune_aggregate_plain` and :func:`flat_prune_aggregate_plain`,
    the plain versions of the fused launches, run the two steps in
    sequence.

The wrapper in ``ops.py`` uses these for CPU tensors; ``chip_smoke.py``
holds the kernels against them on the card. They take tensors of any
device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.common import NEG, POS, min_replace


def prune_plain(
    nbr: torch.Tensor,  # (G, t_tile, w) int32 global source ids
    msk: torch.Tensor,  # (G, t_tile, w) bool
    ety: Optional[torch.Tensor],  # (G, t_tile, w) int32, with theta_rel
    theta_src: torch.Tensor,  # (N, H) f32
    theta_rel: Optional[torch.Tensor],  # (R, H) f32
    theta_dst: torch.Tensor,  # (T, H) f32
    row_targets: torch.Tensor,  # (rows,) int32
    blk: torch.Tensor,  # (4, n_blocks) int32: first step, n_dt, bypass, k_eff
    k_s: int,
    slope: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: retention domain + softmax -> alpha (rows, k_s, H) f32 and the
    retained global ids (rows, k_s) int32, -1 = empty."""
    dev = theta_src.device
    _, t_tile, w = nbr.shape
    rows = blk.shape[1] * t_tile
    first, n_dt, bypass, k_eff = (
        blk[i].long().repeat_interleave(t_tile) for i in range(4)
    )
    sub = torch.arange(rows, device=dev) % t_tile
    slot = torch.arange(k_s, device=dev)
    rd_rank = torch.full((rows, k_s), POS, dtype=torch.float32, device=dev)
    rd_rank.masked_fill_(slot[None, :] < k_eff[:, None], NEG)
    rd_id = torch.full((rows, k_s), -1, dtype=torch.long, device=dev)
    rd_ety = torch.zeros((rows, k_s), dtype=torch.long, device=dev)
    byp = bypass != 0
    for dt in range(int(n_dt.max()) if rows else 0):
        live = dt < n_dt
        step = torch.where(live, first + dt, first)
        c_nbr = nbr[step, sub].long()  # (rows, w)
        c_msk = msk[step, sub] & live[:, None]
        c_ety = ety[step, sub].long() if ety is not None else torch.zeros_like(c_nbr)
        th = theta_src[c_nbr]  # (rows, w, H)
        if theta_rel is not None:
            th = th + theta_rel[c_ety]
        rank = _head_sum(th)
        rank = torch.where(c_msk, rank, torch.full_like(rank, NEG))
        gid = torch.where(c_msk, c_nbr, torch.full_like(c_nbr, -1))
        # §4.3 bypass rows: candidate j of D-tile dt goes to slot dt*w + j
        # (a live bypass row has k_eff = n_dt*w <= k_s, so the slice fits)
        cols = slice(dt * w, dt * w + w)
        if dt * w + w <= k_s:
            sel = (byp & live)[:, None]
            rd_rank[:, cols] = torch.where(sel, rank, rd_rank[:, cols])
            rd_id[:, cols] = torch.where(sel, gid, rd_id[:, cols])
            rd_ety[:, cols] = torch.where(sel, c_ety, rd_ety[:, cols])
        # pruned rows: min-replace insert, one candidate column at a time;
        # NEG never replaces anything, so other rows pass through unchanged
        cand = torch.where((~byp & live)[:, None], rank, torch.full_like(rank, NEG))
        for j in range(w):
            rd_rank, (rd_id, rd_ety) = min_replace(
                rd_rank, [(rd_id, gid[:, j]), (rd_ety, c_ety[:, j])], cand[:, j]
            )
    ok = (rd_rank > NEG / 2) & (slot[None, :] < k_eff[:, None])
    return _flush(
        ok, rd_id, rd_ety, theta_src, theta_rel, theta_dst[row_targets.long()], slope
    )


def _head_sum(th: torch.Tensor) -> torch.Tensor:
    """Sum over the last (head) axis, left to right, as the kernels sum."""
    rank = th[..., 0]
    for hh in range(1, th.shape[-1]):
        rank = rank + th[..., hh]
    return rank


def _flush(ok, rd_id, rd_ety, theta_src, theta_rel, theta_dst_rows, slope):
    """K1's flush: θ of the retained slots re-read from θ_u* (+ rel), plus
    θ_*v, LeakyReLU, masked softmax (eps 1e-30) -> alpha (rows, k, H) and
    ids (rows, k) int32 with -1 on empty slots."""
    th = theta_src[rd_id.clamp(min=0)]  # (rows, k, H)
    if theta_rel is not None:
        th = th + theta_rel[rd_ety]
    th = th + theta_dst_rows[:, None, :]
    th = torch.where(th >= 0, th, slope * th)
    okh = ok[..., None]
    th = torch.where(okh, th, torch.full_like(th, NEG))
    mx = th.amax(dim=1, keepdim=True)
    ex = torch.where(okh, torch.exp(th - mx), torch.zeros_like(th))
    alpha = ex / (ex.sum(dim=1, keepdim=True) + 1e-30)
    ids = torch.where(ok, rd_id, torch.full_like(rd_id, -1)).to(torch.int32)
    return alpha, ids


def aggregate_plain(
    alpha: torch.Tensor,  # (rows, k_s, H) f32
    ids: torch.Tensor,  # (rows, k_s) int32, -1 = empty
    h_proj: torch.Tensor,  # (N, H, dh) f32
    blk: torch.Tensor,  # (4, n_blocks) int32; row 3 is k_eff
) -> torch.Tensor:
    """K2: out[r] = Σ_{s < k_eff(r)} alpha[r, s, :, None] · h'[id(r, s)],
    in slot order -> (rows, H, dh) f32. Empty slots read id 0 with α = 0."""
    rows, k_s, h = alpha.shape
    t_tile = rows // blk.shape[1]
    k_row = blk[3].long().repeat_interleave(t_tile)
    safe = ids.long().clamp(min=0)
    out = torch.zeros((rows, h, h_proj.shape[2]), dtype=torch.float32, device=alpha.device)
    for s in range(k_s):
        step = out + alpha[:, s, :, None] * h_proj[safe[:, s]]
        out = torch.where((s < k_row)[:, None, None], step, out)
    return out


def flat_prune_plain(
    nbr: torch.Tensor,  # (T, D) int32 global source ids
    msk: torch.Tensor,  # (T, D) bool
    ety: Optional[torch.Tensor],  # (T, D) int32, with theta_rel
    theta_src: torch.Tensor,  # (N, H) f32
    theta_rel: Optional[torch.Tensor],  # (R, H) f32
    theta_dst: torch.Tensor,  # (T, H) f32
    k: int,
    slope: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat K1: each row's D slots in slot order through a k-slot domain
    (first-minimum eviction, strict ``>``), then the flush -> alpha (T, k,
    H) f32 and ids (T, k) int32, -1 = empty."""
    t, d = nbr.shape
    dev = theta_src.device
    rd_rank = torch.full((t, k), NEG, dtype=torch.float32, device=dev)
    rd_id = torch.full((t, k), -1, dtype=torch.long, device=dev)
    rd_ety = torch.zeros((t, k), dtype=torch.long, device=dev)
    for j in range(d):
        c_nbr = nbr[:, j].long()
        c_ety = ety[:, j].long() if ety is not None else torch.zeros_like(c_nbr)
        th = theta_src[c_nbr]  # (T, H)
        if theta_rel is not None:
            th = th + theta_rel[c_ety]
        rank = torch.where(msk[:, j], _head_sum(th), torch.full_like(th[:, 0], NEG))
        rd_rank, (rd_id, rd_ety) = min_replace(
            rd_rank, [(rd_id, c_nbr), (rd_ety, c_ety)], rank
        )
    return _flush(rd_rank > NEG / 2, rd_id, rd_ety, theta_src, theta_rel, theta_dst, slope)


def flat_aggregate_plain(
    alpha: torch.Tensor,  # (T, k, H) f32
    ids: torch.Tensor,  # (T, k) int32, -1 = empty
    h_proj: torch.Tensor,  # (N, H, dh) f32
) -> torch.Tensor:
    """Flat K2: out[t] = Σ_s alpha[t, s, :, None] · h'[id(t, s)] in slot
    order -> (T, H, dh) f32. Empty slots read id 0 with α = 0."""
    t, k, h = alpha.shape
    safe = ids.long().clamp(min=0)
    out = torch.zeros((t, h, h_proj.shape[2]), dtype=torch.float32, device=alpha.device)
    for s in range(k):
        out = out + alpha[:, s, :, None] * h_proj[safe[:, s]]
    return out


def prune_aggregate_plain(
    nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, blk, k_s: int,
    h_proj: torch.Tensor, slope: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused grouped launch: :func:`prune_plain`, then
    :func:`aggregate_plain` on its alpha and ids -> (out (rows, H, dh),
    alpha, ids)."""
    alpha, ids = prune_plain(
        nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, blk, k_s, slope
    )
    return aggregate_plain(alpha, ids, h_proj, blk), alpha, ids


def flat_prune_aggregate_plain(
    nbr, msk, ety, theta_src, theta_rel, theta_dst, h_proj: torch.Tensor, k: int,
    slope: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused flat launch: :func:`flat_prune_plain`, then
    :func:`flat_aggregate_plain` -> (out (T, H, dh), alpha, ids)."""
    alpha, ids = flat_prune_plain(nbr, msk, ety, theta_src, theta_rel, theta_dst, k, slope)
    return flat_aggregate_plain(alpha, ids, h_proj), alpha, ids
