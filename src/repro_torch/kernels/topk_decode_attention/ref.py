"""Plain PyTorch versions of the CUDA kernels in ``csrc/``.

They compute what the kernels compute, step for step where it decides the
result:

  * :func:`score_logits_plain` forms the logits ``scale · q·k`` in the
    kernel's summation order: lane ``l`` of a warp sums the products of
    dims ``l, l+32, l+64, …`` left to right, the 32 lane sums are combined
    by a butterfly (xor 16, 8, 4, 2, 1), and the sum is scaled last. Every
    product and sum is one float32 rounding (the kernel uses ``__fmul_rn``
    and ``__fadd_rn``, so nothing is contracted into an FMA), which makes
    kernel and plain logits bit-identical — and so the retained ids.
  * :func:`score_prune_plain` (K1) runs the retention domain of the TPU
    kernel over those logits: positions in stream order, the FIRST minimum
    slot evicted, a candidate inserted only when STRICTLY greater
    (``kernels/common.py`` ``min_replace``), vectorised over (batch,
    q-head). On an empty domain (every slot ``NEG``) that rule puts the
    first ``K`` positions whose logit is above ``NEG`` into slots
    ``0..K-1`` in order (a logit at or below ``NEG``, a NaN and a position
    past the row's length never enter), so they are placed at once and the
    loop runs over the rest. The flush: slots at or below ``NEG/2`` are
    empty (α 0, id −1), softmax over the rest with eps 1e-30.

    Its output is in the **canonical layout**: the retained positions in
    ascending order, their α alongside, the empty slots (id −1, α 0) at
    the end. The TPU kernel's slot order is internal to it: it returns only
    the attention output (``kernel.py:164``), which depends on the retained
    set and its softmax alone. Where the length is at most ``K`` and no
    logit is dropped, this is the domain's own order.
  * :func:`tie_rows_plain` says which (batch, q-head) rows the CUDA K1
    sends down its tie path, where the domain's chain decides the set:
    every row but those whose ``min(K, length)``-th largest valid logit
    ``t`` has exactly ``min(K, length)`` valid logits at or above it, with
    no valid logit NaN or at or below ``NEG/2``. On the other rows the
    chain keeps exactly {p : logit_p ≥ t}, which the kernel finds by a
    radix select instead.
  * :func:`value_gather_plain` (K2) sums ``α · V[id, h // group]`` over the
    slots in float32; an empty slot adds nothing.

The wrapper in ``ops.py`` uses these for CPU tensors; ``chip_smoke.py``
holds the kernels against them on the card. They take tensors of any
device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.common import NEG, min_replace

LANES = 32


def score_logits_plain(q: torch.Tensor, k_cache: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B, H, dh), k_cache (B, S, Hkv, dh) -> logits (B, H, S) float32,
    q-head h against kv-head h // (H / Hkv), in the kernel's order."""
    b, h, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = h // hkv
    qg = q.float().reshape(b, hkv, group, 1, dh)
    kt = k_cache.float().permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, S, dh)
    pad = (-dh) % LANES
    prod = qg * kt  # (B, Hkv, g, S, dh), one rounding each
    if pad:
        prod = torch.nn.functional.pad(prod, (0, pad))
    prod = prod.reshape(b, hkv, group, s, -1, LANES)
    lane = torch.zeros(prod.shape[:-2] + (LANES,), dtype=torch.float32, device=q.device)
    for i in range(prod.shape[-2]):
        lane = lane + prod[..., i, :]
    idx = torch.arange(LANES, device=q.device)
    for off in (16, 8, 4, 2, 1):
        lane = lane + lane[..., idx ^ off]
    dot = lane[..., 0].reshape(b, h, s)
    return dot * torch.tensor(scale, dtype=torch.float32)  # float32 scale, a CPU scalar


def score_prune_plain(
    q: torch.Tensor,  # (B, H, dh) float32 or bfloat16
    k_cache: torch.Tensor,  # (B, S, Hkv, dh), q's dtype
    lengths: torch.Tensor,  # (B,) int32 valid prefix lengths
    k: int,  # retention slots, at most S
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 -> alpha (B, H, k) float32 and retained positions (B, H, k)
    int32, −1 = empty, in the canonical layout."""
    return prune_logits_plain(score_logits_plain(q, k_cache, scale), lengths, k)


def prune_logits_plain(
    logits: torch.Tensor,  # (B, H, S) float32
    lengths: torch.Tensor,  # (B,) valid prefix lengths
    k: int,  # retention slots, at most S
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 after the logits: the retention domain, its flush and the
    canonical layout -> alpha (B, H, k) float32 and positions (B, H, k)
    int32, −1 = empty."""
    b, h, s = logits.shape
    dev = logits.device
    n = lengths.long().clamp(0, s)
    valid = torch.arange(s, device=dev)[None, :] < n[:, None]  # (B, S)
    logits = torch.where(valid[:, None, :], logits, NEG).reshape(b * h, s)
    # the fill: the first k positions whose logit is > NEG take slots 0..k-1
    eligible = logits > NEG  # False past the length, at or below NEG, and for NaN
    rank = torch.cumsum(eligible, dim=-1) - 1
    fill = eligible & (rank < k)
    rows, cols = torch.nonzero(fill, as_tuple=True)
    slot = rank[rows, cols]
    rd_s = torch.full((b * h, k), NEG, dtype=torch.float32, device=dev)
    rd_i = torch.full((b * h, k), -1, dtype=torch.int32, device=dev)
    rd_s[rows, slot] = logits[rows, cols]
    rd_i[rows, slot] = cols.int()
    # the chain: every later position (the k-th eligible one is at p >= k-1)
    cand = torch.where(fill, NEG, logits)
    for p in range(k, int(n.max()) if b else 0):
        cur_id = torch.full((b * h,), p, dtype=torch.int32, device=dev)
        rd_s, (rd_i,) = min_replace(rd_s, [(rd_i, cur_id)], cand[:, p])
    ok = rd_s > NEG / 2
    lg = torch.where(ok, rd_s, NEG)
    mx = lg.amax(dim=-1, keepdim=True)
    ex = torch.where(ok, torch.exp(lg - mx), 0.0)
    alpha = ex / (ex.sum(dim=-1, keepdim=True) + 1e-30)
    # the canonical layout: retained positions ascending, empty slots last
    key = torch.where(ok, rd_i.long(), s)
    key, order = torch.sort(key, dim=-1)
    alpha = torch.gather(alpha, 1, order)
    ids = torch.where(key < s, key, -1)
    return alpha.reshape(b, h, k), ids.reshape(b, h, k).int()


def tie_rows_plain(logits: torch.Tensor, lengths: torch.Tensor, k: int) -> torch.Tensor:
    """logits (B, H, S) float32, lengths (B,) -> (B, H) int32: 1 where K1
    takes its tie path (see the module docstring), else 0."""
    b, h, s = logits.shape
    n = lengths.long().clamp(0, s)
    valid = (torch.arange(s, device=logits.device)[None, :] < n[:, None])[:, None, :]
    kk = torch.minimum(n, torch.tensor(k, device=logits.device))[:, None].expand(b, h)
    bad = (valid & ~(logits > NEG / 2)).any(dim=-1)  # NaN or at or below NEG/2
    desc = torch.sort(torch.where(valid, logits, float("-inf")), dim=-1, descending=True).values
    t = torch.gather(desc, 2, (kk - 1).clamp(min=0)[..., None])
    at_or_above = (valid & (logits >= t)).sum(dim=-1)
    return ((kk == 0) | bad | (at_or_above != kk)).int()


def value_gather_plain(
    alpha: torch.Tensor,  # (B, H, k) float32
    ids: torch.Tensor,  # (B, H, k) int32, −1 = empty
    v_cache: torch.Tensor,  # (B, S, Hkv, dh)
) -> torch.Tensor:
    """K2 -> (B, H, dh) float32: Σ_slots α · V[b, id, h // group]."""
    b, h, k = alpha.shape
    hkv, dh = v_cache.shape[2], v_cache.shape[3]
    group = h // hkv
    kvh = torch.arange(h, device=alpha.device) // group
    idx = ids.long().clamp(min=0)
    rows = v_cache[torch.arange(b, device=alpha.device)[:, None, None], idx, kvh[None, :, None]]
    a = torch.where(ids >= 0, alpha, 0.0)
    return (a[..., None] * rows.float()).sum(dim=2)


def topk_decode_attention_plain(
    q, k_cache, v_cache, lengths, prune_k: int, scale: Optional[float] = None
) -> torch.Tensor:
    """K1 then K2 with k = min(prune_k, S) -> (B, H, dh) float32."""
    dh, s = q.shape[-1], k_cache.shape[1]
    scale = dh ** -0.5 if scale is None else scale
    alpha, ids = score_prune_plain(q, k_cache, lengths, min(int(prune_k), s), scale)
    return value_gather_plain(alpha, ids, v_cache)


def full_decode_attention(q, k_cache, v_cache, lengths, scale: Optional[float] = None):
    """Unpruned decode attention (what pruning is measured against), float32."""
    b, h, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = h // hkv
    scale = dh ** -0.5 if scale is None else scale
    kx = k_cache.float().repeat_interleave(group, dim=2)
    vx = v_cache.float().repeat_interleave(group, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", q.float(), kx) * scale
    pos = torch.arange(s, device=q.device)
    logits = torch.where(pos[None, None, :] < lengths.long()[:, None, None], logits, NEG)
    return torch.einsum("bhs,bshd->bhd", torch.softmax(logits, dim=-1), vx)
