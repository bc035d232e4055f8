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
    q-head). The first ``K`` positions fill slots ``0..K-1`` in order,
    which is what that rule does on an empty domain (an empty slot holds
    ``NEG``, below every logit, and positions past a row's length are never
    inserted), so they are placed at once and the loop starts at ``K``.
    The flush: slots at or below ``NEG/2`` are empty (α 0, id −1), softmax
    over the rest with eps 1e-30.
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
    int32, −1 = empty."""
    b, h, _ = q.shape
    s = k_cache.shape[1]
    dev = q.device
    pos = torch.arange(s, device=dev)
    valid = pos[None, :] < lengths.long()[:, None]  # (B, S)
    logits = score_logits_plain(q, k_cache, scale)
    logits = torch.where(valid[:, None, :], logits, NEG).reshape(b * h, s)
    valid = valid[:, None, :].expand(b, h, s).reshape(b * h, s)
    rd_s = torch.where(valid[:, :k], logits[:, :k], NEG)
    rd_i = torch.where(valid[:, :k], pos[None, :k].int(), -1).int()
    for p in range(k, int(lengths.max()) if b else 0):
        cur_id = torch.full((b * h,), p, dtype=torch.int32, device=dev)
        rd_s, (rd_i,) = min_replace(rd_s, [(rd_i, cur_id)], logits[:, p])
    ok = rd_s > NEG / 2
    lg = torch.where(ok, rd_s, NEG)
    mx = lg.amax(dim=-1, keepdim=True)
    ex = torch.where(ok, torch.exp(lg - mx), 0.0)
    alpha = ex / (ex.sum(dim=-1, keepdim=True) + 1e-30)
    ids = torch.where(ok, rd_i, -1)
    return alpha.reshape(b, h, k), ids.reshape(b, h, k).int()


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
