"""Rotary position embeddings with partial-rotary ("2d", chatglm3) and
per-layer-kind base (gemma3 local/global) support."""
from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, rot_dim: int, base: float):
    """positions (...,) -> (cos, sin) of shape (..., rot_dim//2), f32."""
    exps = -torch.arange(0, rot_dim, 2, dtype=torch.float32, device=positions.device) / rot_dim
    inv = torch.pow(base, exps)  # a Python base: no host-to-device copy
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, fraction: float = 1.0):
    """x (..., S, H, hd); cos/sin (..., S, rot/2) broadcast over heads.

    Half-split convention on the first ``fraction`` of head dims; the rest
    pass through (chatglm3's 2D RoPE rotates only half the dims).
    """
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, xp], dim=-1)
