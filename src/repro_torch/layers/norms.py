"""Normalization layers (computed in f32, cast back to activation dtype)."""
from __future__ import annotations

import torch


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm with a (1 + scale) parameter."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (y * (1.0 + params["scale"].float())).to(dt)


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.reciprocal(torch.sqrt(var + eps))
    return (y * params["scale"] + params["bias"]).to(dt)


def norm_shapes(cfg):
    """Parameter shapes of one norm: ``{"scale": (d,)}`` for RMSNorm (zeros
    at init), plus ``"bias"`` for LayerNorm (scale ones, bias zeros)."""
    d = cfg.d_model
    return {"scale": (d,)} if cfg.norm == "rmsnorm" else {"scale": (d,), "bias": (d,)}


def apply_norm(cfg, params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if cfg.norm == "rmsnorm" else layernorm(params, x)


def groupnorm_shapes(cfg):
    """RWKV's per-head output norm: ``{"scale", "bias": (d,)}`` (ones and
    zeros at init, whatever ``cfg.norm`` says)."""
    return {"scale": (cfg.d_model,), "bias": (cfg.d_model,)}


def groupnorm_heads(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-head LayerNorm for RWKV's time-mix output: x (..., H, hs) ->
    (..., H·hs), normalised per head in float32, then the flat scale and
    bias, cast back to ``x``'s dtype."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.reciprocal(torch.sqrt(var + eps))
    flat = y.flatten(-2)
    return (flat * params["scale"] + params["bias"]).to(dt)
