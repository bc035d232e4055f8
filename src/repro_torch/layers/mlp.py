"""Feed-forward block: SwiGLU, GeGLU and the plain-GELU MLP (the
reference's ``repro/layers/mlp.py``).

``jax.nn.gelu`` defaults to the tanh approximation, which the reference
uses; so does this port (``approximate="tanh"``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

_GELU = lambda t: F.gelu(t, approximate="tanh")  # noqa: E731
_GATES = {"swiglu": F.silu, "geglu": _GELU}
ACTIVATIONS = (*_GATES, "gelu_mlp")


def mlp_shapes(cfg, d_ff: int | None = None):
    """Parameter shapes, ``(in, out)`` layout as the reference's: ``wi``,
    ``wo`` and, for the gated activations, ``wg``."""
    if cfg.activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {cfg.activation!r}; known: {ACTIVATIONS}")
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.activation == "gelu_mlp":
        return {"wi": (d, f), "wo": (f, d)}
    return {"wi": (d, f), "wg": (d, f), "wo": (f, d)}


def apply_mlp(cfg, params, x: torch.Tensor) -> torch.Tensor:
    """``act(x @ wg) * (x @ wi)`` for the gated activations, ``gelu(x @ wi)``
    for ``gelu_mlp``; then ``@ wo``, in ``cfg.dtype``."""
    dt = cfg.adtype
    h = x.to(dt) @ params["wi"].to(dt)
    if cfg.activation == "gelu_mlp":
        h = _GELU(h)
    else:
        g = x.to(dt) @ params["wg"].to(dt)
        h = _GATES[cfg.activation](g) * h
    return (h @ params["wo"].to(dt)).to(x.dtype)
