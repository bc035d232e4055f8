"""Feed-forward block: SwiGLU and GeGLU (the reference's
``repro/layers/mlp.py``; its plain-GELU form comes with the arch that uses
it, ROADMAP §1 LM-6).

``jax.nn.gelu`` defaults to the tanh approximation, which the reference
uses; so does this port (``approximate="tanh"``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

_GATES = {"swiglu": F.silu, "geglu": lambda g: F.gelu(g, approximate="tanh")}


def mlp_shapes(cfg, d_ff: int | None = None):
    """Parameter shapes, ``(in, out)`` layout as the reference's."""
    if cfg.activation not in _GATES:
        raise NotImplementedError(
            f"activation {cfg.activation!r} is not ported to repro_torch yet: ROADMAP §1 LM-6"
        )
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"wi": (d, f), "wg": (d, f), "wo": (f, d)}


def apply_mlp(cfg, params, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.adtype
    h = x.to(dt) @ params["wi"].to(dt)
    g = x.to(dt) @ params["wg"].to(dt)
    h = _GATES[cfg.activation](g) * h
    return (h @ params["wo"].to(dt)).to(x.dtype)
