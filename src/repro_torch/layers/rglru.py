"""Griffin recurrent block: temporal conv + RG-LRU (recurrentgemma; the
reference's ``repro/layers/rglru.py``).

The prefill runs the causal depthwise conv, then the diagonal recurrence
h_t = a_t·h_{t-1} + b_t over the prompt in float32; decode is one step
carrying the (h, conv window) state. The paper's pruning has no
aggregation set here and is not applied.

The prefill scan. The reference runs ``jax.lax.associative_scan``; the port
runs a Hillis–Steele doubling in plain PyTorch (:func:`linear_scan`):
ceil(log2 S) passes over the (B, S, W) gates, 12 at S = 3072, in place of
a Python loop of S steps. Every pass combines (a, b) pairs with the
reference's operator, ``(a_l·a_r, b_l·a_r + b_r)``, but the two scans
group the products in other trees, so a state rounds differently in
float32. On the CPU tests' smoke block (``tests/test_torch_lm_recurrent.py``,
held within 2e-5) the outputs differ from the reference's by at most
4.1e-8 at prompts of 5 and 21 tokens, 6.0e-8 at 77 and 1.8e-7 at 300
(1 to 3 float32 ulps of the largest output), the final h by at most
1.8e-7.

Short prompts. The reference keeps ``u[:, s - cw + 1:]`` as the conv state
(``src/repro/layers/rglru.py:78``), which holds fewer than ``cw - 1`` rows
for a prompt shorter than that, and its next decode step raises. The port
keeps the last ``cw - 1`` rows of the causal zero pad the conv itself
reads, so ``prefill(s)`` plus a step equals ``prefill(s + 1)`` at every
``s``; for ``s >= cw - 1`` the state is the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.projection import glorot_

_C = 8.0  # RG-LRU decay sharpness constant (Griffin)


class LRUState(NamedTuple):
    h: torch.Tensor  # (B, W) float32
    conv: torch.Tensor  # (B, conv_width - 1, W) in cfg.dtype


def _width(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def lru_shapes(cfg):
    """Parameter shapes, the reference's ``init_recurrent`` tree."""
    d, w = cfg.d_model, _width(cfg)
    return {
        "wx": (d, w), "wgate": (d, w), "conv_w": (cfg.conv_width, w), "conv_b": (w,),
        "wa": (w, w), "ba": (w,), "wi": (w, w), "bi": (w,), "lam": (w,), "w_out": (w, d),
    }


def init_rules(cfg):
    """The reference's init of the leaves that are neither glorot matrices
    nor zero vectors: name -> fill of a float32 tensor from a generator."""
    w = _width(cfg)
    lam = torch.log(torch.expm1(torch.linspace(0.9, 0.999, w)) + 1e-8)
    return {
        "conv_w": lambda t, g: glorot_(t, g).mul_(0.1),
        "ba": lambda t, g: t.fill_(4.0),  # sigmoid(4) ≈ 0.98: slow-decay init
        "lam": lambda t, g: t.copy_(lam),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _gates(params, c: torch.Tensor, dt):
    """(a, b) of the recurrence, both float32, from the conv output ``c``."""
    r = torch.sigmoid(c @ params["wa"].to(dt) + params["ba"].to(dt))
    i = torch.sigmoid(c @ params["wi"].to(dt) + params["bi"].to(dt))
    log_a = (-_C * F.softplus(params["lam"].float())) * r.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * c).float()


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t along dim 1 from h_{-1} = 0, by doubling:
    after the pass at offset d every row holds the composition of the d·2
    rows ending at it. Overwrites ``a`` and ``b`` and returns ``b`` when
    autograd does not record; when it does (training), each pass makes new
    tensors of the same values instead, since the backward reads every
    pass's inputs."""
    s, d = a.shape[1], 1
    record = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    while d < s:
        if record:
            b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], dim=1)
            if 2 * d < s:
                a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        else:
            b[:, d:] = torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])
            if 2 * d < s:
                a[:, d:] = a[:, d:] * a[:, :-d]
        d *= 2
    return b


def apply_recurrent_train(cfg, params, x: torch.Tensor, emit_state: bool = False):
    """x (B, S, d) -> (B, S, d) [, final ``LRUState``]."""
    dt = cfg.adtype
    s, cw = x.shape[1], cfg.conv_width
    u = x.to(dt) @ params["wx"].to(dt)  # (B, S, W)
    g = _gelu(x.to(dt) @ params["wgate"].to(dt))
    pads = F.pad(u, (0, 0, cw - 1, 0))  # causal depthwise conv, width cw
    c = sum(pads[:, i:i + s] * params["conv_w"][i].to(dt) for i in range(cw)) + params["conv_b"].to(dt)
    a, bterm = _gates(params, c, dt)
    h = linear_scan(a, bterm)
    out = ((h.to(dt) * g) @ params["w_out"].to(dt)).to(x.dtype)
    if emit_state:
        # the last cw - 1 rows of the zero-padded conv input (see the module docstring)
        return out, LRUState(h=h[:, -1].float(), conv=pads[:, s:])
    return out


def init_lru_state(cfg, batch: int, device) -> LRUState:
    w = _width(cfg)
    return LRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, w), dtype=cfg.adtype, device=device),
    )


def apply_recurrent_decode(cfg, params, x: torch.Tensor, state: LRUState):
    """x (B, 1, d), one step -> (out (B, 1, d), the next ``LRUState``, new
    tensors: ``state`` is only read)."""
    dt = cfg.adtype
    u = x[:, 0].to(dt) @ params["wx"].to(dt)  # (B, W)
    g = _gelu(x[:, 0].to(dt) @ params["wgate"].to(dt))
    hist = torch.cat([state.conv, u[:, None, :]], dim=1)  # (B, cw, W)
    c = (hist.to(dt) * params["conv_w"].to(dt)).sum(1) + params["conv_b"].to(dt)
    a, bterm = _gates(params, c, dt)
    h = a * state.h + bterm
    out = (h.to(dt) * g) @ params["w_out"].to(dt)
    return out[:, None, :].to(x.dtype), LRUState(h=h, conv=hist[:, 1:])
