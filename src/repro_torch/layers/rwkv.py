"""RWKV-6 (Finch): time-mix with data-dependent decay + channel-mix (the
reference's ``repro/layers/rwkv.py``).

The prefill runs the chunked-parallel linear-attention form: within a
chunk the decays are factored through the in-chunk cumulative log-decay;
across chunks a (hs × hs) state per head is carried by a Python loop over
the chunks (the reference's ``lax.scan``), all in float32. Log-decays are
clamped to ≥ ``_LOGW_MIN`` so that the factored exponentials stay inside
float32's range at chunk 32 (they reach e^±86; TF32 stays off, see
``repro_torch/__init__.py``). Decode is the O(1) recurrence.

Dtypes follow the reference's two paths: the prefill normalises the
float32 attention output and multiplies it by the ``cfg.dtype`` output
weight in float32 (``core.dtypes.matmul``); decode casts it to
``cfg.dtype`` before the norm. ``u``, ``decay_a`` and ``decay_b`` are read
in float32 at every use (``models.lm.storage_dtype`` keeps them so).

Attention-free: the paper's pruning has no per-source coefficients here
and is not applied.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.dtypes import matmul
from repro_torch.core.projection import glorot_
from repro_torch.layers.norms import groupnorm_heads, groupnorm_shapes

_LOGW_MIN = -2.7  # chunk 32: |cum| <= 86 < f32 exp range
_DECAY_RANK = 64
_MUS = ("r", "k", "v", "g", "w", "k2", "r2")


class RWKVState(NamedTuple):
    s: torch.Tensor  # (B, H, hs, hs) float32 linear-attention state
    shift_t: torch.Tensor  # (B, d) last token (time-mix), cfg.dtype
    shift_c: torch.Tensor  # (B, d) last token (channel-mix), cfg.dtype


def rwkv_shapes(cfg):
    """Parameter shapes, the reference's ``init_rwkv`` tree (``ln_x``
    nested)."""
    d, dff, hs = cfg.d_model, cfg.d_ff, cfg.rwkv_head_size
    return {
        **{f"mu_{n}": (d,) for n in _MUS},
        "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d), "wo": (d, d), "w0": (d,),
        "decay_a": (d, _DECAY_RANK), "decay_b": (_DECAY_RANK, d), "u": (d // hs, hs),
        "ln_x": groupnorm_shapes(cfg), "wk2": (d, dff), "wv2": (dff, d), "wr2": (d, d),
    }


def init_rules(cfg):
    """The reference's init of the leaves that are neither glorot matrices
    nor zero vectors: name -> fill of a float32 tensor from a generator."""
    small = lambda t, g: glorot_(t, g).mul_(0.1)  # noqa: E731
    return {
        **{f"mu_{n}": lambda t, g: t.fill_(0.5) for n in _MUS},
        "w0": lambda t, g: t.fill_(-2.0),  # base log-log decay
        "decay_a": small, "decay_b": small,
        "ln_x.scale": lambda t, g: t.fill_(1.0),
    }


def _heads(x: torch.Tensor, hs: int) -> torch.Tensor:
    return x.unflatten(-1, (-1, hs))


def _rkvgw(cfg, params, x, x_prev):
    """Token-shift lerps + projections. x, x_prev (B, T, d)."""
    dt, hs = cfg.adtype, cfg.rwkv_head_size
    mix = lambda mu: (x + (x_prev - x) * params[mu]).to(dt)  # noqa: E731
    r = _heads(mix("mu_r") @ params["wr"].to(dt), hs)
    k = _heads(mix("mu_k") @ params["wk"].to(dt), hs)
    v = _heads(mix("mu_v") @ params["wv"].to(dt), hs)
    g = mix("mu_g") @ params["wg"].to(dt)
    xw = mix("mu_w").float()
    dlora = torch.tanh(xw @ params["decay_a"].float()) @ params["decay_b"].float()
    log_w = -torch.exp(params["w0"].float() + dlora)  # (B, T, d) <= 0
    log_w = torch.clamp(log_w, min=_LOGW_MIN)
    return r, k, v, g, _heads(log_w, hs)


def _chunked_gla(r, k, v, log_w, u, chunk: int):
    """Chunked gated linear attention. r, k, v, log_w: (B, S, H, hs)
    float32; u (H, hs). Returns (out (B, S, H, hs), final state (B, H, hs,
    hs)). Zero rows pad S to whole chunks: a zero log-decay and a zero key
    leave the state as it was."""
    b, s, h, hs = r.shape
    pad = (-s) % chunk
    if pad:
        r, k, v, log_w = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, log_w))
    nc = r.shape[1] // chunk
    sh = (b, nc, chunk, h, hs)
    rc, kc, vc = r.reshape(sh), k.reshape(sh), v.reshape(sh)
    lw = log_w.float().reshape(sh)
    clw = torch.cumsum(lw, dim=2)  # inclusive in-chunk cumulative log decay
    ex_clw = clw - lw  # exclusive
    rr = rc * torch.exp(ex_clw)
    kk = kc * torch.exp(-clw)
    kk_end = kc * torch.exp(clw[:, :, -1:] - clw)
    # intra-chunk: strictly-lower-triangular attention
    att = torch.einsum("bnchd,bnshd->bnhcs", rr, kk)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), diagonal=-1)
    att = torch.where(tri, att, 0.0)
    intra = torch.einsum("bnhcs,bnshd->bnchd", att, vc)
    bonus = (rc * u * kc).sum(-1, keepdim=True) * vc
    # inter-chunk state, carried chunk by chunk
    decay_end = torch.exp(clw[:, :, -1])  # (B, nc, H, hs)
    state = torch.zeros((b, h, hs, hs), dtype=torch.float32, device=r.device)
    inter = []
    for n in range(nc):
        inter.append(torch.einsum("bchd,bhde->bche", rr[:, n], state))
        state = decay_end[:, n, ..., None] * state + torch.einsum("bchd,bche->bhde", kk_end[:, n], vc[:, n])
    out = intra + bonus + torch.stack(inter, dim=1)
    return out.reshape(b, nc * chunk, h, hs)[:, :s], state


def _shifted(x: torch.Tensor) -> torch.Tensor:
    """The previous token of each position, zero before the first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def time_mix_train(cfg, params, x: torch.Tensor, emit_state: bool = False):
    """x (B, S, d) -> (B, S, d) [, the final state (B, H, hs, hs)]."""
    r, k, v, g, log_w = _rkvgw(cfg, params, x, _shifted(x))
    o, s_final = _chunked_gla(r.float(), k.float(), v.float(), log_w, params["u"].float(), cfg.rwkv_chunk)
    o = groupnorm_heads(params["ln_x"], o) * F.silu(g)  # float32
    out = matmul(o, params["wo"].to(cfg.adtype)).to(x.dtype)
    return (out, s_final) if emit_state else out


def _channel_mix(cfg, params, x, x_prev):
    dt = cfg.adtype
    mix = lambda mu: (x + (x_prev - x) * params[mu]).to(dt)  # noqa: E731
    kk = torch.square(torch.relu(mix("mu_k2") @ params["wk2"].to(dt)))
    rr = torch.sigmoid(mix("mu_r2") @ params["wr2"].to(dt))
    return (rr * (kk @ params["wv2"].to(dt))).to(x.dtype)


def channel_mix_train(cfg, params, x: torch.Tensor) -> torch.Tensor:
    return _channel_mix(cfg, params, x, _shifted(x))


def init_rwkv_state(cfg, batch: int, device) -> RWKVState:
    d, hs = cfg.d_model, cfg.rwkv_head_size
    return RWKVState(
        s=torch.zeros((batch, d // hs, hs, hs), dtype=torch.float32, device=device),
        shift_t=torch.zeros((batch, d), dtype=cfg.adtype, device=device),
        shift_c=torch.zeros((batch, d), dtype=cfg.adtype, device=device),
    )


def time_mix_decode(cfg, params, x: torch.Tensor, state: RWKVState):
    """x (B, 1, d), one step -> (out (B, 1, d), next state (B, H, hs, hs),
    next shift_t (B, d)); ``state`` is only read."""
    x_prev = state.shift_t[:, None, :].to(x.dtype)
    r, k, v, g, log_w = _rkvgw(cfg, params, x, x_prev)
    r, k, v = (t[:, 0].float() for t in (r, k, v))  # (B, H, hs)
    w = torch.exp(log_w[:, 0].float())
    u = params["u"].float()
    kv = k[..., :, None] * v[..., None, :]  # (B, H, hs, hs)
    o = (r[..., None, :] @ (state.s + u[None, :, :, None] * kv))[..., 0, :]  # (B, H, hs)
    s_new = w[..., None] * state.s + kv
    o = groupnorm_heads(params["ln_x"], o[:, None].to(cfg.adtype))
    o = o * F.silu(g)
    out = (o @ params["wo"].to(cfg.adtype)).to(x.dtype)
    return out, s_new, x[:, 0]


def channel_mix_decode(cfg, params, x: torch.Tensor, state: RWKVState):
    """x (B, 1, d) -> (out (B, 1, d), next shift_c (B, d))."""
    return _channel_mix(cfg, params, x, state.shift_c[:, None, :].to(x.dtype)), x[:, 0]
