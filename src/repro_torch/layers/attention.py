"""GQA attention: the chunked flash forward for prefill, and the cached
decode step with ADE top-K KV pruning on global layers (the paper's
technique on LM serving), with ring-buffer caches for sliding-window
layers; and cross-attention over a static context (image embeddings or
encoded audio frames), gated by ``tanh(gate)``, whose decode prunes the
context through the same top-K decode attention kernel. The reference is
``repro/layers/attention.py``.

Decode updates the cache in place: the new K/V row is written into the
cache tensors and the same ``KVCache`` is returned (the reference returns
new arrays; a copy of every cache per token would move the whole cache
each step). A cross-attention's cache is the context's K and V, written
once at prefill and only read at decode. The sharded retention domain
(``_hier_topk``) is not ported yet (ROADMAP §1 LM-8).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.topk_decode_attention.ops import topk_decode_attention
from repro_torch.layers.flash import flash_attention
from repro_torch.layers.rope import apply_rope, rope_angles

NEG = -2.3e38


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, C, Hkv, hd) — C = max len (global) or window (local)
    v: torch.Tensor


def attention_shapes(cfg, cross: bool = False):
    """Parameter shapes, ``(in, out)`` layout as the reference's; with
    ``cfg.qkv_bias`` also the biases ``bq``, ``bk``, ``bv`` (zero at init);
    a cross-attention also has the 0-dim ``gate`` (zero at init, as the
    reference's: ``tanh(0)`` silences the branch until trained)."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    shapes = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd), "wo": (h * hd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(h * hd,), bk=(hkv * hd,), bv=(hkv * hd,))
    if cross:
        shapes["gate"] = ()
    return shapes


def _bias(params, name: str, t: torch.Tensor, dt) -> torch.Tensor:
    # each bias cast to the compute dtype first, as the reference does: a
    # float32 bias added to a bfloat16 product would promote it to float32
    return t + params[name].to(dt) if name in params else t


def _project_qkv(cfg, params, x, kv_x=None):
    """q from ``x`` (B, S, d); K and V from ``kv_x`` (B, Skv, d): the
    context for a cross-attention, ``x`` itself (the default) for a
    self-attention."""
    kv_x = x if kv_x is None else kv_x
    dt = cfg.adtype
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _bias(params, "bq", x.to(dt) @ params["wq"].to(dt), dt)
    k = _bias(params, "bk", kv_x.to(dt) @ params["wk"].to(dt), dt)
    v = _bias(params, "bv", kv_x.to(dt) @ params["wv"].to(dt), dt)
    skv = kv_x.shape[1]
    return q.reshape(b, s, h, hd), k.reshape(b, skv, hkv, hd), v.reshape(b, skv, hkv, hd)


def _gated(params, out: torch.Tensor) -> torch.Tensor:
    """A cross-attention's output times ``tanh(gate)`` cast to the output's
    dtype (the reference's llama-vision gate); a self-attention's as it is."""
    if "gate" not in params:
        return out
    return out * torch.tanh(params["gate"]).to(out.dtype)


def _rope_base(cfg, kind: str) -> float:
    if kind == "L" and cfg.rope_local_base is not None:
        return cfg.rope_local_base
    return cfg.rope_base


def attention_train(cfg, params, x, positions, kind: str = "A", context: Optional[torch.Tensor] = None,
                    emit_cache: bool = False, causal: Optional[bool] = None):
    """Full-sequence attention (prefill): ``kind`` "A" is global, "L"
    sliding-window. With ``context`` (B, C, d) it is a cross-attention: K
    and V from the context, no RoPE, not causal, the output gated. An
    encoder's self-attention passes ``causal=False`` (RoPE kept). Returns
    (out, KVCache of the K/V attended to, or None)."""
    cross = context is not None
    if causal is None:
        causal = not cross
    q, k, v = _project_qkv(cfg, params, x, context)
    if not cross:
        rot = int(cfg.hd * cfg.rope_fraction)
        cos, sin = rope_angles(positions, rot, _rope_base(cfg, kind))
        q = apply_rope(q, cos, sin, cfg.rope_fraction)
        k = apply_rope(k, cos, sin, cfg.rope_fraction)
    window = cfg.sliding_window if kind == "L" else None
    o = flash_attention(cfg, q, k, v, causal=causal, window=window)
    out = _gated(params, o.reshape(x.shape[0], x.shape[1], -1) @ params["wo"].to(cfg.adtype))
    return out.to(x.dtype), (KVCache(k=k, v=v) if emit_cache else None)


def init_kv_cache(cfg, batch: int, max_len: int, kind: str, device) -> KVCache:
    hkv, hd = cfg.num_kv_heads, cfg.hd
    c = max_len
    if kind == "L" and cfg.sliding_window is not None:
        c = min(max_len, cfg.sliding_window)
    return KVCache(
        k=torch.zeros((batch, c, hkv, hd), dtype=cfg.adtype, device=device),
        v=torch.zeros((batch, c, hkv, hd), dtype=cfg.adtype, device=device),
    )


def position_tensor(pos, device) -> torch.Tensor:
    """A decode position as the 0-dim int64 tensor on ``device`` that
    ``attention_decode`` takes: an ``int`` is filled in on the device (no
    host-to-device copy), a tensor is returned as it is."""
    if isinstance(pos, torch.Tensor):
        return pos
    return torch.full((), int(pos), dtype=torch.int64, device=device)


def attention_decode(cfg, params, x, pos, cache: KVCache, kind: str = "A"):
    """Single-token decode with an in-place cache update.

    ``pos`` is an ``int`` or a 0-dim int64 tensor on ``x``'s device (what a
    captured decode step replays with); both give the same bits.

    Global layers ('A') with ``cfg.attn_prune_k`` below the cache width run
    ADE top-K retention per query head over the q·k logits before softmax·V
    — the paper's attention-disparity pruning with the KV cache as neighbor
    set — through the top-K decode attention kernel pair (its plain version
    on the CPU). It keeps exactly K slots by the kernel's rule (first
    minimum evicted, strictly greater inserted) over float32 logits formed
    from the cache as stored; the reference's threshold form keeps every
    logit at or above the K-th of the ``cfg.dtype`` logits, so the two
    agree in float32 on logits without ties. Local layers ('L') use a
    ring-buffer cache of window width.
    """
    b = x.shape[0]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    pos = position_tensor(pos, x.device)
    q, k, v = _project_qkv(cfg, params, x)
    rot = int(cfg.hd * cfg.rope_fraction)
    cos, sin = rope_angles(pos.expand(b, 1), rot, _rope_base(cfg, kind))
    q = apply_rope(q, cos, sin, cfg.rope_fraction)
    k = apply_rope(k, cos, sin, cfg.rope_fraction)

    ck, cv = cache
    c = ck.shape[1]
    # ring for local; c >= max_len for global so pos % c = pos
    slot = torch.remainder(pos, c).reshape(1)
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))

    scale = hd ** -0.5
    g = h // hkv
    prune_k = cfg.attn_prune_k if kind == "A" else None
    if prune_k is not None and prune_k < c:
        # a global cache holds positions 0..pos in slots 0..pos
        lengths = torch.clamp(pos + 1, max=c).to(torch.int32).expand(b)
        o = topk_decode_attention(q.reshape(b, h, hd), ck, cv, lengths, prune_k, scale)
        o = o.to(cv.dtype)
    else:
        # absolute position held by each ring slot j: pos - ((pos - j) mod c)
        idx = torch.arange(c, device=x.device)
        abs_pos = pos - torch.remainder(pos - idx, c)
        valid = abs_pos >= 0
        if kind == "L" and cfg.sliding_window is not None:
            valid &= abs_pos > pos - cfg.sliding_window
        qg = q.reshape(b, hkv, g, hd)
        logits = torch.einsum("bkgd,bskd->bkgs", qg, ck).float() * scale
        logits = torch.where(valid[None, None, None, :], logits, NEG)
        alpha = torch.softmax(logits, dim=-1).to(cv.dtype)
        o = torch.einsum("bkgs,bskd->bkgd", alpha, cv)
    out = o.reshape(b, 1, h * hd) @ params["wo"].to(cfg.adtype)
    return out.to(x.dtype), cache


def cross_attention_decode(cfg, params, x, cache: KVCache):
    """Single-token cross-attention against a static context cache
    (B, C, Hkv, hd), which it only reads; ``x`` (B, 1, d) -> the gated
    output (B, 1, d).

    Only q is projected (with ``bq`` where there is one); the context's K
    and V were projected at prefill, biases included. With
    ``cfg.attn_prune_k`` below C, ADE keeps the top-K context rows per query
    head (image tokens or audio frames as the neighbour set) through the
    top-K decode attention kernel pair (its plain version on the CPU) with
    every row valid; else the dense softmax·V.

    Tie rule: the kernel keeps exactly K rows over float32 logits, evicting
    the first minimum and inserting only a strictly greater logit, so for
    logits [1, 1, 2] at K = 2 it keeps rows {1, 2}; the reference's
    ``jax.lax.top_k`` keeps the lower index, {0, 2}. The port follows the
    kernel, on the card and on the CPU; on float32 logits without ties the
    two keep the same rows."""
    b = x.shape[0]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = cfg.adtype
    ck, cv = cache
    c = ck.shape[1]
    q = _bias(params, "bq", x.to(dt) @ params["wq"].to(dt), dt)
    scale = hd ** -0.5
    prune_k = cfg.attn_prune_k
    if prune_k is not None and prune_k < c:
        lengths = torch.full((b,), c, dtype=torch.int32, device=x.device)
        o = topk_decode_attention(q.reshape(b, h, hd), ck, cv, lengths, prune_k, scale).to(dt)
    else:
        qg = q.reshape(b, hkv, h // hkv, hd)
        logits = torch.einsum("bkgd,bskd->bkgs", qg, ck).float() * scale
        alpha = torch.softmax(logits, dim=-1).to(dt)
        o = torch.einsum("bkgs,bskd->bkgd", alpha, cv)
    out = _gated(params, o.reshape(b, 1, h * hd) @ params["wo"].to(dt))
    return out.to(x.dtype)
