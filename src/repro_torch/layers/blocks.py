"""Layer blocks: parameter shapes, prefill-apply, cache init and
decode-apply, dispatched by kind (the reference's ``repro/layers/blocks.py``).

Kinds:
  A  global attention + MLP            L  sliding-window attention + MLP
  M  attention + MoE (opt. dense res)  C  gated cross-attention + MLP
  R  RG-LRU recurrent + MLP            W  RWKV-6 time-mix + channel-mix
  E  encoder (bidirectional) attn+MLP  D  decoder self+cross+MLP (enc-dec)

An "M" block's attention runs as kind "A" (a global cache; ADE pruning
when ``cfg.attn_prune_k`` is set), then the MoE on ``ln2(x)``, plus the
dense MLP on the same normed input when ``cfg.moe.dense_residual``
(arctic). "R" and "W" blocks carry a recurrent state (``LRUState``,
``RWKVState``) in place of a KV cache; a decode step writes the next state
into the cache's own tensors, as it writes a KV slot, so a captured step
reads and writes the same storage on every replay.

A "C" block (llama-vision) runs ``ln1``, the gated cross-attention over the
context, the residual, then the ``ln2`` MLP (ungated, as the reference's);
its cache is the context's K and V, written at prefill and only read at
decode. An "E" block (the audio encoder) is a bidirectional self-attention
with RoPE plus the MLP, and emits no cache. A "D" block (the audio
decoder) runs ``ln1`` and the self-attention of kind "A" (pruned when
``cfg.attn_prune_k`` is below its cache width), ``lnx`` and the gated
cross-attention over the encoded frames, then the ``ln2`` MLP; its cache is
a ``DecoderCache`` of a self ``KVCache`` and a static cross one. Both
context caches are ``ctx_len`` wide (``num_img_tokens`` or
``num_audio_frames``), not ``max_len``.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.layers import attention as attn
from repro_torch.layers import mlp as mlp_mod
from repro_torch.layers import moe as moe_mod
from repro_torch.layers import rglru, rwkv
from repro_torch.layers.norms import apply_norm, norm_shapes

KINDS = ("A", "L", "M", "C", "R", "W", "E", "D")


class DecoderCache(NamedTuple):
    """A "D" block's cache: its self-attention's ``KVCache`` (``max_len``
    wide, a slot written each step) and the cross-attention's static
    ``KVCache`` over the encoded frames."""
    self: attn.KVCache
    cross: attn.KVCache


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}; known: {KINDS}")


def block_shapes(cfg, kind: str):
    """``{"ln1", "ln2", "attn", "mlp"}`` of parameter shapes, the
    reference's tree for one block; an "M" block has ``"moe"`` (a nested
    ``{"router", "experts"}``) and ``"mlp"`` only with a dense residual; an
    "R" block ``"lru"`` and ``"mlp"``; a "W" block only ``"rwkv"`` (with a
    nested ``"ln_x"``) beside its norms; a "C" block ``"cross"`` (with its
    0-dim ``gate``) and ``"mlp"``; a "D" block ``"attn"``, ``"lnx"``,
    ``"cross"`` and ``"mlp"``."""
    _check_kind(kind)
    shapes = {"ln1": norm_shapes(cfg), "ln2": norm_shapes(cfg)}
    if kind == "R":
        return {**shapes, "lru": rglru.lru_shapes(cfg), "mlp": mlp_mod.mlp_shapes(cfg)}
    if kind == "W":
        return {**shapes, "rwkv": rwkv.rwkv_shapes(cfg)}
    if kind == "C":
        return {**shapes, "cross": attn.attention_shapes(cfg, cross=True), "mlp": mlp_mod.mlp_shapes(cfg)}
    shapes["attn"] = attn.attention_shapes(cfg)
    if kind == "D":
        shapes["lnx"] = norm_shapes(cfg)
        shapes["cross"] = attn.attention_shapes(cfg, cross=True)
    if kind == "M":
        shapes["moe"] = moe_mod.moe_shapes(cfg)
    if kind != "M" or cfg.moe.dense_residual:
        shapes["mlp"] = mlp_mod.mlp_shapes(cfg)
    return shapes


def init_rules(cfg, kind: str):
    """The reference's init of a block's leaves that are neither glorot
    matrices nor zero vectors (norms apart): ``"<part>.<name>"`` -> fill
    of a float32 tensor from a generator."""
    parts = {"R": ("lru", rglru.init_rules), "W": ("rwkv", rwkv.init_rules)}
    if kind not in parts:
        return {}
    part, rules = parts[kind]
    return {f"{part}.{name}": fill for name, fill in rules(cfg).items()}


def _ffn(cfg, kind: str, params, x):
    """The block's feed-forward on the residual stream ``x``: its MLP, or
    for "M" the MoE plus the dense residual MLP. Returns (x, aux): the MoE's
    auxiliary loss (a float32 scalar), 0.0 for the other kinds."""
    hn = apply_norm(cfg, params["ln2"], x)
    if kind != "M":
        return x + mlp_mod.apply_mlp(cfg, params["mlp"], hn), 0.0
    mo, aux = moe_mod.apply_moe(cfg, params["moe"], hn)
    if "mlp" in params:
        mo = mo + mlp_mod.apply_mlp(cfg, params["mlp"], hn)
    return x + mo, aux


def _attn_kind(kind: str) -> str:
    return "A" if kind in ("M", "E") else kind


def apply_block_train(cfg, kind: str, params, x, positions, context=None, emit_cache: bool = False):
    """Returns (x, aux, cache_or_state_or_None), the reference's triple:
    ``aux`` is an "M" block's MoE auxiliary loss (0.0 for the other kinds;
    prefill drops it). ``context`` (B, C, d) is what a "C" or "D" block's
    cross-attention attends to; an "E" block emits no cache."""
    _check_kind(kind)
    if kind == "C":
        h, cache = attn.attention_train(cfg, params["cross"], apply_norm(cfg, params["ln1"], x), positions,
                                        context=context, emit_cache=emit_cache)
        return (*_ffn(cfg, kind, params, x + h), cache)
    if kind == "D":
        h, self_cache = attn.attention_train(cfg, params["attn"], apply_norm(cfg, params["ln1"], x), positions,
                                             emit_cache=emit_cache)
        x = x + h
        h, cross_cache = attn.attention_train(cfg, params["cross"], apply_norm(cfg, params["lnx"], x), positions,
                                              context=context, emit_cache=emit_cache)
        x, aux = _ffn(cfg, kind, params, x + h)
        return x, aux, (DecoderCache(self_cache, cross_cache) if emit_cache else None)
    if kind == "R":
        h, state = rglru.apply_recurrent_train(cfg, params["lru"], apply_norm(cfg, params["ln1"], x), emit_state=True)
        return (*_ffn(cfg, kind, params, x + h), state if emit_cache else None)
    if kind == "W":
        h1n = apply_norm(cfg, params["ln1"], x)
        h, s_final = rwkv.time_mix_train(cfg, params["rwkv"], h1n, emit_state=True)
        x = x + h
        h2n = apply_norm(cfg, params["ln2"], x)
        x = x + rwkv.channel_mix_train(cfg, params["rwkv"], h2n)
        state = rwkv.RWKVState(s=s_final, shift_t=h1n[:, -1], shift_c=h2n[:, -1]) if emit_cache else None
        return x, 0.0, state
    encoder = kind == "E"
    h, cache = attn.attention_train(
        cfg, params["attn"], apply_norm(cfg, params["ln1"], x), positions,
        kind=_attn_kind(kind), emit_cache=emit_cache and not encoder, causal=False if encoder else None,
    )
    return (*_ffn(cfg, kind, params, x + h), cache)


def init_block_cache(cfg, kind: str, batch: int, max_len: int, device, ctx_len: int = 0):
    """A zero decode cache: ``max_len`` positions wide (a window on a local
    layer), a context cache ``ctx_len`` wide; an "E" block has none."""
    _check_kind(kind)
    if kind == "E":
        raise ValueError("an encoder block ('E') keeps no decode cache")
    if kind == "C":
        return attn.init_kv_cache(cfg, batch, ctx_len, "A", device)
    if kind == "D":
        return DecoderCache(attn.init_kv_cache(cfg, batch, max_len, "A", device),
                            attn.init_kv_cache(cfg, batch, ctx_len, "A", device))
    if kind == "R":
        return rglru.init_lru_state(cfg, batch, device)
    if kind == "W":
        return rwkv.init_rwkv_state(cfg, batch, device)
    return attn.init_kv_cache(cfg, batch, max_len, _attn_kind(kind), device)


def apply_block_decode(cfg, kind: str, params, x, pos, cache):
    """Single-token step at ``pos`` (an ``int`` or a 0-dim int64 tensor on
    ``x``'s device). Returns (x, cache), the cache updated in place: a KV
    slot written, or every tensor of a recurrent state overwritten (after
    the step has read them all); a context cache is only read."""
    _check_kind(kind)
    if kind == "E":
        raise ValueError("an encoder block ('E') has no decode step")
    if kind == "C":
        h = attn.cross_attention_decode(cfg, params["cross"], apply_norm(cfg, params["ln1"], x), cache)
        return _ffn(cfg, kind, params, x + h)[0], cache
    if kind == "D":
        h, _ = attn.attention_decode(cfg, params["attn"], apply_norm(cfg, params["ln1"], x), pos, cache.self,
                                     kind="A")
        x = x + h
        h = attn.cross_attention_decode(cfg, params["cross"], apply_norm(cfg, params["lnx"], x), cache.cross)
        return _ffn(cfg, kind, params, x + h)[0], cache
    if kind == "R":
        h, state = rglru.apply_recurrent_decode(cfg, params["lru"], apply_norm(cfg, params["ln1"], x), cache)
        x = _ffn(cfg, kind, params, x + h)[0]
        return x, _write(cache, state)
    if kind == "W":
        h, s_new, shift_t = rwkv.time_mix_decode(cfg, params["rwkv"], apply_norm(cfg, params["ln1"], x), cache)
        x = x + h
        h2, shift_c = rwkv.channel_mix_decode(cfg, params["rwkv"], apply_norm(cfg, params["ln2"], x), cache)
        return x + h2, _write(cache, rwkv.RWKVState(s=s_new, shift_t=shift_t, shift_c=shift_c))
    h, cache = attn.attention_decode(
        cfg, params["attn"], apply_norm(cfg, params["ln1"], x), pos, cache, kind=_attn_kind(kind)
    )
    return _ffn(cfg, kind, params, x + h)[0], cache


def _write(cache, state):
    """Copy each tensor of ``state`` into ``cache``'s own; returns ``cache``."""
    for dst, src in zip(cache, state):
        dst.copy_(src)
    return cache
