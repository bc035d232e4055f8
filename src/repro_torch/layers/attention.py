"""GQA attention: the chunked flash forward for prefill, and the cached
decode step with ADE top-K KV pruning on global layers (the paper's
technique on LM serving), with ring-buffer caches for sliding-window
layers. The reference is ``repro/layers/attention.py``.

Decode updates the cache in place: the new K/V row is written into the
cache tensors and the same ``KVCache`` is returned (the reference returns
new arrays; a copy of every cache per token would move the whole cache
each step). Cross-attention and the sharded retention domain
(``_hier_topk``) are not ported yet (ROADMAP §1 LM-5 and LM-8).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.topk_decode_attention.ops import topk_decode_attention
from repro_torch.layers.flash import flash_attention
from repro_torch.layers.rope import apply_rope, rope_angles

NEG = -2.3e38


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, C, Hkv, hd) — C = max len (global) or window (local)
    v: torch.Tensor


def attention_shapes(cfg):
    """Parameter shapes, ``(in, out)`` layout as the reference's; with
    ``cfg.qkv_bias`` also the biases ``bq``, ``bk``, ``bv`` (zero at init)."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    shapes = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd), "wo": (h * hd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(h * hd,), bk=(hkv * hd,), bv=(hkv * hd,))
    return shapes


def _project_qkv(cfg, params, x):
    dt = cfg.adtype
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = x.to(dt) @ params["wq"].to(dt)
    k = x.to(dt) @ params["wk"].to(dt)
    v = x.to(dt) @ params["wv"].to(dt)
    if "bq" in params:
        # each bias cast to the compute dtype first, as the reference does: a
        # float32 bias added to a bfloat16 product would promote it to float32
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    return q.reshape(b, s, h, hd), k.reshape(b, s, hkv, hd), v.reshape(b, s, hkv, hd)


def _rope_base(cfg, kind: str) -> float:
    if kind == "L" and cfg.rope_local_base is not None:
        return cfg.rope_local_base
    return cfg.rope_base


def attention_train(cfg, params, x, positions, kind: str = "A", emit_cache: bool = False):
    """Full-sequence causal self-attention (prefill): ``kind`` "A" is
    global, "L" sliding-window. Returns (out, KVCache of the sequence's
    K/V or None)."""
    q, k, v = _project_qkv(cfg, params, x)
    rot = int(cfg.hd * cfg.rope_fraction)
    cos, sin = rope_angles(positions, rot, _rope_base(cfg, kind))
    q = apply_rope(q, cos, sin, cfg.rope_fraction)
    k = apply_rope(k, cos, sin, cfg.rope_fraction)
    window = cfg.sliding_window if kind == "L" else None
    o = flash_attention(cfg, q, k, v, causal=True, window=window)
    out = o.reshape(x.shape[0], x.shape[1], -1) @ params["wo"].to(cfg.adtype)
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
