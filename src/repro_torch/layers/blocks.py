"""Layer blocks: parameter shapes, prefill-apply, cache init and
decode-apply, dispatched by kind (the reference's ``repro/layers/blocks.py``).

Kinds ported:
  A  global attention + MLP            L  sliding-window attention + MLP
  M  attention + MoE (opt. dense res)

An "M" block's attention runs as kind "A" (a global cache; ADE pruning
when ``cfg.attn_prune_k`` is set), then the MoE on ``ln2(x)``, plus the
dense MLP on the same normed input when ``cfg.moe.dense_residual``
(arctic). Every other kind of the reference (C, R, W, E, D) raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from repro_torch.layers import attention as attn
from repro_torch.layers import mlp as mlp_mod
from repro_torch.layers import moe as moe_mod
from repro_torch.layers.norms import apply_norm, norm_shapes

_NOT_PORTED = {
    "R": "ROADMAP §1 LM-3 (RG-LRU 'R' blocks, layers/rglru.py)",
    "W": "ROADMAP §1 LM-4 (RWKV 'W' blocks, layers/rwkv.py)",
    "C": "ROADMAP §1 LM-5 (cross-attention 'C' decode)",
    "E": "ROADMAP §1 LM-6 (audio encoder-decoder 'E'/'D')",
    "D": "ROADMAP §1 LM-6 (audio encoder-decoder 'E'/'D')",
}


def _check_kind(kind: str) -> None:
    if kind not in ("A", "L", "M"):
        if kind in _NOT_PORTED:
            raise NotImplementedError(
                f"block kind {kind!r} is not ported to repro_torch yet: {_NOT_PORTED[kind]}"
            )
        raise ValueError(kind)


def block_shapes(cfg, kind: str):
    """``{"ln1", "ln2", "attn", "mlp"}`` of parameter shapes, the
    reference's tree for one block; an "M" block has ``"moe"`` (a nested
    ``{"router", "experts"}``) and ``"mlp"`` only with a dense residual."""
    _check_kind(kind)
    shapes = {"ln1": norm_shapes(cfg), "ln2": norm_shapes(cfg), "attn": attn.attention_shapes(cfg)}
    if kind == "M":
        shapes["moe"] = moe_mod.moe_shapes(cfg)
    if kind != "M" or cfg.moe.dense_residual:
        shapes["mlp"] = mlp_mod.mlp_shapes(cfg)
    return shapes


def _ffn(cfg, kind: str, params, x):
    """The block's feed-forward on the residual stream ``x``: its MLP, or
    for "M" the MoE (aux loss dropped) plus the dense residual MLP."""
    hn = apply_norm(cfg, params["ln2"], x)
    if kind != "M":
        return x + mlp_mod.apply_mlp(cfg, params["mlp"], hn)
    mo, _ = moe_mod.apply_moe(cfg, params["moe"], hn)
    if "mlp" in params:
        mo = mo + mlp_mod.apply_mlp(cfg, params["mlp"], hn)
    return x + mo


def _attn_kind(kind: str) -> str:
    return "A" if kind == "M" else kind


def apply_block_train(cfg, kind: str, params, x, positions, emit_cache: bool = False):
    """Returns (x, cache_or_None)."""
    _check_kind(kind)
    h, cache = attn.attention_train(
        cfg, params["attn"], apply_norm(cfg, params["ln1"], x), positions,
        kind=_attn_kind(kind), emit_cache=emit_cache,
    )
    return _ffn(cfg, kind, params, x + h), cache


def init_block_cache(cfg, kind: str, batch: int, max_len: int, device):
    _check_kind(kind)
    return attn.init_kv_cache(cfg, batch, max_len, _attn_kind(kind), device)


def apply_block_decode(cfg, kind: str, params, x, pos, cache):
    """Single-token step at ``pos`` (an ``int`` or a 0-dim int64 tensor on
    ``x``'s device). Returns (x, cache), the cache updated in place."""
    _check_kind(kind)
    h, cache = attn.attention_decode(
        cfg, params["attn"], apply_norm(cfg, params["ln1"], x), pos, cache, kind=_attn_kind(kind)
    )
    return _ffn(cfg, kind, params, x + h), cache
