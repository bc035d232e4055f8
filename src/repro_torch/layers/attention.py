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
once at prefill and only read at decode.

Under a device mesh a self-attention cache may be a DTensor whose
positions are split over the ranks of one mesh axis (``cache_seq``,
``distributed/sharding.py``'s ``cache_shardings``): rank r holds positions
[r·c/n, (r+1)·c/n). Decode then writes the new K/V on the rank that owns
the slot, and attends in SPMD form: a dense layer merges each rank's
(max, sum, unnormalized α·V) the flash-decode way; a pruned global layer
keeps K positions by the kernels' rule through the Pruner (kernel #3) on
the logits gathered over the ranks, or, with ``cfg.hier_topk``, on each
rank's own logits and then on the n·K candidates gathered
(:func:`split_pruned_decode`), and each rank runs kernel #4's K2 on the
rows it holds, the partial outputs summed. With one rank on that axis
every layer runs the unsplit path, bit for bit. :class:`ThreadLoopback`
runs each rank of such a split as a thread of one process, so that one
device can drive them all. :func:`hier_topk` is the reference's
``_hier_topk`` over logits (``top_k``'s rule).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import sharding
from repro_torch.kernels.common import NEG as KERNEL_NEG
from repro_torch.kernels.common import top_k_order
from repro_torch.kernels.topk_decode_attention.ops import topk_decode_attention, value_gather
from repro_torch.kernels.topk_decode_attention.ref import score_logits_plain
from repro_torch.kernels.topk_select.ops import topk_select
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


def attention_decode(cfg, params, x, pos, cache: KVCache, kind: str = "A", split=None):
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
    ring-buffer cache of window width. A cache whose positions are split
    over several ranks decodes in SPMD form (see the module docstring).
    ``split``: how the cache's positions are split, in place of
    :func:`position_split` of ``cache.k`` (a caller running each rank of a
    :class:`ThreadLoopback` passes that rank's, the cache its block).
    """
    b = x.shape[0]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    pos = position_tensor(pos, x.device)
    q, k, v = _project_qkv(cfg, params, x)
    rot = int(cfg.hd * cfg.rope_fraction)
    cos, sin = rope_angles(pos.expand(b, 1), rot, _rope_base(cfg, kind))
    q = apply_rope(q, cos, sin, cfg.rope_fraction)
    k = apply_rope(k, cos, sin, cfg.rope_fraction)

    split = position_split(cache.k) if split is None else split
    ck, cv = _local(cache.k), _local(cache.v)
    if split.n > 1:
        o = _split_decode(cfg, q, k, v, ck, cv, pos, kind, split)
        out = o.reshape(b, 1, h * hd) @ params["wo"].to(cfg.adtype)
        return out.to(x.dtype), cache
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


def cross_attention_decode(cfg, params, x, cache: KVCache, split=None):
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
    two keep the same rows.

    A context cache whose rows are split over ranks (``cache_shardings``
    splits them over ``model`` where they divide) decodes in SPMD form,
    every row valid: dense, the flash-decode merge of the ranks' (max,
    sum, α·V); pruned, :func:`split_pruned_decode` (kernel #3 on the
    gathered logits, or ``hier_topk``'s merge, then K2 on each rank's
    rows, the partials summed). With one rank the unsplit path runs.
    ``split`` as in :func:`attention_decode`."""
    b = x.shape[0]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = cfg.adtype
    split = position_split(cache.k) if split is None else split
    ck, cv = _local(cache.k), _local(cache.v)
    c = split.n * ck.shape[1]
    q = _bias(params, "bq", x.to(dt) @ params["wq"].to(dt), dt)
    scale = hd ** -0.5
    prune_k = cfg.attn_prune_k
    if split.n > 1:
        cl = ck.shape[1]
        off = split.rank * cl
        if prune_k is not None and prune_k < c:
            lengths = torch.full((b,), c, dtype=torch.int32, device=x.device)
            o = split_pruned_decode(q.reshape(b, h, hd), ck, cv, lengths, off, c, prune_k, scale, cfg.hier_topk,
                                    split.comm).to(dt)
        else:
            valid = torch.ones(cl, dtype=torch.bool, device=x.device)
            o = _merged_decode(q.reshape(b, 1, h, hd), ck, cv, valid, scale, split.comm).to(dt)
    elif prune_k is not None and prune_k < c:
        lengths = torch.full((b,), c, dtype=torch.int32, device=x.device)
        o = topk_decode_attention(q.reshape(b, h, hd), ck, cv, lengths, prune_k, scale).to(dt)
    else:
        qg = q.reshape(b, hkv, h // hkv, hd)
        logits = torch.einsum("bkgd,bskd->bkgs", qg, ck).float() * scale
        alpha = torch.softmax(logits, dim=-1).to(dt)
        o = torch.einsum("bkgs,bskd->bkgd", alpha, cv)
    out = _gated(params, o.reshape(b, 1, h * hd) @ params["wo"].to(dt))
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# decode over a cache whose positions are split across ranks
# ---------------------------------------------------------------------------

class PositionSplit(NamedTuple):
    """How a decode cache tensor's positions (dim 1) are split: over ``n``
    ranks, this rank holding block ``rank``, ``comm`` giving the split
    decode's collectives among them (:class:`MeshComm`)."""
    n: int
    rank: int
    comm: object


def position_split(t) -> PositionSplit:
    """A cache tensor's :class:`PositionSplit`: n = 1 for a plain tensor or
    a DTensor whose positions no mesh dim splits. Positions split over
    more than one mesh dim raise ``ValueError``."""
    if type(t).__name__ != "DTensor":
        return PositionSplit(1, 0, None)
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    dims = [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == 1]
    if not dims:
        return PositionSplit(1, 0, None)
    if len(dims) > 1:
        raise ValueError(f"cache positions split over {len(dims)} mesh dims; decode splits them over one")
    axis = mesh.mesh_dim_names[dims[0]]
    return PositionSplit(int(mesh.size(dims[0])), int(mesh.get_local_rank(axis)), MeshComm(mesh, axis))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (its storage: writes go to the DTensor), a
    plain tensor as it is."""
    return t.to_local() if type(t).__name__ == "DTensor" else t


class MeshComm:
    """The two collectives of the split decode over one mesh axis, in rank
    order of that axis: ``gather`` (every rank's tensor stacked on a new
    leading dim) and ``sum`` / ``max`` (all-reduce)."""

    def __init__(self, mesh, axis: str):
        self.mesh, self.axis = mesh, axis

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return sharding.replicate(x[None], self.mesh, self.axis)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist

        x = x.contiguous()
        dist.all_reduce(x, op=getattr(dist.ReduceOp, op), group=self.mesh.get_group(self.axis))
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, "SUM")

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, "MAX")


class ThreadLoopback:
    """:class:`MeshComm`'s collectives among ``n`` threads of one process,
    each running one rank (``comm(r)``), so that one device can run a
    split decode's every rank: each collective takes every rank's tensor
    (a barrier) and gives each the stack, sum or max of all n in rank
    order. On the card the threads issue their kernels to the same stream,
    so the barrier orders them as well."""

    def __init__(self, n: int):
        import threading

        self.n = n
        self._parts = [None] * n
        self._barrier = threading.Barrier(n)

    def comm(self, rank: int) -> "_LoopbackComm":
        return _LoopbackComm(self, rank)

    def run(self, fns) -> list:
        """Each of the n callables run on a thread of its own, as rank r;
        their results in rank order (a rank's exception raised here)."""
        import threading

        out, errs = [None] * self.n, []

        def one(r):
            try:
                out[r] = fns[r]()
            except BaseException as e:  # noqa: BLE001  handed to the caller
                errs.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=one, args=(r,)) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out

    def _all(self, rank: int, x: torch.Tensor) -> list:
        self._parts[rank] = x
        self._barrier.wait()
        parts = list(self._parts)
        self._barrier.wait()  # every rank has read before any writes again
        return parts


class _LoopbackComm:
    def __init__(self, loop: ThreadLoopback, rank: int):
        self.loop, self.rank = loop, rank

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self.loop._all(self.rank, x))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        parts = self.loop._all(self.rank, x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self.loop._all(self.rank, x)).amax(dim=0)


def _split_decode(cfg, q, k, v, ck, cv, pos, kind: str, split: PositionSplit) -> torch.Tensor:
    """One decode step's attention on rank ``split.rank`` of a cache whose
    c positions are split n ways (``ck``, ``cv``: this rank's (B, c/n, Hkv,
    hd)); q, k, v this step's (B, 1, ·, hd). Writes k / v into slot ``pos
    % c`` on the rank that holds it (the others write their own row back),
    then attends: dense, the flash-decode merge of the ranks' (max, sum,
    α·V) in float32; pruned, :func:`split_pruned_decode`."""
    b = q.shape[0]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    cl = ck.shape[1]
    c, off = split.n * cl, split.rank * cl
    comm = split.comm
    slot = torch.remainder(pos, c)
    ls = torch.clamp(slot - off, 0, cl - 1).reshape(1)
    mine = (slot >= off) & (slot < off + cl)
    ck.index_copy_(1, ls, torch.where(mine, k.to(ck.dtype), ck.index_select(1, ls)))
    cv.index_copy_(1, ls, torch.where(mine, v.to(cv.dtype), cv.index_select(1, ls)))
    scale = hd ** -0.5
    prune_k = cfg.attn_prune_k if kind == "A" else None
    if prune_k is not None and prune_k < c:
        lengths = torch.clamp(pos + 1, max=c).to(torch.int32).expand(b)
        o = split_pruned_decode(q.reshape(b, h, hd), ck, cv, lengths, off, c, prune_k, scale, cfg.hier_topk, comm)
        return o.to(cv.dtype)
    idx = off + torch.arange(cl, device=q.device)
    abs_pos = pos - torch.remainder(pos - idx, c)
    valid = abs_pos >= 0
    if kind == "L" and cfg.sliding_window is not None:
        valid &= abs_pos > pos - cfg.sliding_window
    return _merged_decode(q, ck, cv, valid, scale, comm)


def _merged_decode(q, ck, cv, valid, scale: float, comm) -> torch.Tensor:
    """Dense decode attention over positions split across ranks: this
    rank's (B, c/n, Hkv, hd) block, ``valid`` (c/n,) its positions
    attended to; the ranks' (max, sum, unnormalized α·V) merged the
    flash-decode way in float32 -> (B, Hkv, g, hd) in ``cv``'s dtype."""
    b, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
    hkv = ck.shape[2]
    qg = q.reshape(b, hkv, h // hkv, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, ck).float() * scale
    logits = torch.where(valid[None, None, None, :], logits, NEG)
    m = comm.max(logits.amax(dim=-1))
    p = torch.exp(logits - m[..., None])
    o = torch.einsum("bkgs,bskd->bkgd", p, cv.float())
    tot = comm.sum(torch.cat([o, p.sum(dim=-1)[..., None]], dim=-1))
    return (tot[..., :hd] / tot[..., hd:]).to(cv.dtype)


def _pruned_stage1(q, ck, lengths, offset: int, k: int, scale: float, hier: bool) -> torch.Tensor:
    """A rank's part before the gather: its rows' float32 logits (B·H,
    c/n), in kernel #4 K1's order (``score_logits_plain``); with ``hier``
    its own K kept by the Pruner, values and global positions (their int32
    bits) stacked (2, B·H, K)."""
    b, h, _ = q.shape
    cl = ck.shape[1]
    logits = score_logits_plain(q, ck, scale).reshape(b * h, cl)
    if not hier:
        return logits
    valid = (offset + torch.arange(cl, device=q.device))[None, :] < lengths.long()[:, None]
    vals, ids = topk_select(logits, valid.repeat_interleave(h, dim=0), k)
    gids = torch.where(ids >= 0, ids + offset, -1).to(torch.int32)
    return torch.stack([vals, gids.view(torch.float32)])


def _pruned_stage2(gathered, lengths, c: int, k: int, hier: bool, b: int, h: int):
    """Every rank's same selection from the gathered parts -> (α (B, H, K)
    float32, global positions (B, H, K) int32, -1 empty): K kept by the
    Pruner from the whole row's logits (or from the n·K candidates), then
    K1's flush, a softmax over the kept logits (eps 1e-30)."""
    if hier:
        n = gathered.shape[0]
        cand = gathered.permute(1, 2, 0, 3).reshape(2, b * h, n * k)
        cids = cand[1].contiguous().view(torch.int32)
        vals, sel = topk_select(cand[0], cids >= 0, k)
        ids = torch.where(sel >= 0, cids.gather(1, sel.clamp(min=0).long()), -1)
    else:
        table = gathered.permute(1, 0, 2).reshape(b * h, c)
        valid = torch.arange(c, device=table.device)[None, :] < lengths.long()[:, None]
        vals, ids = topk_select(table, valid.repeat_interleave(h, dim=0), k)
    ok = vals > KERNEL_NEG / 2
    lg = torch.where(ok, vals, KERNEL_NEG)
    ex = torch.where(ok, torch.exp(lg - lg.amax(dim=-1, keepdim=True)), 0.0)
    alpha = ex / (ex.sum(dim=-1, keepdim=True) + 1e-30)
    return alpha.reshape(b, h, k), torch.where(ok, ids, -1).to(torch.int32).reshape(b, h, k)


def _pruned_stage3(alpha, ids, cv, offset: int) -> torch.Tensor:
    """A rank's partial output (B, H, hd) float32: kernel #4's K2 over the
    kept positions it holds."""
    cl = cv.shape[1]
    mine = (ids >= offset) & (ids < offset + cl)
    return value_gather(torch.where(mine, alpha, 0.0).contiguous(),
                        torch.where(mine, ids - offset, -1).to(torch.int32).contiguous(), cv.contiguous())


def canonical_ids(ids: torch.Tensor) -> torch.Tensor:
    """Kept positions ascending, -1 last (kernel #4 K1's layout)."""
    big = torch.iinfo(torch.int32).max
    key = torch.sort(torch.where(ids >= 0, ids, big), dim=-1).values
    return torch.where(key == big, -1, key).to(torch.int32)


def split_pruned_decode(q, ck, cv, lengths, offset: int, c: int, k: int, scale: float, hier: bool, comm,
                        return_ids: bool = False):
    """Pruned decode attention on one rank of a cache of ``c`` positions
    split over ranks: ``ck`` / ``cv`` (B, c/n, Hkv, hd) hold positions
    [offset, offset + c/n); q (B, H, hd); ``lengths`` (B,) valid positions
    of the whole cache -> (B, H, hd) float32 on every rank (and the kept
    positions in :func:`canonical_ids` layout with ``return_ids``).

    Without ``hier`` (or with fewer than K positions a rank, where the
    reference's ``_hier_topk`` falls back too) the ranks' logits are
    gathered and the Pruner keeps K of each whole row by the kernels' rule
    (first minimum evicted, strictly greater inserted): with K1's logits
    that is K1's own domain, ties included. With ``hier`` the Pruner keeps
    K of each rank's logits, then K of the n·K candidates gathered: on
    logits without ties the same K positions, on ties possibly others. K2
    runs on each rank's kept rows and ``comm.sum`` adds the partials.
    ``comm`` gives the collectives (:class:`MeshComm`, or a
    :class:`ThreadLoopback`'s)."""
    b, h, _ = q.shape
    hier = hier and ck.shape[1] >= k
    part = _pruned_stage1(q, ck, lengths, offset, k, scale, hier)
    alpha, ids = _pruned_stage2(comm.gather(part), lengths, c, k, hier, b, h)
    out = comm.sum(_pruned_stage3(alpha, ids, cv, offset))
    return (out, canonical_ids(ids)) if return_ids else out


def split_pruned_decode_loopback(q, k_cache, v_cache, lengths, n: int, k: int, scale: float, hier: bool,
                                 return_ids: bool = False):
    """:func:`split_pruned_decode` on ``n`` ranks run as threads of one
    process (:class:`ThreadLoopback`) on a whole cache (B, c, Hkv, hd) cut
    into n blocks of positions: every kernel launched as often as n ranks
    launch it; rank 0's result (every rank's is the same)."""
    c = k_cache.shape[1]
    if c % n:
        raise ValueError(f"{c} cache positions do not split {n} ways")
    cl = c // n
    kb, vb = k_cache.split(cl, dim=1), v_cache.split(cl, dim=1)
    loop = ThreadLoopback(n)
    return loop.run([lambda r=r: split_pruned_decode(q, kb[r].contiguous(), vb[r].contiguous(), lengths, r * cl, c, k,
                                                     scale, hier, loop.comm(r), return_ids)
                     for r in range(n)])[0]


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = top_k_order(x, k)
    return x.gather(-1, idx), idx


def hier_topk(logits: torch.Tensor, prune_k: int, c: int, mesh=None):
    """The reference's ``_hier_topk``: (values, indices) of the top
    ``prune_k`` of ``logits`` (B, Hkv, g, c) by ``top_k``'s rule, taken as a
    top-K inside each of the n ``cache_seq`` shards of ``mesh`` (ambient
    when omitted; a ``{axis: size}`` mapping will do), then a top-K of the
    n·K candidates. With one shard, or fewer than K positions a shard, a
    global top-K (as the reference falls back)."""
    sizes = sharding.mesh_axes(sharding.ambient_mesh() if mesh is None else mesh)
    n_sh = 1
    for ax in sharding.rules().get("cache_seq", ()):
        if ax in sizes and c % (n_sh * sizes[ax]) == 0:
            n_sh *= sizes[ax]
    if n_sh <= 1 or c // n_sh < prune_k:
        return _top_k(logits, prune_k)
    b, hkv, g, _ = logits.shape
    lv, li = _top_k(logits.reshape(b, hkv, g, n_sh, c // n_sh), prune_k)
    gi = li + (torch.arange(n_sh, device=logits.device) * (c // n_sh))[None, None, None, :, None]
    cand_v = lv.reshape(b, hkv, g, n_sh * prune_k)
    cand_i = gi.reshape(b, hkv, g, n_sh * prune_k)
    top_vals, sel = _top_k(cand_v, prune_k)
    return top_vals, torch.gather(cand_i, -1, sel)
