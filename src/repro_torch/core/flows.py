"""Execution-flow configuration shared by all HGNN models.

``flow``:
  * ``staged``        — traditional baseline (no pruning)
  * ``staged_pruned`` — separate top-K pass then staged NA (``lax.top_k``
                        tie rule: lower slot index wins)
  * ``fused``         — the reference's scan emulation of the fused flow.
                        Its domain always holds earlier slots than the tile
                        merged into it, so ``top_k`` over [domain, tile]
                        keeps the same neighbors as ``staged_pruned``; it
                        runs that computation
  * ``fused_kernel``  — ADE fused NA through the CUDA kernel pairs
                        (first-minimum eviction, strict ``>``)

``run_aggregate`` works on raw padded-CSC tensors; ``run_aggregate_graph``
takes a flat ``SemanticGraph`` or a degree-bucketed
``BucketedSemanticGraph``. Bucketed NA is one dispatch per semantic graph:
``fused_kernel`` runs the grouped kernel pair (one launch of each kernel
for all buckets), the other flows run each bucket on a contiguous view of
θ_*v reordered once into bucket-concatenation order, and one
inverse-permutation gather restores target order.
``FlowConfig(bucket_dispatch="loop")`` is the reference's per-bucket
dispatch instead: one ``run_aggregate`` per bucket (under ``fused_kernel``
one launch of the flat kernel pair per pruned bucket), each followed by an
``index_copy`` into the output. A flat graph is one ``run_aggregate``
(under ``fused_kernel`` one flat launch pair when D > K). Wherever a
table's padded width is ≤ ``prune_k``, ``fused_kernel`` takes the paper's
§4.3 pruner bypass: the plain aggregation, no retention domain.

Several devices: when a ``torch.distributed`` device mesh with a
``bucket_tiles`` rule axis is ambient (``distributed.sharding.set_mesh``),
``fused_kernel`` bucketed NA shards: the graph's ``ShardedBucketLayout``
splits the grouped tile stack by target row blocks, each rank runs ONE
fused launch on its own shard, and one all-gather plus the global inverse
permutation restore target order, bit for bit the single-device launch.
With no mesh, or ``FlowConfig(shard="off")``, nothing changes. Models
resolve the mesh at most once per ``apply`` (``mesh_scope``); a session
resolves it once at build and pins it.

Device mirrors of a graph's tables are cached on the graph per device, so
repeated forwards copy nothing from the host. They are built as normal
tensors even when the first forward runs under ``torch.inference_mode()``
(a session's), so a later forward on the same graph can be differentiated.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import from_host, trace
from repro_torch.core import attention
from repro_torch.core.hetgraph import BucketedSemanticGraph, SemanticGraph
from repro_torch.distributed import sharding as dist

# Python-side dispatch accounting:
#   graph_calls  — run_aggregate_graph entries on bucketed graphs
#   bucket_calls — per-bucket NA dispatches of bucket_dispatch="loop"
#   sharded_calls — bucketed NA dispatches routed to the mesh-sharded path
#   mesh_lookups — ambient-mesh resolutions (dist.graph_mesh) paid by NA
#                  dispatch: at most one per model apply (mesh_scope), none
#                  in a session, which pins the mesh it resolved at build
#   query_calls  — InferenceSession.query blocks served
#   ego_calls    — InferenceSession.query_ego blocks served on their
#                  extracted neighborhood (core/ego.py)
#   ego_bypass   — those whose every ego table is at most prune_k wide under
#                  fused / fused_kernel: every graph takes the §4.3 bypass
#   ego_fallback — query_ego blocks whose closure outgrew the top ego
#                  capacity, served by the full forward (session.query)
#   ego_traces   — ego programs built, one per ego signature: a CUDA graph
#                  captured on a card, an eager program on the CPU
DISPATCH = {
    "graph_calls": 0, "bucket_calls": 0, "sharded_calls": 0, "mesh_lookups": 0,
    "query_calls": 0, "ego_calls": 0, "ego_bypass": 0, "ego_fallback": 0, "ego_traces": 0,
}

# the mesh-resolution scope stack, a ContextVar so that each thread sees its
# own; entries are one-slot caches [resolved, graph_mesh() result or None]
_UNSET = object()
_MESH_SCOPE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh_scope", default=())


@contextlib.contextmanager
def mesh_scope(pinned=_UNSET):
    """A scope within which the ambient graph mesh is resolved at most once.

    With no argument it is lazy: the first NA dispatch inside that needs
    the mesh resolves it (one ``DISPATCH["mesh_lookups"]`` tick) and later
    dispatches reuse the result; opened inside another scope it reuses
    that scope's slot, so a pinning caller wins over a model's own scope.
    With ``pinned=<graph_mesh() result or None>`` it is resolved already
    and no lookup happens inside: a session pins the mesh it resolved at
    build, and an ego forward pins no mesh."""
    stack = _MESH_SCOPE.get()
    if pinned is _UNSET and stack:
        yield
        return
    entry = [pinned is not _UNSET, None if pinned is _UNSET else pinned]
    token = _MESH_SCOPE.set(stack + (entry,))
    try:
        yield
    finally:
        _MESH_SCOPE.reset(token)


def _graph_mesh_once():
    """The scope-cached ``dist.graph_mesh()``; outside any scope, resolved
    (and counted) at every call."""
    stack = _MESH_SCOPE.get()
    if stack:
        entry = stack[-1]
        if not entry[0]:
            DISPATCH["mesh_lookups"] += 1
            entry[1], entry[0] = dist.graph_mesh(), True
        return entry[1]
    DISPATCH["mesh_lookups"] += 1
    return dist.graph_mesh()


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    flow: str = "staged"
    prune_k: Optional[int] = None
    # "single": one dispatch per semantic graph; "loop": the reference's
    # per-bucket dispatch (the flat kernel pair per pruned bucket)
    bucket_dispatch: str = "single"
    # "auto": fused_kernel bucketed NA shards over the ambient mesh's
    # bucket_tiles axis when there is one; "off": never shards
    shard: str = "auto"

    def __post_init__(self):
        if self.flow not in ("staged", "staged_pruned", "fused", "fused_kernel"):
            raise ValueError(f"unknown flow {self.flow!r}")
        if self.bucket_dispatch not in ("single", "loop"):
            raise ValueError(f"unknown bucket_dispatch {self.bucket_dispatch!r}")
        if self.shard not in ("auto", "off"):
            raise ValueError(f"unknown shard {self.shard!r}")


def run_aggregate(
    cfg: FlowConfig,
    h_proj: torch.Tensor,
    scores: attention.DecomposedScores,
    nbr_idx: torch.Tensor,
    nbr_mask: torch.Tensor,
    edge_type: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NA over one padded-CSC table -> (T, H, dh)."""
    if cfg.flow == "staged":
        return attention.aggregate_staged(
            h_proj, scores, nbr_idx, nbr_mask, edge_type, prune_k=None
        )
    # paper §4.3: when the whole padded table fits under K, the retention
    # domain is a no-op and the fused flow IS the plain aggregation
    if cfg.flow in ("staged_pruned", "fused") or (
        cfg.prune_k is not None and cfg.prune_k >= nbr_idx.shape[1]
    ):
        return attention.aggregate_staged(
            h_proj, scores, nbr_idx, nbr_mask, edge_type, prune_k=cfg.prune_k
        )
    from repro_torch.kernels.fused_prune_aggregate import ops as k_ops

    return k_ops.fused_prune_aggregate(
        h_proj, scores.theta_src, scores.theta_dst, nbr_idx, nbr_mask,
        theta_rel=_kernel_rel(scores), edge_type=edge_type,
        prune_k=cfg.prune_k, slope=attention.LEAKY_SLOPE,
    )


def _kernel_rel(scores: attention.DecomposedScores) -> Optional[torch.Tensor]:
    """θ_rel as the kernels take it, float32. It is bfloat16 (or float16)
    when the rel parameters are; the reference's kernels promote it in
    their body, and the cast up is exact."""
    rel = scores.theta_rel
    return None if rel is None else rel.float()


def _tick_slots(cfg: FlowConfig, sg, route, table) -> None:
    """Tick the NA slot counters (``ops.NA_SLOTS`` and
    ``NA_SLOTS_BY_GRAPH[sg.name]``) for the fused launch over ``table``,
    one of ``sg``'s: a grouped layout or one shard of it (a
    ``t_tile × w`` tile a grid step, the degrees of the targets it holds),
    or a host padded mask (T × D slots). Every fused route ticks here,
    before the launch, so a CPU forward counts too; nothing ticks off the
    ``fused_kernel`` flow, for a table without grid steps or within the
    §4.3 bypass (no launch), or for a table given as a tensor (an ego
    batch's, built per query). The counts are cached on the graph per
    ``route`` and ``prune_k``."""
    if cfg.flow != "fused_kernel" or isinstance(table, torch.Tensor):
        return
    k = cfg.prune_k
    if isinstance(table, np.ndarray):
        if k is not None and k >= table.shape[1]:
            return
    elif table.num_steps == 0:
        return
    from repro_torch.kernels.fused_prune_aggregate import ops as k_ops

    key = ("slots", route, k)
    counts = sg._device.get(key)
    if counts is None:
        if isinstance(table, np.ndarray):
            deg, slots = table.sum(axis=1), table.size
        else:
            deg, slots = sg.degrees()[table.perm >= 0], table.num_steps * table.t_tile * table.w
        counts = sg._device[key] = k_ops.slot_counts(deg, slots, k)
    by = k_ops.NA_SLOTS_BY_GRAPH.setdefault(sg.name, dict.fromkeys(k_ops.SLOT_FIELDS, 0))
    for f in k_ops.SLOT_FIELDS:
        k_ops.NA_SLOTS[f] += counts[f]
        by[f] += counts[f]


def _table(nbr, msk, ety, use_ety: bool, device: torch.device):
    """Device mirror of one padded-CSC table: int32 ids, bool mask, int32
    edge types (``None`` without a rel term), the dtypes the kernels take."""
    return (
        from_host(nbr.astype("int32"), device),
        from_host(msk, device),
        from_host(ety.astype("int32"), device) if use_ety else None,
    )


def _flat_tables(sg: SemanticGraph, use_ety: bool, device: torch.device):
    """Device mirror of a flat graph's table, cached on the graph per
    device. A graph whose tables are tensors already (an ego batch's views,
    built per query) is used as it is, and nothing is cached on it."""
    if isinstance(sg.nbr_idx, torch.Tensor):
        return sg.nbr_idx, sg.nbr_mask, sg.edge_type if use_ety else None
    key = ("tables", use_ety, device)
    if key not in sg._device:
        with torch.inference_mode(False), trace.span("upload", always=True, what="na tables"):
            sg._device[key] = _table(sg.nbr_idx, sg.nbr_mask, sg.edge_type, use_ety, device)
    return sg._device[key]


def _bucket_loop_tables(sg: BucketedSemanticGraph, use_ety: bool, device: torch.device):
    """Per bucket: device targets and table, cached on the graph."""
    key = ("loop", use_ety, device)
    if key not in sg._device:
        with torch.inference_mode(False), trace.span("upload", always=True, what="na tables"):
            sg._device[key] = tuple(
                (from_host(b.targets.astype("int64"), device),)
                + _table(b.nbr_idx, b.nbr_mask, b.edge_type, use_ety, device)
                for b in sg.buckets
            )
    return sg._device[key]


def _device_tables(sg: BucketedSemanticGraph, use_ety: bool, device: torch.device):
    """Device mirrors of the bucket tables + concat order + inverse perm,
    cached on the graph per device."""
    key = ("tables", use_ety, device)
    if key not in sg._device:
        with torch.inference_mode(False), trace.span("upload", always=True, what="na tables"):
            tables = tuple(
                _table(b.nbr_idx, b.nbr_mask, b.edge_type, use_ety, device)
                for b in sg.buckets
                if b.num_targets > 0
            )
            sg._device[key] = (
                tables,
                from_host(sg.concat_targets().astype("int64"), device),
                from_host(sg.target_perm().astype("int64"), device),
            )
    return sg._device[key]


def run_aggregate_graph_bucket_loop(
    cfg: FlowConfig,
    h_proj: torch.Tensor,
    scores: attention.DecomposedScores,
    sg: BucketedSemanticGraph,
) -> torch.Tensor:
    """The reference's per-bucket dispatch: per bucket one θ_*v gather, one
    ``run_aggregate`` and one ``index_copy`` into a zero output."""
    use_ety = scores.theta_rel is not None
    _, h, dh = h_proj.shape
    out = torch.zeros((sg.num_targets, h, dh), dtype=h_proj.dtype, device=h_proj.device)
    tables = _bucket_loop_tables(sg, use_ety, h_proj.device)
    for i, (b, (targets, nbr, msk, ety)) in enumerate(zip(sg.buckets, tables)):
        DISPATCH["bucket_calls"] += 1
        _tick_slots(cfg, sg, ("bucket", i), b.nbr_mask)
        z = run_aggregate(
            cfg, h_proj, attention.slice_targets(scores, targets), nbr, msk, ety
        )
        out.index_copy_(0, targets, z.to(h_proj.dtype))
    return out


def run_aggregate_graph(
    cfg: FlowConfig,
    h_proj: torch.Tensor,
    scores: attention.DecomposedScores,
    sg: Union[SemanticGraph, BucketedSemanticGraph],
) -> torch.Tensor:
    """NA over a semantic graph -> (num_targets, H, dh).

    ``scores.theta_dst`` covers the graph's full target range (one row per
    ``dst_type`` vertex, in local order).
    """
    use_ety = scores.theta_rel is not None
    dev = h_proj.device
    if isinstance(sg, BucketedSemanticGraph):
        DISPATCH["graph_calls"] += 1
        if cfg.bucket_dispatch == "loop":
            return run_aggregate_graph_bucket_loop(cfg, h_proj, scores, sg)
        if cfg.flow == "fused_kernel":
            from repro_torch.kernels.fused_prune_aggregate import ops as k_ops

            # the kernel accumulates in f32; cast back so the dispatch
            # never changes the output dtype
            gm = _graph_mesh_once() if cfg.shard == "auto" else None
            if gm is not None:
                mesh, axis, _ = gm
                DISPATCH["sharded_calls"] += 1
                sl = sg.sharded(dist.axis_size(mesh, axis), k_ops.T_TILE, k_ops.W_TILE)
                rank = dist.shard_rank(mesh, axis)
                _tick_slots(cfg, sg, ("shard", len(sl.shards), rank), sl.shards[rank])
                return k_ops.fused_prune_aggregate_grouped_sharded(
                    h_proj, scores.theta_src, scores.theta_dst, sg, mesh, axis,
                    theta_rel=_kernel_rel(scores), prune_k=cfg.prune_k,
                    slope=attention.LEAKY_SLOPE,
                ).to(h_proj.dtype)
            _tick_slots(cfg, sg, "grouped", sg.grouped(k_ops.T_TILE, k_ops.W_TILE))
            return k_ops.fused_prune_aggregate_grouped(
                h_proj, scores.theta_src, scores.theta_dst, sg,
                theta_rel=_kernel_rel(scores), prune_k=cfg.prune_k,
                slope=attention.LEAKY_SLOPE,
            ).to(h_proj.dtype)
        tables, order, perm = _device_tables(sg, use_ety, dev)
        if not tables:
            _, h, dh = h_proj.shape
            return torch.zeros((sg.num_targets, h, dh), dtype=h_proj.dtype, device=dev)
        theta_dst = scores.theta_dst[order]
        outs, off = [], 0
        for nbr, msk, ety in tables:
            t_b = nbr.shape[0]
            sc = attention.DecomposedScores(
                scores.theta_src, theta_dst[off:off + t_b], scores.theta_rel
            )
            outs.append(run_aggregate(cfg, h_proj, sc, nbr, msk, ety))
            off += t_b
        return torch.cat(outs, dim=0)[perm]
    tables = _flat_tables(sg, use_ety, dev)
    _tick_slots(cfg, sg, "flat", sg.nbr_mask)
    return run_aggregate(cfg, h_proj, scores, *tables)
