"""Execution-flow configuration shared by all HGNN models.

``flow``:
  * ``staged``        — traditional baseline (no pruning)
  * ``staged_pruned`` — separate top-K pass then staged NA (``lax.top_k``
                        tie rule: lower slot index wins)
  * ``fused``         — the reference's scan emulation of the fused flow;
                        comes with a later slice of the port
  * ``fused_kernel``  — ADE fused NA through the CUDA kernel pair on a
                        degree-bucketed graph (first-minimum eviction,
                        strict ``>``)

``run_aggregate`` works on raw padded-CSC tensors; ``run_aggregate_graph``
takes a flat ``SemanticGraph`` or a degree-bucketed
``BucketedSemanticGraph``. Bucketed NA is one dispatch per semantic graph:
``fused_kernel`` runs the grouped kernel pair (one launch of each kernel
for all buckets), the staged flows run each bucket on a contiguous view of
θ_*v reordered once into bucket-concatenation order, and one
inverse-permutation gather restores target order. Buckets whose capacity
is ≤ ``prune_k`` take the paper's §4.3 pruner bypass.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import attention
from repro_torch.core.hetgraph import BucketedSemanticGraph, SemanticGraph

# Python-side dispatch accounting:
#   graph_calls — run_aggregate_graph entries on bucketed graphs
#   query_calls — InferenceSession.query blocks served
DISPATCH = {"graph_calls": 0, "query_calls": 0}

_LATER = "comes with a later slice of the port"


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    flow: str = "staged"
    prune_k: Optional[int] = None
    # "single": one dispatch per semantic graph; "loop": the reference's
    # per-bucket dispatch (reaches the flat kernel, not ported yet)
    bucket_dispatch: str = "single"

    def __post_init__(self):
        if self.flow not in ("staged", "staged_pruned", "fused", "fused_kernel"):
            raise ValueError(f"unknown flow {self.flow!r}")
        if self.bucket_dispatch not in ("single", "loop"):
            raise ValueError(f"unknown bucket_dispatch {self.bucket_dispatch!r}")


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
    if cfg.flow == "staged_pruned":
        return attention.aggregate_staged(
            h_proj, scores, nbr_idx, nbr_mask, edge_type, prune_k=cfg.prune_k
        )
    if cfg.flow == "fused":
        raise NotImplementedError(f"flow 'fused' (the scan emulation) {_LATER}")
    # paper §4.3: when the whole padded table fits under K, the retention
    # domain is a no-op and the fused flow IS the plain aggregation
    if cfg.prune_k is not None and cfg.prune_k >= nbr_idx.shape[1]:
        return attention.aggregate_staged(
            h_proj, scores, nbr_idx, nbr_mask, edge_type, prune_k=None
        )
    raise NotImplementedError(
        f"fused_kernel on a flat padded-CSC table runs the flat kernel, which {_LATER}"
    )


def _device_tables(sg: BucketedSemanticGraph, use_ety: bool, device: torch.device):
    """Device mirrors of the bucket tables + concat order + inverse perm,
    cached on the graph per device."""
    key = ("tables", use_ety, device)
    if key not in sg._device:
        def put(a):
            return torch.from_numpy(a).to(device)

        tables = tuple(
            (
                put(b.nbr_idx.astype("int64")),
                put(b.nbr_mask),
                put(b.edge_type.astype("int64")) if use_ety else None,
            )
            for b in sg.buckets
            if b.num_targets > 0
        )
        sg._device[key] = (
            tables,
            put(sg.concat_targets().astype("int64")),
            put(sg.target_perm().astype("int64")),
        )
    return sg._device[key]


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
    if cfg.flow == "fused":
        raise NotImplementedError(f"flow 'fused' (the scan emulation) {_LATER}")
    use_ety = scores.theta_rel is not None
    dev = h_proj.device
    if isinstance(sg, BucketedSemanticGraph):
        DISPATCH["graph_calls"] += 1
        if cfg.bucket_dispatch == "loop":
            raise NotImplementedError(
                f"bucket_dispatch='loop' reaches the flat kernel, which {_LATER}"
            )
        if cfg.flow == "fused_kernel":
            from repro_torch.kernels.fused_prune_aggregate import ops as k_ops

            # the kernel accumulates in f32; cast back so the dispatch
            # never changes the output dtype
            return k_ops.fused_prune_aggregate_grouped(
                h_proj, scores.theta_src, scores.theta_dst, sg,
                theta_rel=scores.theta_rel, prune_k=cfg.prune_k,
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
    return run_aggregate(
        cfg, h_proj, scores,
        torch.from_numpy(sg.nbr_idx.astype("int64")).to(dev),
        torch.from_numpy(sg.nbr_mask).to(dev),
        torch.from_numpy(sg.edge_type.astype("int64")).to(dev) if use_ety else None,
    )
