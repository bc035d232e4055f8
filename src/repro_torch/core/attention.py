"""Decomposed additive attention and staged Neighbor Aggregation (NA).

The paper's Eq. 2: θ_uv = LeakyReLU(θ_u* + θ_*v), with per-vertex scalars
computed once per semantic graph by two thin contractions. Ranking the
neighbors of one target needs only θ_u* (plus a per-edge-type term where a
model has one), so pruned neighbors never have their importance computed —
what the fused kernel exploits.

``aggregate_staged`` is the traditional-platform flow: it materializes the
(T, D, H) scores and the (T, D, H, dh) gathered features. With ``prune_k``
a separate selection pass shrinks the mask first (``staged_pruned``, and
``fused``: the reference's scan emulation keeps the same neighbor set).
The fused kernel pairs live in ``repro_torch.kernels.fused_prune_aggregate``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import pruning
from repro_torch.core.dtypes import einsum

LEAKY_SLOPE = 0.2


class DecomposedScores(NamedTuple):
    theta_src: torch.Tensor  # (N, H) — θ_u* for every vertex as a source
    theta_dst: torch.Tensor  # (T, H) — θ_*v for every target
    theta_rel: Optional[torch.Tensor] = None  # (R, H) per-edge-type term


def decompose_scores(
    h_proj: torch.Tensor,  # (N, H, dh) projected features, global table
    a_src: torch.Tensor,  # (H, dh)
    a_dst: torch.Tensor,  # (H, dh)
    dst_slice: slice | None = None,
    rel_emb: Optional[torch.Tensor] = None,  # (R, H, dr)
    a_rel: Optional[torch.Tensor] = None,  # (H, dr)
) -> DecomposedScores:
    """Eq. 2: per-vertex attention coefficients, computed once and reused;
    with ``rel_emb`` and ``a_rel`` also the per-edge-type term θ_rel
    (Simple-HGN). The tables come back contiguous, as the NA kernels take
    them."""
    theta_src = einsum("nhd,hd->nh", h_proj, a_src).contiguous()
    h_dst = h_proj[dst_slice] if dst_slice is not None else h_proj
    theta_dst = einsum("nhd,hd->nh", h_dst, a_dst).contiguous()
    theta_rel = None
    if rel_emb is not None and a_rel is not None:
        theta_rel = einsum("rhd,hd->rh", rel_emb, a_rel).contiguous()
    return DecomposedScores(theta_src, theta_dst, theta_rel)


def slice_targets(scores: DecomposedScores, targets: torch.Tensor) -> DecomposedScores:
    """Restrict θ_*v to the rows ``targets`` (one gather); θ_u* is a global
    per-source table and stays whole."""
    return DecomposedScores(
        scores.theta_src, scores.theta_dst[targets].contiguous(), scores.theta_rel
    )


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an integer index tensor of any shape, through
    ``index_select``: the same values, and a backward that adds each
    gradient row with an atomic add (``index_add_``). Advanced indexing's
    backward sorts the ids and has one warp walk all duplicates of an id
    in turn; every padding slot of an SGB table holds id 0 and an edge
    type repeats across a whole table, so on an H100 that walk took 99 %
    of a training step (ACM at scale 1.0)."""
    return table.index_select(0, idx.reshape(-1)).view(*idx.shape, *table.shape[1:])


def _edge_scores(
    scores: DecomposedScores,
    nbr_idx: torch.Tensor,  # (T, D) global ids
    edge_type: Optional[torch.Tensor],  # (T, D) or None
) -> torch.Tensor:
    """Per-edge θ_u* (+ rel term), (T, D, H)."""
    th = _rows(scores.theta_src, nbr_idx)
    if scores.theta_rel is not None and edge_type is not None:
        th = th + _rows(scores.theta_rel, edge_type.long())
    return th


def aggregate_staged(
    h_proj: torch.Tensor,  # (N, H, dh)
    scores: DecomposedScores,
    nbr_idx: torch.Tensor,  # (T, D) int
    nbr_mask: torch.Tensor,  # (T, D) bool
    edge_type: Optional[torch.Tensor] = None,
    prune_k: Optional[int] = None,
    slope: float = LEAKY_SLOPE,
) -> torch.Tensor:
    """Staged NA -> (T, H, dh). The pruner's ranking scalar is the head-sum
    of θ_u* (+ rel): LeakyReLU is monotone and θ_*v is shared by all
    in-edges of v, so it orders neighbors as the true importance does."""
    nbr_idx = nbr_idx.long()
    mask = nbr_mask
    th = _edge_scores(scores, nbr_idx, edge_type)  # (T, D, H)
    if prune_k is not None and prune_k < nbr_idx.shape[1]:
        mask = pruning.topk_keep_mask(th.sum(dim=-1), mask, prune_k)
    theta = F.leaky_relu(th + scores.theta_dst[:, None, :], slope)
    theta = torch.where(mask[..., None], theta, torch.full_like(theta, pruning.NEG))
    alpha = torch.softmax(theta, dim=1)
    alpha = torch.where(mask[..., None], alpha, torch.zeros_like(alpha))
    feats = _rows(h_proj, nbr_idx)  # (T, D, H, dh)
    return einsum("tdh,tdhf->thf", alpha, feats)

