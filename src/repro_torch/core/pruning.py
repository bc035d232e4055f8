"""Runtime neighbor pruning: the paper's Algorithm 1 as ``lax.top_k``
merges, ported from the reference's ``core/pruning.py``.

  * :func:`topk_keep_mask` — the one-shot top-K keep-mask of the
    ``staged_pruned`` flow;
  * :func:`streaming_topk` — the online retention domain: neighbors stream
    in tiles, and each tile is merged into the domain with ``top_k`` over
    ``[domain, tile]`` (the reference's semantic model of the Pruner);
  * :func:`keep_mask_from_ids` and :func:`streaming_keep_mask` — the keep
    mask from retained ids, and from the streaming domain.

The tie rule here is ``jax.lax.top_k``'s (:func:`kernels.common.top_k_order`):
floats in total order (-0.0 below +0.0, NaN above +inf and -NaN below
-inf), the lower slot index first among equal scores. The domain comes
before the tile in each merge, so an incumbent beats an equal newcomer and
the streaming domain keeps the one-shot ``top_k`` set.

The kernels do NOT use this rule: their retention domain evicts the first
minimum slot and inserts only on a strictly greater score (see
``kernels/common.py``), which can keep a different set when scores tie.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import NEG, masked_scores, top_k_order


def topk_keep_mask(scores: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Keep-mask: True for the k largest *valid* scores per row.

    scores: (T, D) float; mask: (T, D) bool. Ties go to the lower slot
    index. A row with fewer than k valid neighbors keeps all of them.
    """
    t, d = scores.shape
    if k >= d:
        return mask
    idx = top_k_order(masked_scores(scores, mask), k)
    keep = torch.zeros((t, d), dtype=torch.bool, device=scores.device)
    keep.scatter_(1, idx, True)
    return keep & mask


def streaming_topk(
    scores: torch.Tensor, mask: torch.Tensor, k: int, tile: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online retention domain -> (top-k scores in ``top_k`` order, slot ids
    int32), -1 where the score is at or below ``NEG / 2`` (empty or
    padding slots)."""
    t, d = scores.shape
    pad = (-d) % tile
    s = masked_scores(scores, mask)
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=NEG)
    ids = torch.arange(s.shape[1], dtype=torch.int32, device=s.device)
    rd_s = torch.full((t, k), NEG, dtype=s.dtype, device=s.device)
    rd_i = torch.full((t, k), -1, dtype=torch.int32, device=s.device)
    for c in range(0, s.shape[1], tile):
        cat_s = torch.cat([rd_s, s[:, c:c + tile]], dim=1)
        cat_i = torch.cat([rd_i, ids[c:c + tile].expand(t, -1)], dim=1)
        sel = top_k_order(cat_s, k)
        rd_s, rd_i = cat_s.gather(1, sel), cat_i.gather(1, sel)
    rd_i = torch.where(rd_s <= NEG / 2, -1, rd_i)
    return rd_s, rd_i


def keep_mask_from_ids(ids: torch.Tensor, d: int) -> torch.Tensor:
    """(T, k) retained slot ids (-1 = empty) -> (T, D) keep mask."""
    t, _ = ids.shape
    # empty slots write column d, which is dropped
    col = torch.where(ids >= 0, ids.long(), d)
    keep = torch.zeros((t, d + 1), dtype=torch.bool, device=ids.device)
    keep.scatter_(1, col, True)
    return keep[:, :d]


def streaming_keep_mask(
    scores: torch.Tensor, mask: torch.Tensor, k: int, tile: int = 128
) -> torch.Tensor:
    if k >= scores.shape[1]:
        return mask
    _, ids = streaming_topk(scores, mask, k, tile)
    return keep_mask_from_ids(ids, scores.shape[1])
