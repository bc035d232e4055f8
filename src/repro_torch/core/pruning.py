"""The one-shot top-K keep-mask of the ``staged_pruned`` flow.

The tie rule here is ``jax.lax.top_k``'s, as in the reference's
``core/pruning.py``: among equal scores the lower slot index wins. A stable
descending sort gives that order; ``torch.topk`` does not promise it.

The fused kernel path does NOT use this rule: its retention domain evicts
the first minimum slot and inserts only on a strictly greater score (see
``kernels/common.py``), which can keep a different set when scores tie.
"""
from __future__ import annotations

import torch

NEG = -3.0e38  # sentinel below any real score


def topk_keep_mask(scores: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Keep-mask: True for the k largest *valid* scores per row.

    scores: (T, D) float; mask: (T, D) bool. Ties go to the lower slot
    index. A row with fewer than k valid neighbors keeps all of them.
    """
    t, d = scores.shape
    if k >= d:
        return mask
    s = torch.where(mask, scores, torch.full_like(scores, NEG))
    idx = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    keep = torch.zeros((t, d), dtype=torch.bool, device=scores.device)
    keep.scatter_(1, idx, True)
    return keep & mask
