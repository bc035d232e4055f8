"""Plain PyTorch versions of the Pruner.

  * :func:`topk_select_ref` is the reference's oracle (``ref.py`` of the
    reference's ``kernels/topk_select``): ``lax.top_k`` over the masked
    scores, values in ``top_k`` order, ids -1 where the value is at or
    below ``NEG / 2``; k larger than D raises ``ValueError``.
  * :func:`topk_select_plain` is the rule of the reference's Pallas kernel
    and of the CUDA kernel in ``csrc/``: each row's D columns stream in
    order through a k-slot domain that starts at ``NEG`` / -1, one
    ``min_replace`` step each (the FIRST minimum slot evicted, a candidate
    inserted only when STRICTLY greater; ``kernels/common.py``); at the
    flush the ids of slots at or below ``NEG / 2`` become -1. Output is in
    domain-slot order. Values are copied, never computed, so the kernel's
    equal these bit for bit.

The two keep different slots when scores tie: for [1, 1, 2] at k = 2 the
kernel rule gives ids [2, 1] and ``top_k`` gives [2, 0]. For k > D the
kernel rule returns the valid scores in arrival order, then ``NEG`` / -1.

The wrapper in ``ops.py`` uses these for CPU tensors (and
:func:`topk_select_ref` for ``use_kernel=False``); ``chip_smoke.py`` holds
the kernel against :func:`topk_select_plain` on the card. They take
tensors of any device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import NEG, masked_scores, min_replace, top_k_order


def topk_select_ref(
    scores: torch.Tensor, mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, D) scores + mask -> (values (T, k) float32 in ``top_k`` order,
    slot ids (T, k) int32, -1 = empty)."""
    s = masked_scores(scores, mask)
    idx = top_k_order(s, k)
    vals = s.gather(1, idx)
    return vals, torch.where(vals <= NEG / 2, -1, idx.to(torch.int32))


def topk_select_plain(
    scores: torch.Tensor, mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, D) scores + mask -> (values (T, k) float32, slot ids (T, k)
    int32, -1 = empty), in domain-slot order, by the kernel's rule."""
    s = masked_scores(scores, mask)
    t, d = s.shape
    rd_s = torch.full((t, k), NEG, dtype=torch.float32, device=s.device)
    rd_i = torch.full((t, k), -1, dtype=torch.int32, device=s.device)
    for j in range(d):
        cur_id = torch.full((t,), j, dtype=torch.int32, device=s.device)
        rd_s, (rd_i,) = min_replace(rd_s, [(rd_i, cur_id)], s[:, j])
    return rd_s, torch.where(rd_s <= NEG / 2, -1, rd_i)
