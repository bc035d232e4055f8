"""Semantic Fusion (SF) stage."""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.core.dtypes import einsum, matmul


def semantic_beta(params: Mapping[str, torch.Tensor], zs: torch.Tensor) -> torch.Tensor:
    """HAN's per-metapath attention weights β (P,) from zs (P, T, dim).

    w_p = mean_v qᵀ tanh(W z_p,v + b);  β = softmax_p(w_p).
    """
    e = matmul(torch.tanh(matmul(zs, params["sem.w"]) + params["sem.b"]), params["sem.q"])
    return torch.softmax(e.mean(dim=1), dim=0)


def fuse_with_beta(beta: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """Fuse per-metapath embeddings zs (P, T, dim) with fixed β (P,)."""
    return einsum("p,ptd->td", beta, zs)


def semantic_attention(params: Mapping[str, torch.Tensor], zs: torch.Tensor) -> torch.Tensor:
    """HAN's SF: zs (P, T, dim) per-metapath embeddings -> (T, dim)."""
    return fuse_with_beta(semantic_beta(params, zs), zs)
