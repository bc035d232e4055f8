"""Feature Projection (FP) stage: per-type transformation into a shared
(heads, dh) space, emitted as one global table so every semantic graph can
gather from the same tensor (global vertex ids = type-offset + local id)."""
from __future__ import annotations

import math
from typing import Mapping, Tuple

import torch

from repro_torch.core.dtypes import matmul


def glorot_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """In-place Glorot-uniform fill, fan-in the first dim and fan-out the
    product of the rest (the reference's convention, ``(in, out)``
    layout), drawn from ``generator``."""
    fan_in = t.shape[0]
    fan_out = math.prod(t.shape[1:]) if t.dim() > 1 else 1
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-lim, lim, generator=generator)


def project_features(
    params: Mapping[str, torch.Tensor],
    features: Mapping[str, torch.Tensor],
    node_types: Tuple[str, ...],
    heads: int,
    dh: int,
    prefix: str = "",
) -> torch.Tensor:
    """FP for every node type -> (N_total, heads, dh) global table, in
    ``node_types`` (= global id) order. ``params`` holds
    ``<prefix>proj.<type>.w`` (F_t, heads·dh) and ``<prefix>proj.<type>.b``."""
    outs = []
    for t in node_types:
        w, b = params[f"{prefix}proj.{t}.w"], params[f"{prefix}proj.{t}.b"]
        h = matmul(features[t], w) + b
        outs.append(h.reshape(-1, heads, dh))
    return torch.cat(outs, dim=0)
