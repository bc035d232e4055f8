"""Gradient compression for the data-parallel all-reduce (the reference's
``repro/distributed/compression.py``).

int8 block quantization: values are quantized per block of 256 to int8 with
a float32 scale ``max|x| / 127 + 1e-12`` (about 4× fewer bytes), rounding
half to even as both packages' ``round`` does, so the port's blocks are the
reference's bit for bit. Error feedback (a residual carried to the next
step) keeps the compressed stream unbiased over steps. Nothing in the
trainer calls these, in either package.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (q (nblocks, 256) int8, scale (nblocks,) float32),
    zero-padded to whole blocks."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK).to(torch.float32)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    blocks = q.to(torch.float32) * scale[:, None]
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks of ``group`` of each rank's int8-quantized
    ``x``: the reference's exact path, an all-reduce of the dequantized
    per-rank contributions (the scales differ per rank)."""
    q, scale = quantize_int8(x)
    contrib = q.to(torch.float32) * scale[:, None]
    dist.all_reduce(contrib, group=group)
    return contrib.reshape(-1)[: x.numel()].reshape(x.shape).to(x.dtype)


def compress_tree_with_feedback(grads: Mapping[str, torch.Tensor], residual: Mapping[str, torch.Tensor]):
    """Error-feedback compression: g' = Q(g + r); r' = (g + r) - g'.
    Returns (g', r') as name → tensor dicts."""
    sent: Dict[str, torch.Tensor] = {}
    carry: Dict[str, torch.Tensor] = {}
    for n, g in grads.items():
        gc = g.to(torch.float32) + residual[n]
        q, s = quantize_int8(gc)
        deq = dequantize_int8(q, s, g.shape, torch.float32)
        sent[n], carry[n] = deq.to(g.dtype), gc - deq
    return sent, carry


def init_feedback(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}
