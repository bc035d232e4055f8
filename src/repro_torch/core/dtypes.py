"""The dtype a product of mixed operands computes in: JAX's promotion in
its default mode (64-bit types off), which the reference computes in.

A float32 table against a bfloat16 or float16 weight computes in float32,
two bfloat16 operands stay bfloat16, bfloat16 against float16 gives
float32, and float64 computes as float32 (JAX canonicalizes it). PyTorch's
elementwise operators already promote the same way for the 16- and 32-bit
float types; its matmuls refuse mixed operands, so the HGNN path runs its
products through :func:`matmul` and :func:`einsum`. ``HGNNModel.apply``
canonicalizes float64 parameters once, as JAX does at its boundary.
"""
from __future__ import annotations

import functools

import torch


def canonical(t: torch.Tensor) -> torch.Tensor:
    """``t`` as JAX holds it with 64-bit types off: float64 as float32."""
    return t.float() if t.dtype == torch.float64 else t


def result_type(*ts: torch.Tensor) -> torch.dtype:
    """``jnp.result_type`` of the operands, 64-bit types off."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return torch.float32 if dt == torch.float64 else dt


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the operands' promoted dtype."""
    dt = result_type(a, b)
    return a.to(dt) @ b.to(dt)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the operands' promoted dtype."""
    dt = result_type(*ops)
    return torch.einsum(eq, *(o.to(dt) for o in ops))
