"""The retention-domain rule shared by the kernels and their plain
versions, and the checks their wrappers make before a launch.

One step of the paper's Algorithm 1 (lines 14-22), as the reference's TPU
kernels run it (``repro/kernels/common.py``): find the FIRST minimum slot
of the retention domain; replace it only if the candidate is STRICTLY
greater. An incumbent therefore survives a tie with a newcomer, and among
equal incumbents the lowest slot is evicted first. This is not
``lax.top_k``'s rule (lower index wins): for scores ``[1, 1, 2]`` at k=2 the
kernel keeps slots {1, 2} and ``top_k`` keeps {0, 2}. :func:`top_k_order`
is ``top_k``'s order, for the plain versions and flows that follow it.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

NEG = -3.0e38  # below any real score
POS = 3.0e38  # above any real score: parks retention slots past a row's
# effective K so min_replace never selects them


def min_replace(
    rd_vals: torch.Tensor,
    rd_aux: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    cur_val: torch.Tensor,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One retention-domain step, vectorized over rows.

    ``rd_vals`` (rows, K); ``cur_val`` (rows,). ``rd_aux`` pairs each side
    array (rows, K, ...) of the domain with its candidate value
    (rows, ...). Returns the updated values and side arrays.
    """
    k = rd_vals.shape[-1]
    m = rd_vals.amin(dim=-1, keepdim=True)
    iota = torch.arange(k, device=rd_vals.device)
    first = torch.where(rd_vals == m, iota, k).amin(dim=-1, keepdim=True)
    repl = (iota == first) & (cur_val[:, None] > m)
    new_vals = torch.where(repl, cur_val[:, None], rd_vals)
    new_aux = []
    for aux, cur in rd_aux:
        r = repl.reshape(repl.shape + (1,) * (aux.dim() - repl.dim()))
        new_aux.append(torch.where(r, cur[:, None], aux))
    return new_vals, new_aux


def masked_scores(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``scores`` as float32 where ``mask`` is nonzero, ``NEG`` elsewhere:
    what every pruner ranks."""
    s = scores.to(torch.float32)
    return torch.where(mask != 0, s, torch.full_like(s, NEG))


def top_k_order(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The indices ``jax.lax.top_k(scores, k)`` returns along the last axis.

    ``top_k`` orders float32 values totally, -NaN < -inf < … < -0.0 < +0.0
    < … < +inf < +NaN, and puts the lower index first among equal values.
    A float sort does neither (it ties -0.0 with +0.0 and leaves NaN's place
    open), so the sort here is a stable descending sort of the int32 key
    ``b ^ ((b >> 31) & 0x7fffffff)`` of the float's bits ``b``, which is
    monotone in that total order. ``k`` larger than the axis raises
    ``ValueError``, as ``top_k`` does.
    """
    d = scores.shape[-1]
    if not 0 <= k <= d:
        raise ValueError(f"top_k needs 0 <= k <= {d} along the last axis, got k={k}")
    b = scores.to(torch.float32).contiguous().view(torch.int32)
    key = b ^ ((b >> 31) & 0x7FFFFFFF)
    return torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel wrapper checks before a launch."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# the dry-run's cost counters (``launch/dryrun.py``): each is called with
# (kernel, FLOPs, bytes) for a launch a wrapper stood in for on fake tensors
COST_SINKS: List = []


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (``FakeTensorMode``'s: a shape, a
    dtype and a device, no data), as the dry-run runs a step on."""
    from torch._subclasses.fake_tensor import is_fake as fake

    return fake(t)


def fake_launch(kernel: str, flops: int, nbytes: int) -> None:
    """A kernel's launch on fake CUDA tensors, which its wrapper does not
    make: its FLOPs and bytes (those of the kernel's bound in ``PERF.md``:
    each input byte read once, each output byte written once) handed to
    the dry-run's counters. The launch counters do not move."""
    for sink in COST_SINKS:
        sink(kernel, int(flops), int(nbytes))


def cuda_device(t: torch.Tensor) -> torch.device:
    """``t``'s device, which must be a CUDA device: the kernels run on CUDA
    tensors, their plain versions on CPU tensors."""
    if t.device.type != "cuda":
        raise ValueError(
            f"tensors on {t.device}: the kernels run on CUDA tensors, the "
            "plain versions on CPU tensors"
        )
    return t.device
