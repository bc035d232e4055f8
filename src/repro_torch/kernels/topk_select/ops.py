"""Public wrapper of the Pruner kernel.

:func:`topk_select` keeps, per row of (T, D) masked scores, a k-slot
retention domain and returns its values and slot ids. For CUDA tensors it
launches the CUDA kernel of ``csrc/`` (built at first use) or raises; for
CPU tensors it runs the plain version of ``ref.py``. There is no fallback
from one to the other. ``use_kernel=False`` runs the ``top_k`` oracle
instead, on any device, as the reference's wrapper does. On fake CUDA
tensors (the dry-run) it launches nothing: empty outputs, and the launch's
FLOPs and bytes handed to ``common.fake_launch``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor, cuda_device, fake_launch, is_fake
from repro_torch.kernels.topk_select import ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "topk_select.cu",)
MAX_SMEM = 232448  # dynamic shared memory a block can opt into on Hopper
SLOT_BYTES = 8  # a domain slot: a float32 value and an int32 slot id

# kernel launches, one per launch of the CUDA kernel; the plain versions do
# not count
LAUNCHES = {"topk_select": 0}

_ptr = ctypes.c_void_p
_int = ctypes.c_int


def library():
    """The built kernel library (built with nvcc at first call) and its
    build record (see :func:`repro_torch.kernels.build.load`)."""
    lib, record = build.load("topk_select", SOURCES)
    if not getattr(lib, "_typed", False):
        lib.ts_topk_select.argtypes = [_ptr] * 4 + [_int] * 3 + [_ptr]
        lib.ts_topk_select.restype = _int
        lib.ts_max_k.argtypes = []
        lib.ts_max_k.restype = _int
        if lib.ts_max_k() != max_k():
            raise RuntimeError("kernel library disagrees on the shared-memory budget")
        lib._typed = True
    return lib, record


def max_k() -> int:
    """The widest retention domain one block holds in dynamic shared memory
    (``SLOT_BYTES`` a slot within ``MAX_SMEM``)."""
    return MAX_SMEM // SLOT_BYTES


def topk_select(
    scores: torch.Tensor,  # (T, D), cast to float32
    mask: torch.Tensor,  # (T, D), valid where nonzero
    k: int,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, D) scores + validity mask -> (values (T, k) float32, slot ids
    (T, k) int32, -1 = empty) of each row's retention domain, in domain-slot
    order (see ``ref.topk_select_plain``). ``use_kernel=False`` gives
    ``ref.topk_select_ref`` (``top_k`` order) instead."""
    if tuple(mask.shape) != tuple(scores.shape) or scores.dim() != 2:
        raise ValueError(f"scores {tuple(scores.shape)} and mask {tuple(mask.shape)} must be one (T, D) shape")
    scores, mask = scores.to(torch.float32), mask != 0
    if not use_kernel:
        return ref.topk_select_ref(scores, mask, k)
    t, d = scores.shape
    if t == 0 or d == 0:
        raise ValueError(f"scores of shape {(t, d)} have no slot to select from")
    if not 1 <= k <= max_k():
        raise ValueError(f"k={k} outside [1, {max_k()}] (the slots one block holds in shared memory)")
    if scores.device.type == "cpu":
        return ref.topk_select_plain(scores, mask, k)
    dev = cuda_device(scores)
    scores, mask = scores.contiguous(), mask.contiguous()
    check_tensor("mask", mask, torch.bool, (t, d), dev)
    vals = torch.empty((t, k), dtype=torch.float32, device=dev)
    ids = torch.empty((t, k), dtype=torch.int32, device=dev)
    if is_fake(scores):  # the dry-run: no launch, empty outputs
        fake_launch("topk_select", t * d, t * d * 5 + t * k * 8)
        return vals, ids
    lib, _ = library()
    err = lib.ts_topk_select(
        scores.data_ptr(), mask.data_ptr(), vals.data_ptr(), ids.data_ptr(), t, d, k,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ts_topk_select launch failed: cudaError {err}")
    LAUNCHES["topk_select"] += 1
    return vals, ids
