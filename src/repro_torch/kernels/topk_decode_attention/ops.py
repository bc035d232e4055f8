"""Public wrappers of the top-K decode attention kernel pair.

:func:`topk_decode_attention` is ADE-pruned decode attention: K1
:func:`score_prune` (logits, retention domain, softmax) then K2
:func:`value_gather` (α · V of the retained rows). For CUDA tensors the two
step wrappers launch the CUDA kernels of ``csrc/`` (built at first use) or
raise; for CPU tensors they run the plain versions of ``ref.py``. There is
no fallback from one to the other. ``prune_k=None`` gives the dense
attention instead, on any device (what pruning is measured against).

On fake CUDA tensors (``FakeTensorMode``: the dry-run, ``launch/dryrun.py``)
a step wrapper launches nothing: it returns empty outputs of the kernel's
shapes and dtypes and hands the launch's FLOPs and bytes to
``common.fake_launch``; the launch counters stay as they were.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor, cuda_device, fake_launch, is_fake
from repro_torch.kernels.topk_decode_attention import ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "topk_decode_attention.cu",)
MAX_SMEM = 232448  # dynamic shared memory a block can opt into on Hopper
DTYPES = (torch.float32, torch.bfloat16)  # what q and the cache may hold
MAX_GROUP = 32  # q-heads a kv-head may serve in K1 (its tie mask has a bit each)

# kernel launches, one per launch of each CUDA kernel; the plain versions do
# not count
LAUNCHES = {"score_prune": 0, "value_gather": 0}
# the same launches by (kernel, cache rows S): a decode step prunes caches of
# several widths (the self cache, a context)
LAUNCHES_BY_WIDTH: dict = {}

_ptr = ctypes.c_void_p
_int = ctypes.c_int


def library():
    """The built kernel library (built with nvcc at first call) and its
    build record (see :func:`repro_torch.kernels.build.load`)."""
    lib, record = build.load("topk_decode_attention", SOURCES)
    if not getattr(lib, "_typed", False):
        lib.tda_score_prune.argtypes = [_ptr] * 7 + [_int] * 6 + [ctypes.c_float, _int, _ptr]
        lib.tda_score_prune.restype = _int
        lib.tda_value_gather.argtypes = [_ptr] * 4 + [_int] * 7 + [_ptr]
        lib.tda_value_gather.restype = _int
        lib.tda_max_k.argtypes = [_int, _int]
        lib.tda_max_k.restype = _int
        if lib.tda_max_k(2, 256) != max_k(2, 256):
            raise RuntimeError("kernel library disagrees on the shared-memory budget")
        lib._typed = True
    return lib, record


def max_k(group: int, dh: int) -> int:
    """The widest retention domain K1's tie path holds in shared memory:
    the group's q (4·group·dh B) and a value and a position per slot and
    q-head (8·group B a slot) within ``MAX_SMEM``."""
    return max(0, (MAX_SMEM - 4 * group * dh) // (8 * group))


def _shapes(q, k_cache):
    b, h, dh = q.shape
    _, s, hkv, dh_k = k_cache.shape
    if dh_k != dh or k_cache.shape[0] != b:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache {tuple(k_cache.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} q-heads do not split over {hkv} kv-heads")
    return b, h, hkv, s, dh


def score_prune(
    q: torch.Tensor,  # (B, H, dh) float32 or bfloat16
    k_cache: torch.Tensor,  # (B, S, Hkv, dh), q's dtype
    lengths: torch.Tensor,  # (B,) int32
    k: int,
    scale: float,
    tie_rows: bool = False,
):
    """K1 -> (alpha (B, H, k) float32, retained positions (B, H, k) int32,
    −1 = empty), in the canonical layout of ``ref.score_prune_plain``.
    With ``tie_rows=True`` also a (B, H) int32 tensor, 1 where the row took
    K1's tie path (``ref.tie_rows_plain``). CUDA tensors launch the kernel;
    CPU tensors run the plain version."""
    if q.device.type == "cpu":
        logits = ref.score_logits_plain(q, k_cache, scale)
        alpha, ids = ref.prune_logits_plain(logits, lengths, k)
        return (alpha, ids, ref.tie_rows_plain(logits, lengths, k)) if tie_rows else (alpha, ids)
    dev = cuda_device(q)
    b, h, hkv, s, dh = _shapes(q, k_cache)
    group = h // hkv
    if not 1 <= k <= s:
        raise ValueError(f"k={k} outside [1, S={s}]")
    if group > MAX_GROUP:
        raise ValueError(f"{group} q-heads a kv-head; K1 serves at most {MAX_GROUP}")
    if k > max_k(group, dh):
        raise ValueError(
            f"k={k} exceeds the {max_k(group, dh)} retention slots K1 holds in shared "
            f"memory for group {group}, dh {dh}"
        )
    if q.dtype not in DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel reads {DTYPES}")
    check_tensor("q", q, q.dtype, (b, h, dh), dev)
    check_tensor("k_cache", k_cache, q.dtype, (b, s, hkv, dh), dev)
    check_tensor("lengths", lengths, torch.int32, (b,), dev)
    alpha = torch.empty((b, h, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, h, k), dtype=torch.int32, device=dev)
    tie = torch.empty((b, h), dtype=torch.int32, device=dev)
    if is_fake(q):  # the dry-run: no launch; every position valid, as a fake cache's lengths are unknown
        el = q.element_size()
        fake_launch("score_prune", 2 * b * s * h * dh + alpha.numel() * 6,
                    k_cache.numel() * el + q.numel() * el + b * 4 + (alpha.numel() + ids.numel()) * 4)
        return (alpha, ids, tie) if tie_rows else (alpha, ids)
    logits = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    lib, _ = library()
    err = lib.tda_score_prune(
        q.data_ptr(), k_cache.data_ptr(), lengths.data_ptr(), logits.data_ptr(),
        alpha.data_ptr(), ids.data_ptr(), tie.data_ptr(), b, h, hkv, s, dh, k, scale,
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"tda_score_prune launch failed: cudaError {err}")
    LAUNCHES["score_prune"] += 1
    LAUNCHES_BY_WIDTH["score_prune", s] = LAUNCHES_BY_WIDTH.get(("score_prune", s), 0) + 1
    return (alpha, ids, tie) if tie_rows else (alpha, ids)


def value_gather(alpha: torch.Tensor, ids: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """K2 -> (B, H, dh) float32. See ``ref.value_gather_plain``. CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    if v_cache.device.type == "cpu":
        return ref.value_gather_plain(alpha, ids, v_cache)
    dev = cuda_device(v_cache)
    b, h, k = alpha.shape
    _, s, hkv, dh = v_cache.shape
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} q-heads do not split over {hkv} kv-heads")
    if not 1 <= dh <= 1024:
        raise ValueError(f"dh={dh} outside [1, 1024] (at most 32 dims a lane)")
    if v_cache.dtype not in DTYPES:
        raise TypeError(f"v_cache has dtype {v_cache.dtype}; the kernel reads {DTYPES}")
    check_tensor("alpha", alpha, torch.float32, (b, h, k), dev)
    check_tensor("ids", ids, torch.int32, (b, h, k), dev)
    check_tensor("v_cache", v_cache, v_cache.dtype, (b, s, hkv, dh), dev)
    out = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    if is_fake(v_cache):  # the dry-run: no launch; the most V rows K2 can read, min(S, group·K) a kv-head
        rows = b * hkv * min(s, (h // hkv) * k)
        fake_launch("value_gather", 2 * b * h * k * dh,
                    rows * dh * v_cache.element_size() + (alpha.numel() + ids.numel() + out.numel()) * 4)
        return out
    lib, _ = library()
    err = lib.tda_value_gather(
        alpha.data_ptr(), ids.data_ptr(), v_cache.data_ptr(), out.data_ptr(), b, h, hkv, s,
        dh, k, int(v_cache.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"tda_value_gather launch failed: cudaError {err}")
    LAUNCHES["value_gather"] += 1
    LAUNCHES_BY_WIDTH["value_gather", s] = LAUNCHES_BY_WIDTH.get(("value_gather", s), 0) + 1
    return out


def topk_decode_attention(
    q: torch.Tensor,  # (B, H, dh)
    k_cache: torch.Tensor,  # (B, S, Hkv, dh)
    v_cache: torch.Tensor,  # (B, S, Hkv, dh)
    lengths: torch.Tensor,  # (B,) valid prefix lengths
    prune_k: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over the valid cache prefix with a retention domain
    of k = min(prune_k, S) slots per (batch, q-head) -> (B, H, dh) float32.
    ``prune_k=None`` is the dense attention."""
    dh, s = q.shape[-1], k_cache.shape[1]
    scale = dh ** -0.5 if scale is None else float(scale)
    if prune_k is None:
        return ref.full_decode_attention(q, k_cache, v_cache, lengths, scale)
    k = min(int(prune_k), s)
    if k < 1:
        raise ValueError(f"prune_k={prune_k} leaves no retention slot")
    alpha, ids = score_prune(
        q.contiguous(), k_cache.contiguous(), lengths.to(torch.int32).contiguous(), k, scale
    )
    return value_gather(alpha, ids, v_cache.contiguous())
