"""Public wrappers of the fused prune+aggregate kernels.

:func:`fused_prune_aggregate_grouped` runs NA over every degree bucket of a
``BucketedSemanticGraph`` as ONE launch, :func:`prune_aggregate` (K1 and,
in the same warp, K2's aggregation), then one ``perm`` gather back to
target order. :func:`fused_prune_aggregate_grouped_sharded` runs it split
over the ranks of a device mesh: each rank ONE launch on its own shard of
the graph's ``ShardedBucketLayout`` (:func:`shard_out`), one all-gather,
one ``perm`` gather. :func:`fused_prune_aggregate` runs NA over one flat ``(T,
D)`` padded-CSC table (a flat graph, or one bucket of the per-bucket loop)
as one launch of :func:`flat_prune_aggregate`. The step wrappers of each
pair, K1 :func:`prune` / :func:`flat_prune` and K2 :func:`aggregate` /
:func:`flat_aggregate`, launch the two bodies apart; a fused launch's
output, alpha and ids equal theirs bit for bit. For CUDA tensors the six
step wrappers launch the CUDA kernels of ``csrc/`` (built at first use) or
raise; for CPU tensors they run the plain versions of ``ref.py``. There is
no fallback from one to the other.

Device mirrors of a layout's tile stack and its per-``prune_k`` block table
are cached on the ``GroupedBucketLayout``, keyed by device and ``prune_k``,
so repeated forwards ship no host arrays; their first fill is the build
span ``upload``. ``NA_SLOTS`` holds the launches' slot counts
(``slot_counts``), which ``core/flows.py`` ticks.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.distributed import sharding as dist
from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor as _check
from repro_torch.kernels.common import cuda_device as _cuda_device
from repro_torch.kernels.fused_prune_aggregate import ref

T_TILE = 8  # rows per row block (one thread block of K1)
W_TILE = 8  # candidates per D-tile

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "fused_prune_aggregate.cu",)
MAX_SMEM = 232448  # dynamic shared memory a block can opt into on Hopper
SLOT_BYTES = 12  # a shared-memory domain slot: rank, id, edge type
LIST_BYTES = 256 * 4  # a flat K1 warp's compaction list
# the widest retention domain the CUDA K1s take: one warp's domain in shared
# memory beside its list (up to 256 slots the domain lives in registers)
MAX_KS = (MAX_SMEM - LIST_BYTES) // SLOT_BYTES

MAX_HD = 1024  # the widest H * dh an aggregation takes

# kernel launches, one per launch of each CUDA kernel; the plain versions do
# not count
LAUNCHES = {
    "prune": 0, "aggregate": 0, "flat_prune": 0, "flat_aggregate": 0,
    "prune_aggregate": 0, "flat_prune_aggregate": 0,
}

# launches of the grouped fused kernel made by shard_out, per shard index
SHARD_LAUNCHES: dict = {}

# candidate slots of NA's fused launches, ticked by flows._tick_slots (every
# fused route: grouped, sharded (this rank's shard), flat, per-bucket loop)
# before the launch, so a CPU forward counts too; like LAUNCHES never on a
# replay. slots: what the launch's grid visits (the padded table); valid:
# real candidates; kept: sum of min(degree, prune_k), every candidate
# without pruning; rows: targets; bypass_rows: targets whose candidates all
# fit in prune_k (paper §4.3). NA_SLOTS_BY_GRAPH holds the same per semantic
# graph name.
SLOT_FIELDS = ("slots", "valid", "kept", "rows", "bypass_rows")
NA_SLOTS = dict.fromkeys(SLOT_FIELDS, 0)
NA_SLOTS_BY_GRAPH: dict = {}

_ptr = ctypes.c_void_p
_int = ctypes.c_int


def _ptr_of(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def library():
    """The built kernel library (built with nvcc at first call) and its
    build record (see :func:`repro_torch.kernels.build.load`)."""
    lib, record = build.load("fused_prune_aggregate", SOURCES)
    if not getattr(lib, "_typed", False):
        lib.fpa_grouped_prune.argtypes = [_ptr] * 10 + [_int] * 5 + [ctypes.c_float, _ptr]
        lib.fpa_grouped_prune.restype = _int
        lib.fpa_grouped_aggregate.argtypes = [_ptr] * 5 + [_int] * 5 + [_ptr]
        lib.fpa_grouped_aggregate.restype = _int
        lib.fpa_flat_prune.argtypes = [_ptr] * 8 + [_int] * 4 + [ctypes.c_float, _ptr]
        lib.fpa_flat_prune.restype = _int
        lib.fpa_flat_aggregate.argtypes = [_ptr] * 4 + [_int] * 4 + [_ptr]
        lib.fpa_flat_aggregate.restype = _int
        lib.fpa_grouped_prune_aggregate.argtypes = [_ptr] * 12 + [_int] * 6 + [ctypes.c_float, _ptr]
        lib.fpa_grouped_prune_aggregate.restype = _int
        lib.fpa_flat_prune_aggregate.argtypes = [_ptr] * 10 + [_int] * 5 + [ctypes.c_float, _ptr]
        lib.fpa_flat_prune_aggregate.restype = _int
        lib.fpa_fused_needs_buffers.argtypes = [_int, _int]
        lib.fpa_fused_needs_buffers.restype = _int
        lib.fpa_max_ks.argtypes = []
        lib.fpa_max_ks.restype = _int
        if lib.fpa_max_ks() != MAX_KS:
            raise RuntimeError("kernel library disagrees on MAX_KS")
        lib._typed = True
    return lib, record


def grouped_meta(layout, prune_k: Optional[int]):
    """Per-grid-step metadata and scratch width for a grouped launch (the
    reference's ``ops.grouped_meta``, table for table).

    ``k_eff`` per bucket is ``prune_k`` when the bucket is pruned and the
    w-aligned capacity when it takes the §4.3 bypass (capacity ≤ prune_k,
    or no pruning). ``k_s`` is the max effective K across buckets that
    contribute grid steps. Returns ``(k1_meta, k2_meta, k_s)``: K1 rows are
    (row_block, dt, n_dt, bypass, k_eff) per step; K2 rows are
    (grouped_row, slot) per gather step.
    """
    caps = layout.caps.astype(np.int64)
    caps_pad = layout.caps_pad.astype(np.int64)
    if prune_k is None:
        bypass = np.ones_like(caps)
        k_eff = caps_pad
    else:
        bypass = (caps <= prune_k).astype(np.int64)
        k_eff = np.where(bypass, caps_pad, np.minimum(prune_k, caps_pad))
    present = np.unique(layout.step_bucket)
    k_s = int(k_eff[present].max()) if len(present) else 1
    meta = np.stack(
        [
            layout.step_row,
            layout.step_dt,
            layout.step_ndt,
            bypass[layout.step_bucket],
            k_eff[layout.step_bucket],
        ]
    ).astype(np.int32)
    n_blocks = layout.num_rows // layout.t_tile
    block_bucket = np.zeros(n_blocks, np.int64)
    block_bucket[layout.step_row] = layout.step_bucket
    k_row = np.repeat(k_eff[block_bucket], layout.t_tile)
    starts = np.concatenate([[0], np.cumsum(k_row)[:-1]])
    slots = np.arange(int(k_row.sum())) - np.repeat(starts, k_row)
    agg_meta = np.stack(
        [np.repeat(np.arange(layout.num_rows), k_row), slots]
    ).astype(np.int32)
    return meta, agg_meta, k_s


def block_table(layout, meta: np.ndarray) -> np.ndarray:
    """(4, n_blocks) int32 per row block: first grid step, D-tile count,
    bypass flag, k_eff — the K1 step metadata folded per row block (a
    block's D-tiles are contiguous steps, the first with dt = 0)."""
    n_blocks = layout.num_rows // layout.t_tile
    starts = np.flatnonzero(meta[1] == 0)
    rb = meta[0, starts]
    blk = np.zeros((4, n_blocks), np.int32)
    blk[0, rb] = starts
    blk[1:, rb] = meta[2:, starts]
    return blk


def _layout_device(layout, prune_k: Optional[int], device: torch.device):
    """Device mirrors of the layout's static arrays and of the block table
    for ``prune_k``, cached on the layout; normal tensors even when built
    under ``torch.inference_mode()``."""
    cache = layout._dev
    base_key = ("base", device)
    if base_key not in cache:
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        with torch.inference_mode(False), trace.span("upload", always=True, what="na layout") as sp:
            cache[base_key] = (
                put(layout.nbr.astype(np.int32)),
                put(layout.msk.astype(bool)),
                put(layout.ety.astype(np.int32)),
                put(layout.row_targets.astype(np.int32)),
                put(layout.perm.astype(np.int64)),
            )
            sp.set(bytes=sum(t.nbytes for t in cache[base_key]))
    key = (device, prune_k)
    if key not in cache:
        meta, _, k_s = grouped_meta(layout, prune_k)
        with torch.inference_mode(False), trace.span("upload", always=True, what="na blocks") as sp:
            blk = torch.from_numpy(block_table(layout, meta)).to(device)
            sp.set(bytes=blk.nbytes)
        cache[key] = (blk, k_s)
    return cache[base_key], cache[key]


def slot_counts(degrees: np.ndarray, slots: int, prune_k: Optional[int]) -> dict:
    """``NA_SLOTS``'s fields for one launch's table: ``degrees`` of its
    target rows, ``slots`` the candidate slots its grid visits."""
    deg = np.asarray(degrees, np.int64)
    if prune_k is None:
        kept, bypass = int(deg.sum()), deg.size
    else:
        kept, bypass = int(np.minimum(deg, prune_k).sum()), int((deg <= prune_k).sum())
    return {"slots": int(slots), "valid": int(deg.sum()), "kept": kept, "rows": deg.size,
            "bypass_rows": bypass}


def prune(
    nbr: torch.Tensor,
    msk: torch.Tensor,
    ety: Optional[torch.Tensor],
    theta_src: torch.Tensor,
    theta_rel: Optional[torch.Tensor],
    theta_dst: torch.Tensor,
    row_targets: torch.Tensor,
    blk: torch.Tensor,
    k_s: int,
    slope: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 over a grouped layout -> (alpha (rows, k_s, H) f32, ids (rows,
    k_s) int32). See ``ref.prune_plain`` for the arguments. CUDA tensors
    launch the kernel (``k_s`` at most ``MAX_KS``, 19,285: one warp's
    domain in shared memory, 12 B a slot; above 256 slots a row block's
    warps may be launched as several blocks), or raise ``ValueError``
    before any launch; CPU tensors run the plain version."""
    if theta_src.device.type == "cpu":
        return ref.prune_plain(
            nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, blk,
            k_s, slope,
        )
    dev, ety, n_blocks, t_tile, w, h = _grouped_k1_args(
        nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, blk, k_s
    )
    rows = n_blocks * t_tile
    alpha = torch.empty((rows, k_s, h), dtype=torch.float32, device=dev)
    ids = torch.empty((rows, k_s), dtype=torch.int32, device=dev)
    lib, _ = library()
    err = lib.fpa_grouped_prune(
        _ptr_of(nbr), _ptr_of(msk), _ptr_of(ety), _ptr_of(theta_src), _ptr_of(theta_rel),
        _ptr_of(theta_dst), _ptr_of(row_targets), _ptr_of(blk), _ptr_of(alpha), _ptr_of(ids),
        n_blocks, t_tile, w, h, k_s, slope,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fpa_grouped_prune launch failed: cudaError {err}")
    LAUNCHES["prune"] += 1
    return alpha, ids


def _grouped_k1_args(nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, blk, k_s):
    """The grouped K1's checks, raising before any launch -> (device, ety or
    None without a rel term, n_blocks, t_tile, w, H)."""
    dev = _cuda_device(theta_src)
    g, t_tile, w = nbr.shape
    n, h = theta_src.shape
    n_blocks = blk.shape[1]
    rows = n_blocks * t_tile
    if not 1 <= k_s <= MAX_KS:
        raise ValueError(
            f"k_s={k_s} outside [1, {MAX_KS}] (the CUDA K1's domain width: one warp's "
            "domain in shared memory)"
        )
    if not 1 <= w <= 32:
        raise ValueError(f"tile width w={w} outside [1, 32] (one candidate per lane)")
    if not 1 <= t_tile <= 32:
        raise ValueError(f"t_tile={t_tile} outside [1, 32] (one warp per row)")
    if h < 1:
        raise ValueError("theta_src has no heads")
    i32, f32 = torch.int32, torch.float32
    _check("nbr", nbr, i32, (g, t_tile, w), dev)
    _check("msk", msk, torch.bool, (g, t_tile, w), dev)
    _check("theta_src", theta_src, f32, (n, h), dev)
    _check("theta_dst", theta_dst, f32, (theta_dst.shape[0], h), dev)
    _check("row_targets", row_targets, i32, (rows,), dev)
    _check("blk", blk, i32, (4, n_blocks), dev)
    if theta_rel is not None:
        if ety is None:
            raise ValueError("theta_rel needs the edge-type tiles ety")
        _check("theta_rel", theta_rel, f32, (theta_rel.shape[0], h), dev)
        _check("ety", ety, i32, (g, t_tile, w), dev)
    else:
        ety = None  # the kernel reads edge types only with a rel term
    return dev, ety, n_blocks, t_tile, w, h


def _h_proj_dh(h_proj: torch.Tensor, h: int, dev) -> int:
    """An aggregation's check of h' (N, H, dh) f32, raising before any
    launch -> dh."""
    n, _, dh = h_proj.shape
    if not 1 <= h * dh <= MAX_HD:
        raise ValueError(f"H*dh={h * dh} outside [1, {MAX_HD}] (one thread per output)")
    _check("h_proj", h_proj, torch.float32, (n, h, dh), dev)
    return dh


def aggregate(
    alpha: torch.Tensor,
    ids: torch.Tensor,
    h_proj: torch.Tensor,
    blk: torch.Tensor,
) -> torch.Tensor:
    """K2 over the retained slots -> (rows, H, dh) f32 in grouped-row
    order. See ``ref.aggregate_plain``. CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    if h_proj.device.type == "cpu":
        return ref.aggregate_plain(alpha, ids, h_proj, blk)
    dev = _cuda_device(h_proj)
    rows, k_s, h = alpha.shape
    n_blocks = blk.shape[1]
    if n_blocks == 0 or rows % n_blocks:
        raise ValueError(f"{rows} rows do not split into {n_blocks} row blocks")
    dh = _h_proj_dh(h_proj, h, dev)
    _check("alpha", alpha, torch.float32, (rows, k_s, h), dev)
    _check("ids", ids, torch.int32, (rows, k_s), dev)
    _check("blk", blk, torch.int32, (4, n_blocks), dev)
    out = torch.empty((rows, h, dh), dtype=torch.float32, device=dev)
    lib, _ = library()
    err = lib.fpa_grouped_aggregate(
        alpha.data_ptr(), ids.data_ptr(), h_proj.data_ptr(), blk.data_ptr(),
        out.data_ptr(), n_blocks, rows // n_blocks, h, dh, k_s,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fpa_grouped_aggregate launch failed: cudaError {err}")
    LAUNCHES["aggregate"] += 1
    return out


def prune_aggregate(
    nbr: torch.Tensor,
    msk: torch.Tensor,
    ety: Optional[torch.Tensor],
    theta_src: torch.Tensor,
    theta_rel: Optional[torch.Tensor],
    theta_dst: torch.Tensor,
    row_targets: torch.Tensor,
    blk: torch.Tensor,
    k_s: int,
    h_proj: torch.Tensor,
    slope: float = 0.2,
    keep: bool = False,
):
    """K1 and K2 over a grouped layout in ONE launch: the warp that flushes
    a row aggregates it -> out (rows, H, dh) f32 in grouped-row order, or
    ``(out, alpha, ids)`` with ``keep=True``; bit for bit
    ``aggregate(*prune(...), h_proj, blk)`` and ``prune``'s alpha and ids.
    The checks of :func:`prune` and :func:`aggregate` raise before any
    launch. CUDA tensors launch the fused kernel; CPU tensors run
    ``ref.prune_aggregate_plain``."""
    if theta_src.device.type == "cpu":
        out, alpha, ids = ref.prune_aggregate_plain(
            nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, blk,
            k_s, h_proj, slope,
        )
        return (out, alpha, ids) if keep else out
    dev, ety, n_blocks, t_tile, w, h = _grouped_k1_args(
        nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, blk, k_s
    )
    if n_blocks == 0:
        raise ValueError("0 row blocks: nothing to aggregate")
    rows = n_blocks * t_tile
    dh = _h_proj_dh(h_proj, h, dev)
    lib, _ = library()
    alpha, ids = _fused_buffers(lib, keep, (rows, k_s), h, dev)
    out = torch.empty((rows, h, dh), dtype=torch.float32, device=dev)
    err = lib.fpa_grouped_prune_aggregate(
        _ptr_of(nbr), _ptr_of(msk), _ptr_of(ety), _ptr_of(theta_src), _ptr_of(theta_rel),
        _ptr_of(theta_dst), _ptr_of(row_targets), _ptr_of(blk), _ptr_of(h_proj),
        _ptr_of(alpha), _ptr_of(ids), _ptr_of(out), n_blocks, t_tile, w, h, dh, k_s, slope,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fpa_grouped_prune_aggregate launch failed: cudaError {err}")
    LAUNCHES["prune_aggregate"] += 1
    return (out, alpha, ids) if keep else out


def _fused_buffers(lib, keep: bool, shape, h: int, dev):
    """alpha (*shape, H) and ids (*shape) for a fused launch where the caller
    keeps them or the kernel cannot stage them in shared memory (a domain
    past 256 slots, or a staging too large); else ``(None, None)``."""
    if not keep and not lib.fpa_fused_needs_buffers(shape[-1], h):
        return None, None
    return (
        torch.empty((*shape, h), dtype=torch.float32, device=dev),
        torch.empty(shape, dtype=torch.int32, device=dev),
    )


def fused_prune_aggregate_grouped(
    h_proj: torch.Tensor,  # (N, H, dh) f32
    theta_src: torch.Tensor,  # (N, H)
    theta_dst: torch.Tensor,  # (T, H) — full target range of the graph
    sg,  # BucketedSemanticGraph
    theta_rel: Optional[torch.Tensor] = None,  # (R, H)
    prune_k: Optional[int] = None,
    slope: float = 0.2,
) -> torch.Tensor:
    """NA over ALL buckets of ``sg`` as one fused launch.

    Returns ``(sg.num_targets, H, dh)`` float32 in target order; zeros for
    a graph whose layout has no grid steps.
    """
    layout = sg.grouped(T_TILE, W_TILE)
    n, h, dh = h_proj.shape
    if layout.num_steps == 0:
        return torch.zeros((sg.num_targets, h, dh), dtype=h_proj.dtype, device=h_proj.device)
    (nbr, msk, ety, row_targets, perm), (blk, k_s) = _layout_device(
        layout, prune_k, h_proj.device
    )
    out = prune_aggregate(
        nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, blk, k_s,
        h_proj, slope,
    )
    return out.index_select(0, perm)


def sharded_k_s(sl, prune_k: Optional[int]) -> int:
    """The retention-domain width every shard of ``sl`` launches with: the
    largest ``k_s`` across shards (the reference's rule), which is the
    unsharded layout's, since the shards' buckets together are the
    layout's. A narrower shard's own ``k_s`` could put its domain in
    registers where the single-device launch used shared memory; with one
    width every target runs the single-device arithmetic. Cached on
    ``sl``."""
    key = ("k_s", prune_k)
    if key not in sl._dev:
        sl._dev[key] = max(
            (grouped_meta(sh, prune_k)[2] for sh in sl.shards if sh.num_steps), default=1
        )
    return sl._dev[key]


def shard_out(
    sl,  # ShardedBucketLayout
    s: int,
    h_proj: torch.Tensor,  # (N, H, dh) f32
    theta_src: torch.Tensor,  # (N, H)
    theta_dst: torch.Tensor,  # (T, H) — full target range of the graph
    theta_rel: Optional[torch.Tensor] = None,  # (R, H)
    prune_k: Optional[int] = None,
    slope: float = 0.2,
) -> torch.Tensor:
    """Shard ``s``'s part of sharded NA -> ``(sl.num_rows_alloc, H, dh)``
    float32 in the shard's local row order: ONE fused launch of
    :func:`prune_aggregate` on ``sl.shards[s]`` (θ_*v read through the
    shard's global ``row_targets``, ``k_s`` from :func:`sharded_k_s`), its
    rows padded with zeros to ``num_rows_alloc``. A shard with no grid
    steps launches nothing and gives zeros. ``sl.perm`` reads no pad row,
    so the outputs of every shard, concatenated in shard order and
    gathered by ``sl.perm``, are the single-device NA bit for bit. This is
    what each rank runs under a mesh; called for every ``s`` on one device
    it runs an n-way split without one."""
    lay = sl.shards[s]
    n, h, dh = h_proj.shape
    dev = h_proj.device
    if lay.num_steps == 0:
        return torch.zeros((sl.num_rows_alloc, h, dh), dtype=torch.float32, device=dev)
    (nbr, msk, ety, row_targets, _), (blk, _) = _layout_device(lay, prune_k, dev)
    out = prune_aggregate(
        nbr, msk, ety, theta_src, theta_rel, theta_dst, row_targets, blk,
        sharded_k_s(sl, prune_k), h_proj, slope,
    )
    if dev.type == "cuda":
        SHARD_LAUNCHES[s] = SHARD_LAUNCHES.get(s, 0) + 1
    pad = sl.num_rows_alloc - lay.num_rows
    return torch.cat([out, out.new_zeros((pad, h, dh))]) if pad else out


def _sharded_perm(sl, device: torch.device) -> torch.Tensor:
    """``sl.perm`` as an int64 device tensor, cached on ``sl``."""
    key = ("perm", device)
    if key not in sl._dev:
        with torch.inference_mode(False), trace.span("upload", always=True, what="na perm"):
            sl._dev[key] = torch.from_numpy(sl.perm.astype(np.int64)).to(device)
    return sl._dev[key]


def fused_prune_aggregate_grouped_sharded(
    h_proj: torch.Tensor,  # (N, H, dh) f32, the same on every rank
    theta_src: torch.Tensor,  # (N, H)
    theta_dst: torch.Tensor,  # (T, H) — full target range of the graph
    sg,  # BucketedSemanticGraph
    mesh,  # torch.distributed DeviceMesh
    axis: str,  # the mesh axis to split over (the bucket_tiles rule axis)
    theta_rel: Optional[torch.Tensor] = None,  # (R, H)
    prune_k: Optional[int] = None,
    slope: float = 0.2,
) -> torch.Tensor:
    """NA over ALL buckets of ``sg``, split across the ranks of ``mesh``'s
    ``axis``: rank r runs ONE fused launch on shard r of
    ``sg.sharded(n)`` (:func:`shard_out`); the per-shard outputs are
    all-gathered ONCE over the axis's process group, and one gather by
    the global ``perm`` restores target order. θ_u* and h' are the full
    tables on every rank (NA reads any source id); each rank reads only
    its own targets' θ_*v rows. Bit for bit the single-device launch.
    Returns ``(sg.num_targets, H, dh)`` float32 on every rank. Every rank
    must make the same call: the all-gather is a collective."""
    n_sh = dist.axis_size(mesh, axis)
    sl = sg.sharded(n_sh, T_TILE, W_TILE)
    n, h, dh = h_proj.shape
    if sl.num_steps_max == 0:
        return torch.zeros((sg.num_targets, h, dh), dtype=torch.float32, device=h_proj.device)
    local = shard_out(
        sl, dist.shard_rank(mesh, axis), h_proj, theta_src, theta_dst,
        theta_rel=theta_rel, prune_k=prune_k, slope=slope,
    )
    full = dist.replicate(local, mesh, axis)
    return full.index_select(0, _sharded_perm(sl, h_proj.device))


def flat_prune(
    nbr: torch.Tensor,
    msk: torch.Tensor,
    ety: Optional[torch.Tensor],
    theta_src: torch.Tensor,
    theta_rel: Optional[torch.Tensor],
    theta_dst: torch.Tensor,
    k: int,
    slope: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat K1 over a (T, D) table -> (alpha (T, k, H) f32, ids (T, k)
    int32). See ``ref.flat_prune_plain`` for the arguments. CUDA tensors
    launch the kernel (``k`` at most ``MAX_KS``, 19,285: one warp's domain
    in shared memory, 12 B a slot, beside its 1 KB compaction list), or
    raise ``ValueError`` before any launch; CPU tensors run the plain
    version."""
    if theta_src.device.type == "cpu":
        return ref.flat_prune_plain(
            nbr, msk, ety, theta_src, theta_rel, theta_dst, k, slope
        )
    dev, ety, t, d, h = _flat_k1_args(nbr, msk, ety, theta_src, theta_rel, theta_dst, k)
    alpha = torch.empty((t, k, h), dtype=torch.float32, device=dev)
    ids = torch.empty((t, k), dtype=torch.int32, device=dev)
    if t == 0:
        return alpha, ids
    lib, _ = library()
    err = lib.fpa_flat_prune(
        _ptr_of(nbr), _ptr_of(msk), _ptr_of(ety), _ptr_of(theta_src), _ptr_of(theta_rel),
        _ptr_of(theta_dst), _ptr_of(alpha), _ptr_of(ids), t, d, h, k, slope,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fpa_flat_prune launch failed: cudaError {err}")
    LAUNCHES["flat_prune"] += 1
    return alpha, ids


def _flat_k1_args(nbr, msk, ety, theta_src, theta_rel, theta_dst, k):
    """The flat K1's checks, raising before any launch -> (device, ety or
    None without a rel term, T, D, H)."""
    dev = _cuda_device(theta_src)
    t, d = nbr.shape
    n, h = theta_src.shape
    if not 1 <= k <= MAX_KS:
        raise ValueError(
            f"k={k} outside [1, {MAX_KS}] (the CUDA K1's domain width: one warp's "
            "domain in shared memory)"
        )
    if h < 1:
        raise ValueError("theta_src has no heads")
    i32, f32 = torch.int32, torch.float32
    _check("nbr", nbr, i32, (t, d), dev)
    _check("msk", msk, torch.bool, (t, d), dev)
    _check("theta_src", theta_src, f32, (n, h), dev)
    _check("theta_dst", theta_dst, f32, (t, h), dev)
    if theta_rel is not None:
        if ety is None:
            raise ValueError("theta_rel needs the edge types ety")
        _check("theta_rel", theta_rel, f32, (theta_rel.shape[0], h), dev)
        _check("ety", ety, i32, (t, d), dev)
    else:
        ety = None  # the kernel reads edge types only with a rel term
    return dev, ety, t, d, h


def flat_aggregate(
    alpha: torch.Tensor,
    ids: torch.Tensor,
    h_proj: torch.Tensor,
) -> torch.Tensor:
    """Flat K2 -> (T, H, dh) f32. See ``ref.flat_aggregate_plain``. CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    if h_proj.device.type == "cpu":
        return ref.flat_aggregate_plain(alpha, ids, h_proj)
    dev = _cuda_device(h_proj)
    t, k, h = alpha.shape
    dh = _h_proj_dh(h_proj, h, dev)
    _check("alpha", alpha, torch.float32, (t, k, h), dev)
    _check("ids", ids, torch.int32, (t, k), dev)
    out = torch.empty((t, h, dh), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    lib, _ = library()
    err = lib.fpa_flat_aggregate(
        alpha.data_ptr(), ids.data_ptr(), h_proj.data_ptr(), out.data_ptr(),
        t, h, dh, k, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fpa_flat_aggregate launch failed: cudaError {err}")
    LAUNCHES["flat_aggregate"] += 1
    return out


def flat_prune_aggregate(
    nbr: torch.Tensor,
    msk: torch.Tensor,
    ety: Optional[torch.Tensor],
    theta_src: torch.Tensor,
    theta_rel: Optional[torch.Tensor],
    theta_dst: torch.Tensor,
    h_proj: torch.Tensor,
    k: int,
    slope: float = 0.2,
    keep: bool = False,
):
    """Flat K1 and K2 over a (T, D) table in ONE launch: the warp that
    flushes a row aggregates it -> out (T, H, dh) f32, or ``(out, alpha,
    ids)`` with ``keep=True``; bit for bit ``flat_aggregate(*flat_prune(...),
    h_proj)`` and ``flat_prune``'s alpha and ids. The checks of
    :func:`flat_prune` and :func:`flat_aggregate` raise before any launch.
    CUDA tensors launch the fused kernel; CPU tensors run
    ``ref.flat_prune_aggregate_plain``."""
    if theta_src.device.type == "cpu":
        out, alpha, ids = ref.flat_prune_aggregate_plain(
            nbr, msk, ety, theta_src, theta_rel, theta_dst, h_proj, k, slope
        )
        return (out, alpha, ids) if keep else out
    dev, ety, t, d, h = _flat_k1_args(nbr, msk, ety, theta_src, theta_rel, theta_dst, k)
    dh = _h_proj_dh(h_proj, h, dev)
    out = torch.empty((t, h, dh), dtype=torch.float32, device=dev)
    if t == 0:
        empty = (torch.empty((0, k, h), dtype=torch.float32, device=dev),
                 torch.empty((0, k), dtype=torch.int32, device=dev))
        return (out, *empty) if keep else out
    lib, _ = library()
    alpha, ids = _fused_buffers(lib, keep, (t, k), h, dev)
    err = lib.fpa_flat_prune_aggregate(
        _ptr_of(nbr), _ptr_of(msk), _ptr_of(ety), _ptr_of(theta_src), _ptr_of(theta_rel),
        _ptr_of(theta_dst), _ptr_of(h_proj), _ptr_of(alpha), _ptr_of(ids), _ptr_of(out),
        t, d, h, dh, k, slope, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fpa_flat_prune_aggregate launch failed: cudaError {err}")
    LAUNCHES["flat_prune_aggregate"] += 1
    return (out, alpha, ids) if keep else out


def fused_prune_aggregate(
    h_proj: torch.Tensor,  # (N, H, dh) f32
    theta_src: torch.Tensor,  # (N, H)
    theta_dst: torch.Tensor,  # (T, H)
    nbr_idx: torch.Tensor,  # (T, D) global ids
    nbr_mask: torch.Tensor,  # (T, D) bool
    theta_rel: Optional[torch.Tensor] = None,  # (R, H)
    edge_type: Optional[torch.Tensor] = None,  # (T, D)
    prune_k: Optional[int] = None,
    slope: float = 0.2,
) -> torch.Tensor:
    """NA over one flat padded-CSC table with a k-slot retention domain,
    k = min(prune_k, D) (k = D without pruning) -> (T, H, dh) float32, as
    one fused launch.

    The rel term enters only with both ``theta_rel`` and ``edge_type``, as
    in the reference's wrapper. A table with no rows launches nothing.
    """
    t, d = nbr_idx.shape
    k = d if prune_k is None else min(int(prune_k), d)
    if k < 1:
        raise ValueError(f"prune_k={prune_k} leaves no retention slot")
    use_rel = theta_rel is not None and edge_type is not None
    return flat_prune_aggregate(
        nbr_idx.to(torch.int32).contiguous(), nbr_mask.to(torch.bool).contiguous(),
        edge_type.to(torch.int32).contiguous() if use_rel else None,
        theta_src.contiguous(), theta_rel.contiguous() if use_rel else None,
        theta_dst.contiguous(), h_proj.contiguous(), k, slope,
    )
