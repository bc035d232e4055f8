"""The graph axes of the reference's logical-axis rules, resolved against
an ambient ``torch.distributed`` device mesh.

The port's copy of the part of ``repro/distributed/sharding.py`` that the
sharded grouped-NA inference path (``core/flows.py``) binds to. A mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` whose dimension names are
the mesh axes; :func:`set_mesh` makes one ambient for the current context
(a ``ContextVar``, so each thread and task sees its own). When the ambient
mesh has the ``bucket_tiles`` rule axis, :func:`graph_mesh` names it and
bucketed NA under ``fused_kernel`` runs one shard per rank of that axis;
with no mesh every helper here is a no-op and the single-device path runs
unchanged.

``torch.distributed`` is imported inside the functions that use it, so
importing this module needs no process group. Every rank of the mesh runs
the same program (SPMD): the same graph, the same params, the same calls
in the same order, as ``torch.distributed`` collectives require.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple

import torch

# logical axis -> preferred mesh axes, for the graph axes only (the LM
# axes of the reference's table wait for its LM sharding, ROADMAP LM-8)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # bucket_tiles: the shard axis of a ShardedBucketLayout's grouped tile
    # stack, the axis grouped NA splits over
    "bucket_tiles": ("data",),
    # targets: the target-vertex axis of NA outputs and logits. Replicated:
    # semantic fusion's mean over all targets must see the same operands in
    # the same order on every rank for bit-exact parity with one device
    "targets": (),
    # ntype_feat: per-node-type feature tables. Replicated: NA gathers
    # arbitrary global source ids, so every shard needs the full table
    "ntype_feat": (),
}

_RULES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_axis_rules", default=DEFAULT_RULES
)
_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def axis_rules(overrides: Dict[str, Tuple[str, ...]]):
    """Override logical -> mesh-axis rules within the block."""
    token = _RULES.set({**_RULES.get(), **overrides})
    try:
        yield
    finally:
        _RULES.reset(token)


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, or ``None`` for no mesh) ambient
    within the block, for this context only."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def ambient_mesh():
    """The ambient ``DeviceMesh``, or ``None``."""
    return _MESH.get()


def _axes_of(mesh) -> Dict[str, int]:
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return {name: int(mesh.size(i)) for i, name in enumerate(names)}


def graph_shard_axis(mesh=None) -> Optional[str]:
    """The mesh axis grouped NA shards over: the first ``bucket_tiles``
    rule axis present in ``mesh`` (the ambient mesh when omitted)."""
    mesh = ambient_mesh() if mesh is None else mesh
    axes = _axes_of(mesh) if mesh is not None else {}
    for ax in _RULES.get().get("bucket_tiles", ()):
        if ax in axes:
            return ax
    return None


def graph_mesh():
    """``(mesh, axis_name, n_shards)`` for sharded grouped NA, or ``None``
    when no mesh with a ``bucket_tiles`` rule axis is ambient."""
    mesh = ambient_mesh()
    if mesh is None:
        return None
    ax = graph_shard_axis(mesh)
    if ax is None:
        return None
    return mesh, ax, axis_size(mesh, ax)


def axis_size(mesh, axis: str) -> int:
    """How many ranks ``mesh`` has along ``axis``: the split count."""
    return _axes_of(mesh)[axis]


def shard_rank(mesh, axis: str) -> int:
    """This process's coordinate on ``mesh``'s ``axis``: the shard it runs."""
    return int(mesh.get_local_rank(axis))


def replicate(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sharded NA path's single all-gather: every rank's ``x`` (equal
    shapes) concatenated along dim 0 in rank order of ``mesh``'s
    ``axis``, on every rank. A CUDA graph capture records it like any
    other launch."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    # torch 2.13 renamed all_gather_into_tensor (which now warns); older
    # releases have only the old name
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=group)
    return out
