"""Logical-axis sharding rules (the reference's
``repro/distributed/sharding.py``), resolved against a ``torch.distributed``
device mesh, and the placements that carry them.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dimension
names are the mesh axes (``launch/mesh.py`` builds them); :func:`set_mesh`
makes one ambient for the current context (a ``ContextVar``, so each
thread and task sees its own). Where only the sizes matter (a spec for the
production meshes, with no world at all) a plain ``{axis: size}`` mapping
stands in for it.

Specs. :func:`resolve_spec` turns logical names per dim into a spec, a
tuple with one entry per dim: ``None``, one mesh axis, or a tuple of
axes, entry for entry the reference's ``PartitionSpec``. An axis is
dropped when the dim does not divide it, or when an earlier dim took it.
:func:`param_logical_axes` / :func:`param_sharding_tree` give parameters
and optimizer state their specs from the reference's name patterns,
matched against the reference's '/'-joined tree paths
(``launch/steps.py`` maps the port's flat names onto them).

Placements. A placed tensor is a ``torch.distributed.tensor.DTensor``: a
spec entry naming mesh axes a, b on dim d is ``Shard(d)`` on each of those
mesh dims (:func:`to_placements`), every other mesh dim ``Replicate()``.
:func:`constrain` is the reference's ``with_sharding_constraint``: it
redistributes a DTensor to the resolved spec, and leaves a plain tensor,
or any tensor without a mesh, as it is. The port computes on local tensors
(SPMD written out: ``launch/steps.py``'s sharded step, ``models/lm.py``'s
serving under a mesh), so the reference's ``constrain`` calls inside the
layers, which steer GSPMD's partitioner, have no counterpart; the port
calls it where it holds DTensors: the batch split, the gradient carry and
the cache placement.

The graph axes (``bucket_tiles``, ``targets``, ``ntype_feat``) are what
sharded grouped NA (``core/flows.py``) binds to: when the ambient mesh has
the ``bucket_tiles`` rule axis, :func:`graph_mesh` names it and bucketed NA
under ``fused_kernel`` runs one shard per rank of that axis; with no mesh
every helper here is a no-op and the single-device path runs unchanged.

``torch.distributed`` is imported inside the functions that use it, so
importing this module needs no process group. Every rank of the mesh runs
the same program (SPMD): the same calls in the same order, as
``torch.distributed`` collectives require.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

# logical axis -> preferred mesh axes (in order; several = shard over each)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "ffn": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "moe_group": ("pod", "data"),
    "cache_seq": ("model",),  # decode KV cache: flash-decode seq sharding
    "act_seq": ("model",),  # Megatron-SP residual-stream seq sharding
    "ctx_seq": (),  # encoder/image context length
    "fsdp": ("data",),  # ZeRO-3 param sharding (joined by pod when present)
    "lru": ("model",),
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


def rules() -> Dict[str, Tuple[str, ...]]:
    """The logical -> mesh-axis rules in effect (:func:`axis_rules`)."""
    return _RULES.get()


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


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, in its dim order, or of a
    plain ``{axis: size}`` mapping; ``{}`` for ``None``."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return {str(a): int(n) for a, n in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return {name: int(mesh.size(i)) for i, name in enumerate(names)}


def graph_shard_axis(mesh=None) -> Optional[str]:
    """The mesh axis grouped NA shards over: the first ``bucket_tiles``
    rule axis present in ``mesh`` (the ambient mesh when omitted)."""
    mesh = ambient_mesh() if mesh is None else mesh
    axes = mesh_axes(mesh) if mesh is not None else {}
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
    return mesh_axes(mesh)[axis]


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


# ---------------------------------------------------------------------------
# specs: logical names per dim -> mesh axes per dim
# ---------------------------------------------------------------------------

def _resolve(names: Sequence[Optional[str]], shape: Sequence[int], sizes: Mapping[str, int],
             rules: Mapping[str, Tuple[str, ...]]) -> Tuple:
    """The reference's resolution: per dim, the rule's axes present in the
    mesh, unused by an earlier dim, whose running product divides the dim.
    ``zip`` pairs names with dims, so surplus names are dropped."""
    spec, used = [], set()
    for name, dim in zip(names, shape):
        axes, size = [], 1
        for ax in rules.get(name, ()) if name else ():
            if ax in sizes and ax not in used and dim % (size * sizes[ax]) == 0:
                axes.append(ax)
                size *= sizes[ax]
        used.update(axes)
        spec.append(spec_entry(axes))
    return tuple(spec)


def resolve_spec(names: Sequence[Optional[str]], shape: Sequence[int], mesh=None) -> Optional[Tuple]:
    """Logical names per dim -> a spec against ``mesh`` (a ``DeviceMesh``
    or ``{axis: size}``; the ambient mesh when omitted), or ``None`` with
    no mesh."""
    sizes = mesh_axes(ambient_mesh() if mesh is None else mesh)
    if not sizes:
        return None
    return _resolve(names, shape, sizes, _RULES.get())


def spec_entry(axes: Sequence[str]):
    """One spec entry from the mesh axes that split a dim: ``None``, the
    axis, or their tuple (the reference's ``PartitionSpec`` entry)."""
    return tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, an axis, or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Sequence, mesh) -> list:
    """A spec -> DTensor placements on ``mesh``'s dims: ``Shard(d)`` on the
    mesh dims that dim d's entry names, ``Replicate()`` on the rest. Two
    axes on one dim split it major to minor, so they must come in the
    mesh's dim order; an entry out of that order, an axis the mesh lacks
    or an axis named twice raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh_axes(mesh))
    out = [Replicate() for _ in order]
    seen = set()
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        for ax in axes:
            if ax not in order:
                raise ValueError(f"spec {tuple(spec)}: the mesh {order} has no axis {ax!r}")
            if ax in seen:
                raise ValueError(f"spec {tuple(spec)} names axis {ax!r} twice")
            seen.add(ax)
            out[order.index(ax)] = Shard(d)
        idx = [order.index(ax) for ax in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {tuple(spec)}: dim {d} is split over {axes}, not in the mesh's dim order {order}; "
                "DTensor placements cannot express that layout"
            )
    return out


def spec_of(x) -> Tuple:
    """The spec of a DTensor's placements (a plain tensor's: all ``None``)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return (None,) * x.dim()
    axes = [[] for _ in range(x.dim())]
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(p, Shard):
            axes[p.dim].append(name)
    return tuple(spec_entry(a) for a in axes)


class Sharding(NamedTuple):
    """The port's ``NamedSharding``: a mesh (``DeviceMesh``, or ``{axis:
    size}`` when only the spec is wanted) and a spec."""

    mesh: object
    spec: Tuple

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)


def place(t: torch.Tensor, sharding: Sharding):
    """``t``, the whole value, the same on every rank, as a DTensor placed
    by ``sharding``: each rank keeps its own chunk, with no communication
    (``distribute_tensor`` with ``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor

    mesh = sharding.mesh
    return distribute_tensor(t.to(mesh.device_type), mesh, sharding.placements, src_data_rank=None)


def take_rows(x: torch.Tensor, mesh, entry) -> torch.Tensor:
    """This rank's rows of ``x`` (the whole batch, the same on every rank)
    split over the mesh axes of spec entry ``entry``, major to minor: a
    view, with no communication."""
    for ax in spec_axes(entry):
        x = x.chunk(mesh_axes(mesh)[ax], dim=0)[int(mesh.get_local_rank(ax))]
    return x


def from_rows(t: torch.Tensor, sharding: Sharding):
    """A DTensor placed by ``sharding`` from ``t``, which holds this rank's
    rows of dim 0 (already split as the spec's dim-0 entry says) and every
    other dim whole: each other split dim keeps this rank's chunk, copied
    into storage of its own. No communication."""
    from torch.distributed.tensor import DTensor, Shard

    mesh, placements = sharding.mesh, sharding.placements
    shape = list(t.shape)
    chunked = False
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = int(mesh.size(i))
            if p.dim == 0:
                shape[0] *= n
            else:
                t = t.chunk(n, dim=p.dim)[int(mesh.get_local_rank(i))]
                chunked = chunked or n > 1
    t = t.clone(memory_format=torch.contiguous_format) if chunked else t
    return DTensor.from_local(t, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def shard_batch_dim(x):
    """``x`` with its rows over the batch axes of the ambient mesh: a plain
    tensor (the whole batch, the same on every rank) becomes a DTensor
    holding this rank's rows, a DTensor is redistributed so
    (``constrain(x, "batch", None, …)``); ``x`` as it is with no mesh."""
    names = ["batch"] + [None] * (x.dim() - 1)
    mesh = ambient_mesh()
    if mesh is None or type(x).__name__ == "DTensor":
        return constrain(x, *names)
    spec = resolve_spec(names, x.shape, mesh)
    return from_rows(take_rows(x, mesh, spec[0]), Sharding(mesh, spec))


def constrain(x, *names: Optional[str]):
    """``with_sharding_constraint`` by logical names: a DTensor
    redistributed to the spec resolved against the ambient mesh; ``x`` as
    it is without a mesh, or when it is a plain tensor."""
    from torch.distributed.tensor import DTensor

    mesh = ambient_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = resolve_spec(names, x.shape, mesh)
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


# ---------------------------------------------------------------------------
# parameter specs: name patterns -> logical axes per dim.
# Patterns are searched in the reference's '/'-joined tree path, first match
# wins. `F` marks dims sharded over the fsdp axes when cfg.fsdp.
# ---------------------------------------------------------------------------

_PARAM_PATTERNS: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embed/table", ("vocab", "F")),
    (r"lm_head/w", ("F", "vocab")),
    (r"(attn|cross).*/w[qkv]$", ("F", "heads")),
    (r"(attn|cross).*/wo$", ("heads", "F")),
    (r"(attn|cross).*/b[qkv]$", ("heads",)),
    (r"moe/router/w", (None, "experts")),
    (r"moe/experts/w(i|g)$", ("experts", "F", "ffn")),
    (r"moe/experts/wo$", ("experts", "ffn", "F")),
    (r"mlp/w(i|g)$", ("F", "ffn")),
    (r"mlp/wo$", ("ffn", "F")),
    (r"lru/(wx|wgate)$", ("F", "lru")),
    (r"lru/w_out$", ("lru", "F")),
    (r"lru/(wa|wi)$", (None, "lru")),
    (r"lru/conv_w", (None, "lru")),
    (r"lru/(lam|ba|bi|conv_b)$", ("lru",)),
    (r"rwkv/w[rkvg]$", ("F", "heads")),
    (r"rwkv/wo$", ("heads", "F")),
    (r"rwkv/(wk2)$", ("F", "ffn")),
    (r"rwkv/(wv2)$", ("ffn", "F")),
    (r"rwkv/(wr2)$", ("F", None)),
    (r"rwkv/decay_a$", ("F", None)),
    (r"rwkv/decay_b$", (None, "heads")),
    (r"rwkv/u$", ("heads", None)),
)


def param_logical_axes(path: str, ndim: int, fsdp: bool) -> Tuple:
    """The reference's: the first pattern found in ``path`` gives logical
    axes, right-aligned to ``ndim`` dims (a stacked leaf's layer dim takes
    ``None``); ``F`` is ``fsdp`` when ``fsdp``, else ``None``. A pattern
    longer than ``ndim`` comes back whole (the resolution's ``zip`` drops
    its surplus names: a factored slot of ``embed/table``'s columns,
    (d_model,), resolves as ``vocab``). No match: ``None`` per dim."""
    for pat, axes in _PARAM_PATTERNS:
        if re.search(pat, path):
            full = (None,) * (ndim - len(axes)) + tuple(axes)
            return tuple(("fsdp" if fsdp else None) if a == "F" else a for a in full)
    return (None,) * ndim


def param_sharding_tree(shapes: Mapping[str, Sequence[int]], mesh, fsdp: bool = False) -> Dict[str, Tuple]:
    """``{reference path: shape}`` -> ``{reference path: spec}`` on
    ``mesh`` (a ``DeviceMesh`` or ``{axis: size}``). Unlike
    :func:`resolve_spec`, ``fsdp``, ``batch`` and ``moe_group`` widen to
    ``("pod", "data")`` when the mesh has ``pod``, as the reference's
    does."""
    rules = dict(_RULES.get())
    sizes = mesh_axes(mesh)
    if "pod" in sizes:
        rules.update(fsdp=("pod", "data"), batch=("pod", "data"), moe_group=("pod", "data"))
    return {path: _resolve(param_logical_axes(path, len(shape), fsdp), shape, sizes, rules)
            for path, shape in shapes.items()}


# ---------------------------------------------------------------------------
# data and cache layouts (``launch/steps.py``'s ``data_shardings`` and
# ``cache_shardings``; ``models/lm.py`` places its caches by them)
# ---------------------------------------------------------------------------

def batch_axes(mesh, n: int) -> Tuple[str, ...]:
    """The batch axes of ``mesh`` (``pod`` then ``data``) whose running
    product divides ``n`` rows (the reference's ``_batch_axes``)."""
    sizes = mesh_axes(mesh)
    out, size = [], 1
    for a in ("pod", "data"):
        if a in sizes and n % (size * sizes[a]) == 0:
            out.append(a)
            size *= sizes[a]
    return tuple(out)


def _cache_spec(cfg, shp: Tuple[int, ...], bspec, msize: int) -> Tuple:
    """The reference's spec of a stacked cache leaf ``shp`` = (layers, B,
    ...): a KV cache (layers, B, C, Hkv, hd) its positions over ``model``
    when they divide it at least twice; an RWKV state (layers, B, H, hs,
    hs) its heads over ``model`` when they divide; a (layers, B, width)
    state its width; other leaves their rows only."""
    if len(shp) == 5 and shp[-1] == shp[-2] and shp[-1] <= 256 and shp[2] * shp[-1] == cfg.d_model:
        return (None, bspec, "model" if shp[2] % msize == 0 else None, None, None)
    if len(shp) == 5:
        seq_ok = shp[2] % msize == 0 and shp[2] >= 2 * msize
        return (None, bspec, "model" if seq_ok else None, None, None)
    if len(shp) == 4:
        return (None, bspec, None, None)
    if len(shp) == 3:
        return (None, bspec, "model" if shp[2] % msize == 0 else None)
    return (None,) * len(shp)


def _map_cache(fn, cache):
    """``fn`` over every tensor of a cache (a list of per-layer caches, or
    one), keeping its structure and types."""
    if isinstance(cache, torch.Tensor):
        return fn(cache)
    if isinstance(cache, list):
        return [_map_cache(fn, c) for c in cache]
    return type(cache)(*(_map_cache(fn, part) for part in cache))


def cache_shardings(cfg, batch: int, mesh, cache_shapes):
    """Shardings of a decode cache of ``batch`` rows (the structure of
    ``cache_shapes``, each tensor a :class:`Sharding`): rows over the batch
    axes, long positions (flash-decode style), RWKV heads and recurrent
    widths over ``model``. Each per-layer tensor takes the spec the
    reference gives its stacked leaf, without the layer dim."""
    bspec = spec_entry(batch_axes(mesh, batch))
    msize = mesh_axes(mesh).get("model", 1)
    return _map_cache(lambda t: Sharding(mesh, _cache_spec(cfg, (1,) + tuple(t.shape), bspec, msize)[1:]),
                      cache_shapes)


# ---------------------------------------------------------------------------
# the sharded train step's batch split
# ---------------------------------------------------------------------------

_SPLIT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_batch_split", default=None)


@contextlib.contextmanager
def batch_split(mesh, axes: Sequence[str]):
    """Within the block, each rank computes on its rows of the batch, split
    over ``axes`` of ``mesh`` (``launch/steps.py``'s sharded step):
    :func:`gather` reduces a gathered weight's gradient over those axes and
    :func:`batch_mean` averages over them."""
    token = _SPLIT.set((mesh, tuple(axes)))
    try:
        yield
    finally:
        _SPLIT.reset(token)


def current_split():
    """The current :func:`batch_split`'s (mesh, axes), or ``None``."""
    return _SPLIT.get()


@contextlib.contextmanager
def split_scope(split):
    """Re-enter a :func:`current_split` value (``None`` included): what a
    rematerialized body runs under, wherever autograd recomputes it."""
    token = _SPLIT.set(split)
    try:
        yield
    finally:
        _SPLIT.reset(token)


def gather(x):
    """A DTensor's whole value as a plain tensor (a plain tensor as it
    is). Under :func:`batch_split` its gradient is a sum over the split's
    axes (``Partial``) and the same on every other mesh dim, which the
    backward reduces into ``x``'s own placements. Where no rank of more
    than one splits ``x`` or its gradient (a one-rank mesh) it is the
    local tensor, with no collective."""
    if type(x).__name__ != "DTensor":  # no import on the unsharded paths
        return x
    if whole_here(x):
        return x.to_local()
    from torch.distributed.tensor import Partial, Replicate

    split = _SPLIT.get()
    axes = split[1] if split is not None else ()
    grad = [Partial() if name in axes else Replicate() for name in x.device_mesh.mesh_dim_names]
    return x.full_tensor(grad_placements=grad)


def whole_here(x) -> bool:
    """Whether DTensor ``x``'s local tensor is its whole value and its
    gradient under the current :func:`batch_split` is too: no mesh dim of
    more than one rank splits ``x`` or the batch (a one-rank mesh)."""
    from torch.distributed.tensor import Shard

    split = _SPLIT.get()
    axes = split[1] if split is not None else ()
    mesh = x.device_mesh
    return all(mesh.size(i) == 1 or (not isinstance(p, Shard) and name not in axes)
               for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, x.placements)))


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)``; a DTensor's local shard cast in place of a DTensor
    operation (the same values, without its dispatch)."""
    if type(x).__name__ != "DTensor" or x.dtype == dtype:
        return x.to(dtype)
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local().to(dtype), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def gather_tree(tree):
    """:func:`gather` over the leaves of a nested dict / list."""
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_tree(v) for v in tree]
    return gather(tree)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks of the current :func:`batch_split`
    (an all-reduce whose backward all-reduces the gradient); ``x`` itself
    outside one, or when the split has one rank. A quantity that is not a
    mean over rows (the MoE load-balance loss multiplies two such means)
    is then the whole batch's, as one device computes it."""
    split = _SPLIT.get()
    if split is None:
        return x
    mesh, axes = split
    n = 1
    for ax in axes:
        n *= mesh_axes(mesh)[ax]
    if n == 1:
        return x
    from torch.distributed.nn.functional import all_reduce

    for ax in axes:
        x = all_reduce(x, group=mesh.get_group(ax))
    return x / n
