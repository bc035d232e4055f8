"""Heterogeneous graph containers and Semantic Graph Build (SGB), numpy only.

The port's copy of ``repro/core/hetgraph.py`` for the metapath (HAN),
relation (RGAT) and union (Simple-HGN) builds: the same vectorized builds
give bit-identical tables for the same graph and seed. A semantic graph is
stored as padded-CSC (per target, a fixed-width row of global source ids
plus a validity mask), either flat
(:class:`SemanticGraph`, one ``(T, D_max)`` table) or degree-bucketed
(:class:`BucketedSemanticGraph`): targets partitioned by degree into buckets
of capacity e.g. ``{8, 32, 128, D_max}``, so padded NA slots follow the
degree histogram, and buckets with capacity ≤ K bypass the pruner (§4.3).
``bucket_sizes="auto"`` picks each graph's capacities from its own degree
histogram (:func:`autotune_bucket_sizes`).

:meth:`BucketedSemanticGraph.grouped` re-tiles every bucket into one
grid-ordered stack of ``(t_tile, w)`` tiles (a :class:`GroupedBucketLayout`),
which the fused prune+aggregate kernel pair walks in one launch each.
:meth:`BucketedSemanticGraph.sharded` splits that stack by whole row blocks
across the ranks of a device mesh (a :class:`ShardedBucketLayout`), one
launch per shard.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import trace

Relation = Tuple[str, str, str]  # (src_type, rel_name, dst_type)

AnySemanticGraph = Union["SemanticGraph", "BucketedSemanticGraph"]

# Default degree-bucket capacities (the final bucket stretches to D_max).
DEFAULT_BUCKET_SIZES: Tuple[int, ...] = (8, 32, 128)


@dataclasses.dataclass
class HetGraph:
    """An in-memory heterogeneous graph.

    ``edges[rel]`` is ``(src_ids, dst_ids)`` with ids local to their node
    type. ``features[t]`` is an ``(N_t, F_t)`` float array. ``labels`` lives
    on ``label_type`` vertices.
    """

    node_types: Tuple[str, ...]
    num_nodes: Dict[str, int]
    features: Dict[str, np.ndarray]
    relations: Tuple[Relation, ...]
    edges: Dict[str, Tuple[np.ndarray, np.ndarray]]  # rel_name -> (src, dst)
    label_type: str
    labels: np.ndarray
    num_classes: int

    def rel(self, name: str) -> Relation:
        for r in self.relations:
            if r[1] == name:
                return r
        raise KeyError(name)

    def validate(self) -> "HetGraph":
        """Schema validation: edge ids against ``num_nodes``, feature/label
        row counts, relation-name uniqueness, endpoint types. Collects every
        violation and raises one ``ValueError``; returns ``self``."""
        errs: List[str] = []
        types = set(self.node_types)
        if len(types) != len(self.node_types):
            errs.append(f"duplicate node types in {self.node_types}")
        for t in self.node_types:
            if t not in self.num_nodes:
                errs.append(f"node type {t!r} missing from num_nodes")
            elif self.num_nodes[t] <= 0:
                errs.append(f"node type {t!r} has {self.num_nodes[t]} nodes")
            f = self.features.get(t)
            if f is None:
                errs.append(f"node type {t!r} has no feature table")
            elif f.ndim != 2 or f.shape[0] != self.num_nodes.get(t, -1):
                errs.append(
                    f"features[{t!r}] shape {f.shape} != "
                    f"({self.num_nodes.get(t)}, F)"
                )
        names = [r[1] for r in self.relations]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            errs.append(f"duplicate relation names {dup}")
        for (src_t, name, dst_t) in self.relations:
            if src_t not in types or dst_t not in types:
                errs.append(
                    f"relation {name!r} endpoints ({src_t!r}, {dst_t!r}) not "
                    f"in node types {sorted(types)}"
                )
                continue
            if name not in self.edges:
                errs.append(f"relation {name!r} has no edge list")
                continue
            src, dst = self.edges[name]
            if len(src) != len(dst):
                errs.append(
                    f"relation {name!r}: src/dst length mismatch "
                    f"({len(src)} vs {len(dst)})"
                )
            for ids, t, side in ((src, src_t, "src"), (dst, dst_t, "dst")):
                if len(ids) == 0:
                    continue
                lo, hi = int(np.min(ids)), int(np.max(ids))
                if lo < 0 or hi >= self.num_nodes.get(t, 0):
                    errs.append(
                        f"relation {name!r} {side} ids [{lo}, {hi}] out of "
                        f"range for {t!r} (num_nodes={self.num_nodes.get(t)})"
                    )
        if self.label_type not in types:
            errs.append(f"label_type {self.label_type!r} not a node type")
        elif self.labels.shape[0] != self.num_nodes.get(self.label_type, -1):
            errs.append(
                f"labels rows {self.labels.shape[0]} != num_nodes"
                f"[{self.label_type!r}] = {self.num_nodes.get(self.label_type)}"
            )
        if self.labels.size and (
            int(self.labels.min()) < 0
            or int(self.labels.max()) >= self.num_classes
        ):
            errs.append(
                f"labels range [{int(self.labels.min())}, "
                f"{int(self.labels.max())}] outside [0, {self.num_classes})"
            )
        if errs:
            raise ValueError(
                "HetGraph validation failed:\n  - " + "\n  - ".join(errs)
            )
        return self

    def validate_delta(self, edges: Dict[str, Tuple[np.ndarray, np.ndarray]]) -> None:
        """Validate an appended edge batch ``{rel_name: (src, dst)}`` in
        O(batch), not O(graph): known relation name, a (src, dst) pair of
        1-D integer arrays of equal length, ids inside the endpoint types'
        ranges. Collects every violation and raises one ``ValueError``, as
        :meth:`validate` does (the streaming ingest path, ``stream/``)."""
        errs: List[str] = []
        known = {r[1]: r for r in self.relations}
        for name, pair in edges.items():
            rel = known.get(name)
            if rel is None:
                errs.append(f"delta relation {name!r} not in graph relations {sorted(known)}")
                continue
            if not (isinstance(pair, tuple) and len(pair) == 2):
                errs.append(f"delta[{name!r}] is not a (src, dst) pair")
                continue
            src, dst = (np.asarray(a) for a in pair)
            if len(src) != len(dst):
                errs.append(f"delta[{name!r}]: src/dst length mismatch ({len(src)} vs {len(dst)})")
            src_t, _, dst_t = rel
            for ids, t, side in ((src, src_t, "src"), (dst, dst_t, "dst")):
                if ids.ndim != 1:
                    errs.append(f"delta[{name!r}] {side} ids must be 1-D, got shape {ids.shape}")
                    continue
                if not np.issubdtype(ids.dtype, np.integer):
                    errs.append(f"delta[{name!r}] {side} ids dtype {ids.dtype} is not an integer type")
                    continue
                if ids.size == 0:
                    continue
                lo, hi = int(ids.min()), int(ids.max())
                if lo < 0 or hi >= self.num_nodes.get(t, 0):
                    errs.append(
                        f"delta[{name!r}] {side} ids [{lo}, {hi}] out of range for "
                        f"{t!r} (num_nodes={self.num_nodes.get(t)})"
                    )
        if errs:
            raise ValueError("HetGraph delta validation failed:\n  - " + "\n  - ".join(errs))

    @property
    def total_nodes(self) -> int:
        return sum(self.num_nodes[t] for t in self.node_types)

    def type_offsets(self) -> Dict[str, int]:
        """Global-id offsets: node types concatenated in ``node_types`` order."""
        off, out = 0, {}
        for t in self.node_types:
            out[t] = off
            off += self.num_nodes[t]
        return out


@dataclasses.dataclass
class SemanticGraph:
    """A single semantic graph in flat padded-CSC form.

    ``nbr_idx[v, j]`` is the *global* id of the j-th in-neighbor of target
    ``v``. Invalid slots are masked by ``nbr_mask`` and point at index 0.
    ``edge_type`` is all-zeros for single-relation graphs. ``_device``
    caches device mirrors of the table, and the slot counts of its NA
    launches (``flows._tick_slots``).
    """

    name: str
    src_types: Tuple[str, ...]
    dst_type: str
    nbr_idx: np.ndarray  # (T, D) int32, GLOBAL source ids
    nbr_mask: np.ndarray  # (T, D) bool
    edge_type: np.ndarray  # (T, D) int32
    num_edge_types: int = 1
    _device: Dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    @property
    def num_targets(self) -> int:
        return self.nbr_idx.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbr_idx.shape[1]

    @property
    def num_edges(self) -> int:
        return int(self.nbr_mask.sum())

    def degrees(self) -> np.ndarray:
        return self.nbr_mask.sum(axis=1)

    def padded_slots(self) -> int:
        """Total NA slots the flat layout pays for (T × D_max)."""
        return int(self.nbr_idx.size)


@dataclasses.dataclass
class DegreeBucket:
    """One degree bucket: the targets whose degree fits this capacity (and
    no tighter one). Rows are left-packed."""

    targets: np.ndarray  # (T_b,) int32 local target ids
    nbr_idx: np.ndarray  # (T_b, D_b) int32 GLOBAL source ids
    nbr_mask: np.ndarray  # (T_b, D_b) bool
    edge_type: np.ndarray  # (T_b, D_b) int32

    @property
    def capacity(self) -> int:
        return self.nbr_idx.shape[1]

    @property
    def num_targets(self) -> int:
        return self.targets.shape[0]


@dataclasses.dataclass
class GroupedBucketLayout:
    """All buckets flattened into one grid-ordered tile stack.

    Rows of each bucket are padded to a multiple of ``t_tile`` and
    capacities to a multiple of ``w``; every ``(t_tile, w)`` tile is stored
    bucket-major, row-tile next, D-tile innermost, so one row block's D-tiles
    are contiguous steps. ``perm`` maps each target to its padded grouped
    row. Arrays are numpy; the kernel wrapper caches device mirrors in
    ``_dev``.
    """

    t_tile: int
    w: int
    nbr: np.ndarray  # (G, t_tile, w) int32 grid-ordered neighbor-id tiles
    msk: np.ndarray  # (G, t_tile, w) bool
    ety: np.ndarray  # (G, t_tile, w) int32
    step_row: np.ndarray  # (G,) int32 — row block of step g
    step_dt: np.ndarray  # (G,) int32 — D-tile index within the row block
    step_ndt: np.ndarray  # (G,) int32 — total D-tiles of step g's bucket
    step_bucket: np.ndarray  # (G,) int32 — owning bucket of step g
    caps: np.ndarray  # (B,) int32 true bucket capacities
    caps_pad: np.ndarray  # (B,) int32 w-aligned capacities
    row_targets: np.ndarray  # (num_rows,) int32 target id per row (0 on pad)
    perm: np.ndarray  # (num_targets,) int32 grouped row of each target
    num_rows: int  # total padded rows across buckets
    _dev: Dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    @property
    def num_steps(self) -> int:
        return self.nbr.shape[0]


def _group_buckets(
    buckets: Sequence[DegreeBucket],
    num_targets: int,
    t_tile: int,
    w: int,
) -> GroupedBucketLayout:
    """Re-tile per-bucket padded-CSC tables into grid order. Pure relayout:
    every valid slot keeps its (target, slot-position) identity; padding
    rows/columns are mask-False."""
    tiles_n, tiles_m, tiles_e = [], [], []
    step_row, step_dt, step_ndt, step_bucket = [], [], [], []
    caps, caps_pad, row_targets = [], [], []
    perm = np.zeros(num_targets, dtype=np.int32)
    row_off = 0  # in units of rows
    for bi, b in enumerate(buckets):
        t_b, d_b = b.nbr_idx.shape
        caps.append(d_b)
        cap_p = max(-(-d_b // w) * w, w)
        caps_pad.append(cap_p)
        if t_b == 0:
            continue
        rows_p = -(-t_b // t_tile) * t_tile
        n_dt = cap_p // w
        n_rt = rows_p // t_tile

        for a, fill, dtype, acc in (
            (b.nbr_idx, 0, np.int32, tiles_n),
            (b.nbr_mask, False, bool, tiles_m),
            (b.edge_type, 0, np.int32, tiles_e),
        ):
            p = np.full((rows_p, cap_p), fill, dtype=dtype)
            p[:t_b, :d_b] = a
            # (n_rt, t_tile, n_dt, w) -> grid order (row tile, then D tile)
            p = p.reshape(n_rt, t_tile, n_dt, w).transpose(0, 2, 1, 3)
            acc.append(p.reshape(n_rt * n_dt, t_tile, w))
        rb0 = row_off // t_tile
        step_row.append(np.repeat(np.arange(rb0, rb0 + n_rt), n_dt))
        step_dt.append(np.tile(np.arange(n_dt), n_rt))
        step_ndt.append(np.full(n_rt * n_dt, n_dt))
        step_bucket.append(np.full(n_rt * n_dt, bi))
        rt = np.zeros(rows_p, dtype=np.int32)
        rt[:t_b] = b.targets
        row_targets.append(rt)
        perm[b.targets] = row_off + np.arange(t_b, dtype=np.int32)
        row_off += rows_p

    def cat(parts, dtype):
        if not parts:
            return np.zeros((0,), dtype=dtype)
        return np.concatenate(parts).astype(dtype)

    def stack(parts, dtype):
        if not parts:
            return np.zeros((0, t_tile, w), dtype)
        return np.concatenate(parts)

    return GroupedBucketLayout(
        t_tile=t_tile,
        w=w,
        nbr=stack(tiles_n, np.int32),
        msk=stack(tiles_m, bool),
        ety=stack(tiles_e, np.int32),
        step_row=cat(step_row, np.int32),
        step_dt=cat(step_dt, np.int32),
        step_ndt=cat(step_ndt, np.int32),
        step_bucket=cat(step_bucket, np.int32),
        caps=np.asarray(caps, np.int32),
        caps_pad=np.asarray(caps_pad, np.int32),
        row_targets=cat(row_targets, np.int32),
        perm=perm,
        num_rows=row_off,
    )


@dataclasses.dataclass
class ShardedBucketLayout:
    """A :class:`GroupedBucketLayout` partitioned by target row blocks
    across ``n_shards`` devices (the ``("data",)`` mesh axis); the
    reference's, array for array.

    The unit of assignment is the row block (one ``t_tile`` slab of one
    bucket's targets): a block's grid steps are contiguous in the grouped
    stack (bucket-major, row-tile next, D-tile innermost), so moving whole
    blocks keeps every per-shard stack a valid grid in its own right —
    ``shards[s]`` is a plain :class:`GroupedBucketLayout` the grouped
    ragged-grid kernel can run unchanged. Blocks are assigned by longest-
    processing-time greedy on their D-tile counts, so per-shard *padded
    slot* totals (the grouped NA cost model) are balanced within one
    block's worth of slots.

    Per-shard layouts keep the bucket-local step metadata verbatim
    (``step_dt``/``step_ndt``/``step_bucket``; ``caps`` are shared) and
    renumber only ``step_row``; ``row_targets`` keeps GLOBAL target ids so
    each shard's θ_*v gather stays local to the shard. A per-shard
    ``perm`` maps owned targets to shard-local rows (-1 for targets owned
    by other shards); the stacked global inverse permutation ``perm`` maps
    every target to ``shard * num_rows_alloc + local_row`` in the
    shard-concatenated NA output, so target order is restored with one
    gather after a single all-gather of the per-shard outputs.

    ``num_rows_alloc`` pads every shard's output to the same row count and
    reserves one trailing pad block per shard: the all-gather takes equal
    row counts from every rank. A shard's rows past its own ``num_rows``
    (the pad block among them) hold zeros that no target's ``perm`` entry
    reads. The reference also aims its shorter shards' filler grid steps
    at the pad block (its SPMD program needs equal grid lengths); a CUDA
    launch per shard needs no filler.
    """

    n_shards: int
    t_tile: int
    w: int
    shards: Tuple[GroupedBucketLayout, ...]
    perm: np.ndarray  # (T,) int32: shard * num_rows_alloc + local row
    num_rows_alloc: int  # per-shard padded output rows (incl. pad block)
    num_steps_max: int  # max real grid steps across shards
    _dev: Dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    @property
    def pad_block(self) -> int:
        """Row-block index every shard's filler grid steps write to."""
        return self.num_rows_alloc // self.t_tile - 1

    def padded_slots(self) -> np.ndarray:
        """Per-shard padded NA slots (the load-balance metric): every grid
        step covers one ``(t_tile, w)`` tile."""
        return np.asarray(
            [s.num_steps * self.t_tile * self.w for s in self.shards], np.int64
        )

    def balance(self) -> float:
        """max/mean of per-shard padded slots (1.0 = perfectly balanced)."""
        slots = self.padded_slots()
        mean = slots.mean()
        return float(slots.max() / mean) if mean > 0 else 1.0


def shard_layout(layout: GroupedBucketLayout, n_shards: int) -> ShardedBucketLayout:
    """Split a grouped tile stack into ``n_shards`` per-shard layouts.

    Row blocks (and their contiguous grid-step runs) are assigned whole;
    assignment is longest-processing-time greedy on per-block D-tile counts
    with deterministic ties (block index, then shard index), balancing
    per-shard padded-slot totals. Within a shard, blocks keep their
    original stack order, so per-target insertion order — and therefore the
    kernel's bit pattern — is unchanged.
    """
    t_tile, w = layout.t_tile, layout.w
    n_blocks = layout.num_rows // t_tile if layout.num_rows else 0
    num_targets = layout.perm.shape[0]
    if n_blocks == 0:
        empty = GroupedBucketLayout(
            t_tile=t_tile, w=w,
            nbr=np.zeros((0, t_tile, w), np.int32),
            msk=np.zeros((0, t_tile, w), bool),
            ety=np.zeros((0, t_tile, w), np.int32),
            step_row=np.zeros(0, np.int32), step_dt=np.zeros(0, np.int32),
            step_ndt=np.zeros(0, np.int32), step_bucket=np.zeros(0, np.int32),
            caps=layout.caps.copy(), caps_pad=layout.caps_pad.copy(),
            row_targets=np.zeros(0, np.int32),
            perm=np.full(num_targets, -1, np.int32), num_rows=0,
        )
        return ShardedBucketLayout(
            n_shards=n_shards, t_tile=t_tile, w=w,
            shards=tuple(empty for _ in range(n_shards)),
            perm=np.zeros(num_targets, np.int32),
            num_rows_alloc=t_tile, num_steps_max=0,
        )
    # per-block step runs: step_row is nondecreasing and visits every block
    blocks, first_step = np.unique(layout.step_row, return_index=True)
    if blocks.shape[0] != n_blocks:
        raise ValueError("grouped stack has gaps in step_row")
    blk_ndt = layout.step_ndt[first_step].astype(np.int64)
    # LPT greedy: heaviest blocks first into the least-loaded shard
    order = np.lexsort((np.arange(n_blocks), -blk_ndt))
    load = np.zeros(n_shards, np.int64)
    owner = np.zeros(n_blocks, np.int64)
    for b in order:
        s = int(np.argmin(load))  # first minimum: deterministic ties
        owner[b] = s
        load[s] += blk_ndt[b]
    row_targets_blk = layout.row_targets.reshape(n_blocks, t_tile)
    shards = []
    local_block = np.zeros(n_blocks, np.int64)
    for s in range(n_shards):
        mine = np.flatnonzero(owner == s)  # ascending: original stack order
        local_block[mine] = np.arange(mine.size)
        steps = (
            np.concatenate(
                [np.arange(first_step[b], first_step[b] + blk_ndt[b]) for b in mine]
            )
            if mine.size
            else np.zeros(0, np.int64)
        )
        perm_s = np.full(num_targets, -1, np.int32)
        shards.append(
            GroupedBucketLayout(
                t_tile=t_tile, w=w,
                nbr=layout.nbr[steps], msk=layout.msk[steps],
                ety=layout.ety[steps],
                step_row=np.repeat(
                    np.arange(mine.size), blk_ndt[mine]
                ).astype(np.int32),
                step_dt=layout.step_dt[steps],
                step_ndt=layout.step_ndt[steps],
                step_bucket=layout.step_bucket[steps],
                caps=layout.caps.copy(), caps_pad=layout.caps_pad.copy(),
                row_targets=row_targets_blk[mine].ravel(),
                perm=perm_s, num_rows=int(mine.size) * t_tile,
            )
        )
    # per-shard + global inverse permutations, one vectorized pass
    blk_of_t = layout.perm // t_tile
    within = layout.perm % t_tile
    local_rows = (local_block[blk_of_t] * t_tile + within).astype(np.int32)
    # every shard gets the same allocation; +1 block is the shared pad block
    num_rows_alloc = (max(s.num_rows for s in shards) // t_tile + 1) * t_tile
    perm_g = (owner[blk_of_t] * num_rows_alloc + local_rows).astype(np.int32)
    for s in range(n_shards):
        t_mine = np.flatnonzero(owner[blk_of_t] == s)
        shards[s].perm[t_mine] = local_rows[t_mine]
    return ShardedBucketLayout(
        n_shards=n_shards, t_tile=t_tile, w=w, shards=tuple(shards),
        perm=perm_g, num_rows_alloc=num_rows_alloc,
        num_steps_max=max(s.num_steps for s in shards),
    )


@dataclasses.dataclass
class BucketedSemanticGraph:
    """A semantic graph as a small set of degree buckets.

    Every target of ``dst_type`` lands in exactly one bucket — the tightest
    capacity that fits its (build-time-capped) degree. NA runs all buckets
    in one dispatch and restores target order with the precomputed inverse
    permutation. ``_device`` caches device mirrors of the bucket tables,
    and the slot counts of its NA launches (``flows._tick_slots``).
    """

    name: str
    src_types: Tuple[str, ...]
    dst_type: str
    num_targets: int
    buckets: Tuple[DegreeBucket, ...]
    num_edge_types: int = 1
    _flat: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )
    _perm: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )
    _lookup: Optional[Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )
    _grouped: Dict[Tuple[int, int], GroupedBucketLayout] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    _sharded: Dict[Tuple[int, int, int], ShardedBucketLayout] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    _device: Dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    @property
    def bucket_capacities(self) -> Tuple[int, ...]:
        return tuple(b.capacity for b in self.buckets)

    @property
    def max_degree(self) -> int:
        return max((b.capacity for b in self.buckets), default=1)

    @property
    def num_edges(self) -> int:
        return int(sum(b.nbr_mask.sum() for b in self.buckets))

    def degrees(self) -> np.ndarray:
        out = np.zeros(self.num_targets, dtype=np.int64)
        for b in self.buckets:
            out[b.targets] = b.nbr_mask.sum(axis=1)
        return out

    def padded_slots(self) -> int:
        """Total NA slots the bucketed layout pays for (Σ_b T_b × D_b)."""
        return int(sum(b.nbr_idx.size for b in self.buckets))

    def to_flat(self) -> SemanticGraph:
        """The equivalent flat ``(T, D_max)`` graph, edge for edge."""
        nbr, msk, ety = self._flat_arrays()
        return SemanticGraph(
            name=self.name, src_types=self.src_types, dst_type=self.dst_type,
            nbr_idx=nbr, nbr_mask=msk, edge_type=ety,
            num_edge_types=self.num_edge_types,
        )

    def _flat_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The flat ``(T, D_max)`` table rebuilt from the buckets. Cached."""
        if self._flat is None:
            d = self.max_degree
            nbr = np.zeros((self.num_targets, d), dtype=np.int32)
            msk = np.zeros((self.num_targets, d), dtype=bool)
            ety = np.zeros((self.num_targets, d), dtype=np.int32)
            for b in self.buckets:
                nbr[b.targets, : b.capacity] = b.nbr_idx
                msk[b.targets, : b.capacity] = b.nbr_mask
                ety[b.targets, : b.capacity] = b.edge_type
            self._flat = (nbr, msk, ety)
        return self._flat

    @property
    def nbr_idx(self) -> np.ndarray:
        return self._flat_arrays()[0]

    @property
    def nbr_mask(self) -> np.ndarray:
        return self._flat_arrays()[1]

    @property
    def edge_type(self) -> np.ndarray:
        return self._flat_arrays()[2]

    def concat_targets(self) -> np.ndarray:
        """Target ids in bucket-concatenation order (NA's output order
        before the inverse permutation restores target order)."""
        if self.buckets:
            return np.concatenate([b.targets for b in self.buckets])
        return np.zeros(0, np.int32)

    def target_perm(self) -> np.ndarray:
        """``perm[t]`` = row of target ``t`` in the bucket-concatenated NA
        output, so ``concat_out[perm]`` is in target order. Cached."""
        if self._perm is None:
            perm = np.zeros(self.num_targets, dtype=np.int32)
            off = 0
            for b in self.buckets:
                perm[b.targets] = off + np.arange(b.num_targets, dtype=np.int32)
                off += b.num_targets
            self._perm = perm
        return self._perm

    def row_lookup(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(bucket_of, row_of)``: two ``(T,)`` int32 arrays mapping a local
        target id to its bucket index and to its row within that bucket, so
        single rows are addressed without building the flat ``(T, D_max)``
        view. Cached."""
        if self._lookup is None:
            bucket_of = np.zeros(self.num_targets, dtype=np.int32)
            row_of = np.zeros(self.num_targets, dtype=np.int32)
            for i, b in enumerate(self.buckets):
                bucket_of[b.targets] = i
                row_of[b.targets] = np.arange(b.num_targets, dtype=np.int32)
            self._lookup = (bucket_of, row_of)
        return self._lookup

    def grouped(self, t_tile: int = 8, w: int = 8) -> GroupedBucketLayout:
        """The single-launch ragged-grid relayout (cached per tile shape)."""
        key = (t_tile, w)
        if key not in self._grouped:
            with trace.span("sgb.group", always=True, graph=self.name):
                self._grouped[key] = _group_buckets(
                    self.buckets, self.num_targets, t_tile, w
                )
        return self._grouped[key]

    def sharded(self, n_shards: int, t_tile: int = 8, w: int = 8) -> ShardedBucketLayout:
        """The grouped layout split across ``n_shards`` devices by target
        row blocks (cached per split; see :func:`shard_layout`). Built at
        SGB time when ``pipeline.prepare`` is given a split count or finds
        a mesh, else at the first sharded NA dispatch."""
        key = (n_shards, t_tile, w)
        if key not in self._sharded:
            self._sharded[key] = shard_layout(self.grouped(t_tile, w), n_shards)
        return self._sharded[key]


def _pad_csc(
    src: np.ndarray,
    dst: np.ndarray,
    num_targets: int,
    max_degree: int | None,
    rng: np.random.Generator,
    edge_type: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bucket edges by destination into a fixed-width padded table.

    Stable sort by destination, per-row slot positions from a cumsum, one
    flat scatter. Rows over the degree cap are down-sampled uniformly (a
    random re-ranking confined to the overflowing rows; intact rows keep
    arrival order, which the pruner's tie rule depends on).
    """
    e = len(dst)
    dst = dst.astype(np.int64, copy=False)
    counts = np.bincount(dst, minlength=num_targets) if e else np.zeros(
        num_targets, np.int64
    )
    deg_cap = int(counts.max()) if counts.size and counts.max() > 0 else 1
    if max_degree is not None:
        deg_cap = min(deg_cap, max_degree)
    deg_cap = max(deg_cap, 1)
    counts_capped = np.minimum(counts, deg_cap)
    nbr = np.zeros((num_targets, deg_cap), dtype=np.int32)
    msk = np.zeros((num_targets, deg_cap), dtype=bool)
    ety = np.zeros((num_targets, deg_cap), dtype=np.int32)
    if e == 0:
        return nbr, msk, ety
    # stable sort by destination via a unique composite key (dst, arrival)
    order = np.argsort(dst * e + np.arange(e, dtype=np.int64))
    src = src[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(e, dtype=np.int64) - np.repeat(starts, counts)
    over = counts > deg_cap
    if over.any():
        # uniform down-sample of overflow rows: re-rank just their slots by
        # a random key
        sub = np.flatnonzero(np.repeat(over, counts))
        row = np.searchsorted(np.cumsum(counts), sub, side="right")
        order_sub = np.lexsort((rng.random(sub.size), row))
        srt = sub[order_sub]
        row = row[order_sub]
        idx = np.arange(srt.size, dtype=np.int64)
        first = np.empty(srt.size, dtype=bool)
        first[0] = True
        np.not_equal(row[1:], row[:-1], out=first[1:])
        pos[srt] = idx - np.maximum.accumulate(np.where(first, idx, 0))
    keep = pos < deg_cap
    base = np.arange(num_targets, dtype=np.int64) * deg_cap
    flat = np.repeat(base, counts_capped) + pos[keep]
    nbr.reshape(-1)[flat] = src[keep].astype(np.int32, copy=False)
    msk.reshape(-1)[flat] = True
    if edge_type is not None:
        etype = edge_type[order]
        ety.reshape(-1)[flat] = etype[keep].astype(np.int32, copy=False)
    return nbr, msk, ety


def slice_rows(
    sg: Union[SemanticGraph, BucketedSemanticGraph],
    rows: np.ndarray,
    width: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The padded-CSC rows ``rows`` (local target ids) of ``sg``, without
    building its full ``(T, D_max)`` table.

    Returns ``(nbr_idx, nbr_mask, edge_type, bytes_read)``: three
    ``(len(rows), width)`` tables (``width`` defaults to the widest bucket
    capacity among the rows, or a flat graph's ``max_degree``) and the table
    bytes gathered, 9 a slot (int32 id, int32 edge type, bool mask). A
    bucketed graph is fancy-indexed bucket by bucket through
    :meth:`~BucketedSemanticGraph.row_lookup`, so only the touched rows of
    its (possibly memory-mapped) bucket tables are read. Neighbor ids stay
    global.
    """
    rows = np.asarray(rows, dtype=np.int64)
    n = rows.shape[0]
    if isinstance(sg, SemanticGraph):
        d = sg.max_degree
        if width is None:
            width = d
        if width < d:
            raise ValueError(f"width {width} < flat max_degree {d}")
        nbr = np.zeros((n, width), dtype=np.int32)
        msk = np.zeros((n, width), dtype=bool)
        ety = np.zeros((n, width), dtype=np.int32)
        nbr[:, :d] = sg.nbr_idx[rows]
        msk[:, :d] = sg.nbr_mask[rows]
        ety[:, :d] = sg.edge_type[rows]
        return nbr, msk, ety, int(n) * d * 9
    bucket_of, row_of = sg.row_lookup()
    bsel = bucket_of[rows]
    if width is None:
        caps = sg.bucket_capacities
        width = max((caps[b] for b in np.unique(bsel)), default=1)
    nbr = np.zeros((n, width), dtype=np.int32)
    msk = np.zeros((n, width), dtype=bool)
    ety = np.zeros((n, width), dtype=np.int32)
    bytes_read = 0
    for i, b in enumerate(sg.buckets):
        hit = np.flatnonzero(bsel == i)
        if hit.size == 0:
            continue
        if b.capacity > width:
            raise ValueError(f"rows span bucket capacity {b.capacity} > width {width}")
        r = row_of[rows[hit]]
        nbr[hit, : b.capacity] = b.nbr_idx[r]
        msk[hit, : b.capacity] = b.nbr_mask[r]
        ety[hit, : b.capacity] = b.edge_type[r]
        bytes_read += int(r.size) * b.capacity * 9
    return nbr, msk, ety, bytes_read


def autotune_bucket_sizes(
    degrees: np.ndarray,
    max_buckets: int = 4,
    round_to: int = 1,
    launch_cost: float = 0.0,
) -> Tuple[int, ...]:
    """Bucket capacities chosen from the observed degree histogram: the
    segmentation of the unique degrees into at most ``max_buckets`` buckets
    that minimizes

        Σ_b  count_b × pad(cap_b)  +  launch_cost × num_buckets

    (``pad`` rounds a capacity up to ``round_to``), by dynamic programming
    over float64 costs. Capacities sit on observed degrees; with the
    defaults the result is the padded-slot optimum and never pays more
    padded slots than a static list of as many capacities."""
    deg = np.maximum(np.asarray(degrees, np.int64).ravel(), 1)
    if deg.size == 0:
        return (1,)
    uniq, counts = np.unique(deg, return_counts=True)
    m = len(uniq)

    def pad(c) -> int:
        return int(-(-int(c) // round_to) * round_to)

    if m <= max_buckets and launch_cost == 0.0:
        return tuple(int(u) for u in uniq)
    max_buckets = min(max_buckets, m)
    csum = np.concatenate([[0], np.cumsum(counts)])
    # f[b, j]: least cost covering uniq[:j] with b buckets; pred backtracks
    f = np.full((max_buckets + 1, m + 1), float("inf"))
    pred = np.zeros((max_buckets + 1, m + 1), np.int64)
    f[0, 0] = 0.0
    for b in range(1, max_buckets + 1):
        for j in range(1, m + 1):
            # the segment (i, j]: degrees in (uniq[i-1], uniq[j-1]]
            costs = f[b - 1, :j] + (csum[j] - csum[:j]) * pad(uniq[j - 1]) + launch_cost
            i = int(np.argmin(costs))
            f[b, j], pred[b, j] = costs[i], i
    b = int(np.argmin(f[:, m]))
    caps, j = [], m
    while j > 0:
        caps.append(int(uniq[j - 1]))
        j = int(pred[b, j])
        b -= 1
    return tuple(sorted(caps))


def bucketize(
    name: str,
    src_types: Tuple[str, ...],
    dst_type: str,
    nbr: np.ndarray,
    msk: np.ndarray,
    ety: np.ndarray,
    bucket_sizes: Union[Sequence[int], str],
    num_edge_types: int = 1,
) -> BucketedSemanticGraph:
    """Partition a flat padded-CSC table into degree buckets: each target
    goes to the tightest capacity ≥ its degree; the last bucket has capacity
    D_max. Per-bucket tables are row/column slices of the flat table.
    ``bucket_sizes="auto"`` takes the capacities from this table's own
    degree histogram (:func:`autotune_bucket_sizes`). The build span
    ``sgb.bucketize``."""
    with trace.span("sgb.bucketize", always=True, graph=name):
        t, d_max = nbr.shape
        deg = msk.sum(axis=1)
        if isinstance(bucket_sizes, str):
            if bucket_sizes != "auto":
                raise ValueError(f"unknown bucket_sizes spec {bucket_sizes!r}")
            bucket_sizes = autotune_bucket_sizes(deg)
        caps = sorted({int(c) for c in bucket_sizes if 0 < c < d_max})
        caps.append(d_max)
        # assignment = index of the first capacity >= degree
        assign = np.searchsorted(np.asarray(caps), deg, side="left")
        buckets = []
        for i, cap in enumerate(caps):
            targets = np.where(assign == i)[0].astype(np.int32)
            if targets.size == 0:
                continue
            buckets.append(
                DegreeBucket(
                    targets=targets,
                    nbr_idx=nbr[targets, :cap],
                    nbr_mask=msk[targets, :cap],
                    edge_type=ety[targets, :cap],
                )
            )
        sg = BucketedSemanticGraph(
            name=name, src_types=src_types, dst_type=dst_type,
            num_targets=t, buckets=tuple(buckets), num_edge_types=num_edge_types,
        )
        sg.target_perm()  # precompute: NA's inverse-permutation gather needs it
        return sg


def _make_graph(
    name: str,
    src_types: Tuple[str, ...],
    dst_type: str,
    nbr: np.ndarray,
    msk: np.ndarray,
    ety: np.ndarray,
    num_edge_types: int,
    bucket_sizes: Sequence[int] | str | None,
):
    if bucket_sizes is None:
        return SemanticGraph(
            name=name, src_types=src_types, dst_type=dst_type,
            nbr_idx=nbr, nbr_mask=msk, edge_type=ety,
            num_edge_types=num_edge_types,
        )
    return bucketize(
        name, src_types, dst_type, nbr, msk, ety, bucket_sizes, num_edge_types
    )


def build_relation_graphs(
    g: HetGraph,
    max_degree: int | None = None,
    add_self_loops: bool = True,
    seed: int = 0,
    bucket_sizes: Sequence[int] | str | None = None,
    rng: np.random.Generator | None = None,
    only: Sequence[str] | None = None,
) -> List[AnySemanticGraph]:
    """SGB for relation-based models (RGAT): one semantic graph per
    relation, in ``g.relations`` order; the model decides which to use.
    A relation whose endpoints share a type gets self-loops.

    ``rng`` replaces the generator drawn from ``seed`` (the delta merge
    passes a draw-counting one); ``only`` restricts the build to the named
    relations (the merge rebuilds only the dirty slices)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    offs = g.type_offsets()
    out = []
    for (src_t, name, dst_t) in g.relations:
        if only is not None and name not in only:
            continue
        src, dst = g.edges[name]
        gsrc = src.astype(np.int64) + offs[src_t]
        if add_self_loops and src_t == dst_t:
            loops = np.arange(g.num_nodes[dst_t], dtype=np.int64)
            gsrc = np.concatenate([gsrc, loops + offs[dst_t]])
            dst = np.concatenate([dst, loops])
        with trace.span("sgb.pad", always=True, graph=name):
            nbr, msk, ety = _pad_csc(
                gsrc, dst.astype(np.int64), g.num_nodes[dst_t], max_degree, rng
            )
        out.append(
            _make_graph(name, (src_t,), dst_t, nbr, msk, ety, 1, bucket_sizes)
        )
    return out


def build_union_graph(
    g: HetGraph,
    dst_types: Sequence[str] | None = None,
    max_degree: int | None = None,
    add_self_loops: bool = True,
    seed: int = 0,
    bucket_sizes: Sequence[int] | str | None = None,
    rng: np.random.Generator | None = None,
) -> Dict[str, AnySemanticGraph]:
    """SGB for Simple-HGN: one union graph per destination type (all of
    ``g.node_types`` by default, in that order) holding the in-edges of
    every relation, with per-slot relation ids for the edge-type term.
    Self-loops get their own type id, ``len(g.relations)``. ``rng``
    replaces the generator drawn from ``seed``."""
    rng = np.random.default_rng(seed) if rng is None else rng
    offs = g.type_offsets()
    rel_ids = {name: i for i, (_, name, _) in enumerate(g.relations)}
    self_loop_id = len(rel_ids)
    by_dst: Dict[str, List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = {}
    for (src_t, name, dst_t) in g.relations:
        src, dst = g.edges[name]
        gsrc = src.astype(np.int64) + offs[src_t]
        et = np.full(len(gsrc), rel_ids[name], dtype=np.int64)
        by_dst.setdefault(dst_t, []).append((gsrc, dst.astype(np.int64), et))
    out = {}
    wanted = dst_types if dst_types is not None else list(g.node_types)
    for dst_t in wanted:
        parts = list(by_dst.get(dst_t, []))
        if add_self_loops:
            loops = np.arange(g.num_nodes[dst_t], dtype=np.int64)
            parts.append((
                loops + offs[dst_t], loops,
                np.full(g.num_nodes[dst_t], self_loop_id, dtype=np.int64),
            ))
        src, dst, et = (
            np.concatenate([p[i] for p in parts]) if parts else np.zeros(0, np.int64)
            for i in range(3)
        )
        with trace.span("sgb.pad", always=True, graph=f"union:{dst_t}"):
            nbr, msk, ety = _pad_csc(src, dst, g.num_nodes[dst_t], max_degree, rng, et)
        out[dst_t] = _make_graph(
            f"union:{dst_t}", tuple(g.node_types), dst_t, nbr, msk, ety,
            self_loop_id + 1, bucket_sizes,
        )
    return out


def _compose(
    ab: Tuple[np.ndarray, np.ndarray],
    bc: Tuple[np.ndarray, np.ndarray],
    cap_fanout: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Join two relations A->B and B->C on B, returning A->C pairs.

    Sort-merge join vectorized over B (row-major pair enumeration within
    each B block). Per-B fan-out is capped; capped blocks draw uniform pairs
    with replacement.
    """
    a, b1 = ab
    b2, c = bc
    o1 = np.argsort(b1, kind="stable")
    a, b1 = a[o1], b1[o1]
    o2 = np.argsort(b2, kind="stable")
    b2, c = b2[o2], c[o2]
    n_b = int(max(b1.max(initial=-1), b2.max(initial=-1))) + 1
    c1 = np.bincount(b1, minlength=n_b).astype(np.int64)
    c2 = np.bincount(b2, minlength=n_b).astype(np.int64)
    s1 = np.concatenate([[0], np.cumsum(c1)[:-1]])
    s2 = np.concatenate([[0], np.cumsum(c2)[:-1]])
    pairs = c1 * c2
    take = np.minimum(pairs, cap_fanout)
    total = int(take.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    b_of = np.repeat(np.arange(n_b, dtype=np.int64), take)
    t_starts = np.concatenate([[0], np.cumsum(take)[:-1]])
    p = np.arange(total, dtype=np.int64) - t_starts[b_of]
    c2_safe = np.maximum(c2[b_of], 1)
    li = p // c2_safe
    ri = p % c2_safe
    capped = pairs[b_of] > cap_fanout
    if capped.any():
        idx = np.where(capped)[0]
        li[idx] = rng.integers(0, c1[b_of[idx]])
        ri[idx] = rng.integers(0, c2[b_of[idx]])
    return a[s1[b_of] + li], c[s2[b_of] + ri]


def build_metapath_graphs(
    g: HetGraph,
    metapaths: Dict[str, Sequence[str]],
    max_degree: int | None = None,
    cap_fanout: int = 4096,
    seed: int = 0,
    bucket_sizes: Sequence[int] | str | None = None,
    rng: np.random.Generator | None = None,
) -> List[AnySemanticGraph]:
    """SGB for metapath-based models (HAN).

    ``metapaths`` maps a name (e.g. ``"PAP"``) to the relation names to
    compose, e.g. ``("AP_rev", "AP")``; a ``_rev`` suffix transposes the
    edge list. Endpoints share the metapath's end type. Self-loops are added
    (HAN aggregates v itself). ``rng`` replaces the generator drawn from
    ``seed``.
    """
    rng = np.random.default_rng(seed) if rng is None else rng
    offs = g.type_offsets()

    def rel_pairs(name: str) -> Tuple[np.ndarray, np.ndarray, str, str]:
        rev = name.endswith("_rev")
        base = name[:-4] if rev else name
        src_t, _, dst_t = g.rel(base)
        s, d = g.edges[base]
        if rev:
            return d.astype(np.int64), s.astype(np.int64), dst_t, src_t
        return s.astype(np.int64), d.astype(np.int64), src_t, dst_t

    out = []
    for mp_name, chain in metapaths.items():
        with trace.span("sgb.compose", always=True, graph=mp_name):
            s, d, src_t, dst_t = rel_pairs(chain[0])
            for nxt in chain[1:]:
                s2, d2, _, dst_t = rel_pairs(nxt)
                s, d = _compose((s, d), (s2, d2), cap_fanout, rng)
            # dedupe parallel paths (HAN treats the metapath graph as simple)
            key = s.astype(np.int64) * (g.num_nodes[dst_t] + 1) + d.astype(np.int64)
            _, uniq = np.unique(key, return_index=True)
            s, d = s[uniq], d[uniq]
            loops = np.arange(g.num_nodes[dst_t], dtype=np.int64)
            s = np.concatenate([s, loops])
            d = np.concatenate([d, loops])
            gsrc = s + offs[dst_t]  # metapath endpoints share the dst type
        with trace.span("sgb.pad", always=True, graph=mp_name):
            nbr, msk, ety = _pad_csc(gsrc, d, g.num_nodes[dst_t], max_degree, rng)
        out.append(
            _make_graph(mp_name, (dst_t,), dst_t, nbr, msk, ety, 1, bucket_sizes)
        )
    return out
