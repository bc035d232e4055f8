"""Merge-upgrade of bucketed SGB layouts under streamed edge deltas (the
port's copy of the reference's ``stream/merge.py``).

:func:`apply_delta` takes the served semantic-graph stack plus one
:class:`~repro_torch.stream.delta.GraphDelta` and returns a new stack that is
**bit-identical in logits to a from-scratch build of the post-delta
graph**, at a fraction of the cost. Three escalation tiers, chosen per
(relation/metapath, semantic-graph) slice:

  * **clean** — no delta edge lands in the slice: the OLD object is
    returned as-is. Identity is the cache key for device tile mirrors
    (``_dev``) and session statics, so clean slices keep their uploaded
    tiles and captured ego graphs warm across the version swap.
  * **absorb** — every touched row's new degree still fits its bucket's
    capacity: delta edges are inserted into the bucket slack copy-on-write
    (dirty buckets' tables copied, rows re-packed in from-scratch arrival
    order), and the cached ``GroupedBucketLayout`` tile stacks are patched
    copy-on-write (tiles copied, only the dirty rows' slots rewritten —
    step metadata and permutations are untouched because no row moves).
    The patched layout is a new object with an empty device cache
    (``_dev``), so a successor session uploads a dirty slice's tables anew
    and never reads its predecessor's.
  * **spill** — a touched row outgrows its bucket (or the slice's D_max):
    ONLY that slice is rebuilt from the post-delta edge lists through the
    normal builder path (``autotune_bucket_sizes`` + ``bucketize`` +
    ``_group_buckets``), mirroring the layout keys the old slice carried.
    Metapath slices whose compose chain contains a delta'd relation are
    always rebuilt this way (composition is non-local).

Bit-parity contract: ``_pad_csc`` only consumes RNG on degree-cap
overflow and ``_compose`` only on fanout capping — both conditions are
monotone in the edge lists, so appends never *remove* draws. Every
rebuilt slice runs under a draw-counting RNG: if it stays draw-free, its
pre-delta build was draw-free too, the global RNG stream positions are
unchanged, and clean/absorbed slices match the from-scratch build
slot-for-slot. Any draw (an append pushed a row past ``max_degree``, or
a compose block past ``cap_fanout``) aborts the per-slice path and falls
back to a full from-scratch rebuild of the whole stack — trivially
parity-exact, and counted in :class:`MergeStats`.

Within-row slot order is the load-bearing invariant (the fused pruner
breaks score ties by arrival): a from-scratch build lays a row out as
``[rel₁ old…, rel₁ delta…, rel₂ old…, rel₂ delta…, self-loop]`` (union
graphs concatenate relations in declaration order; loops are appended
last). The absorb path reproduces that exactly with one stable lexsort
over ``(row, relation-key, old-before-delta)``; rows that ever hit a
degree cap are full by construction and spill before the assumption can
be violated.

Everything here is host-side numpy — no tensor moves, no device syncs —
so a merge can run concurrently with serving on the live version.
Sharded splits (``ShardedBucketLayout``) are patched per shard the same
way: a shard no delta row lands on keeps its very object, and with it its
device mirrors; a patched shard is a new object with an empty ``_dev``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hetgraph import (
    BucketedSemanticGraph,
    DegreeBucket,
    GroupedBucketLayout,
    HetGraph,
    ShardedBucketLayout,
    build_metapath_graphs,
    build_relation_graphs,
    build_union_graph,
    slice_rows,
)
from repro_torch.stream.delta import GraphDelta

_LOOP_KEY = np.iinfo(np.int64).max  # sorts self-loop slots after all edges


class _CountingRng:
    """Wraps a numpy ``Generator``, counting sampling draws.

    The merge's parity argument needs rebuilt slices to be provably
    draw-free; any ``random``/``integers``/``choice`` call flips the
    rebuild over to the full-stack fallback.
    """

    def __init__(self, rng: np.random.Generator):
        self._rng = rng
        self.draws = 0

    def random(self, *args, **kwargs):
        self.draws += 1
        return self._rng.random(*args, **kwargs)

    def integers(self, *args, **kwargs):
        self.draws += 1
        return self._rng.integers(*args, **kwargs)

    def choice(self, *args, **kwargs):
        self.draws += 1
        return self._rng.choice(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._rng, name)


class _NeedsFullRebuild(Exception):
    """A rebuilt slice consumed RNG — per-slice parity is off the table."""


@dataclasses.dataclass
class MergeStats:
    """Accounting for one :func:`apply_delta` call."""

    clean_slices: int = 0
    absorbed_slices: int = 0
    spilled_slices: int = 0
    rebuilt_slices: int = 0  # metapath recomposes
    absorbed_edges: int = 0
    dirty_targets: int = 0
    full_rebuild: bool = False
    full_rebuild_reason: str = ""

    def summary(self) -> str:
        if self.full_rebuild:
            return f"full rebuild ({self.full_rebuild_reason})"
        return (
            f"clean={self.clean_slices} absorbed={self.absorbed_slices} "
            f"spilled={self.spilled_slices} rebuilt={self.rebuilt_slices} "
            f"edges={self.absorbed_edges} dirty={self.dirty_targets}"
        )


def _degrees_of(
    sg: BucketedSemanticGraph,
    targets: np.ndarray,
    bucket_of: np.ndarray,
    row_of: np.ndarray,
) -> np.ndarray:
    """Current degrees of the given targets, gathered per bucket —
    O(|targets| × cap), never densifying the flat view."""
    deg = np.zeros(targets.size, np.int64)
    bsel = bucket_of[targets]
    for i, b in enumerate(sg.buckets):
        hit = np.flatnonzero(bsel == i)
        if hit.size:
            deg[hit] = b.nbr_mask[row_of[targets[hit]]].sum(axis=1)
    return deg


def _first_steps(lay: GroupedBucketLayout) -> np.ndarray:
    """Grid-step index of D-tile 0 for every row block of the stack (a
    block's steps are contiguous: bucket-major, row-tile, D-tile order)."""
    n_blocks = lay.num_rows // lay.t_tile if lay.num_rows else 0
    fs = np.zeros(max(n_blocks, 1), np.int64)
    blocks, first = np.unique(lay.step_row, return_index=True)
    fs[blocks] = first
    return fs


def _row_flat_index(
    fs: np.ndarray, grows: np.ndarray, t_tile: int, w: int, width: int
) -> np.ndarray:
    """Flat indices into a ``(G, t_tile, w)`` tile stack covering columns
    ``0..width`` of the given stack rows."""
    blk = grows // t_tile
    within = grows % t_tile
    cols = np.arange(width, dtype=np.int64)
    step = fs[blk][:, None] + cols[None, :] // w
    return (step * t_tile + within[:, None]) * w + cols[None, :] % w


# one patch per dirty bucket: (bucket_idx, target_ids, nbr, msk, ety rows)
_Patch = Tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _patch_grouped(
    lay: GroupedBucketLayout, patches: Sequence[_Patch]
) -> GroupedBucketLayout:
    """Copy-on-write rewrite of the dirty rows' tiles. No row moves, so
    step metadata / permutations / row_targets are shared with the old
    layout; only the three tile stacks are copied."""
    flat, vn, vm, ve = [], [], [], []
    fs = _first_steps(lay)
    for _, t_b, nbr_n, msk_n, ety_n in patches:
        grows = lay.perm[t_b].astype(np.int64)
        idx = _row_flat_index(fs, grows, lay.t_tile, lay.w, nbr_n.shape[1])
        flat.append(idx.ravel())
        vn.append(nbr_n.ravel())
        vm.append(msk_n.ravel())
        ve.append(ety_n.ravel())
    nbr, msk, ety = lay.nbr.copy(), lay.msk.copy(), lay.ety.copy()
    ii = np.concatenate(flat)
    nbr.reshape(-1)[ii] = np.concatenate(vn).astype(np.int32)
    msk.reshape(-1)[ii] = np.concatenate(vm)
    ety.reshape(-1)[ii] = np.concatenate(ve).astype(np.int32)
    return dataclasses.replace(lay, nbr=nbr, msk=msk, ety=ety)


def _patch_sharded(
    sl: ShardedBucketLayout, patches: Sequence[_Patch]
) -> ShardedBucketLayout:
    """Per-shard copy-on-write tile rewrite. Degrees only grow within
    existing capacities, so D-tile counts — and the LPT shard assignment —
    are unchanged; untouched shards keep their very objects (and their
    device mirrors)."""
    nra = sl.num_rows_alloc
    per_shard: Dict[int, List[Tuple[np.ndarray, ...]]] = {}
    for _, t_b, nbr_n, msk_n, ety_n in patches:
        val = sl.perm[t_b].astype(np.int64)
        owner = val // nra
        lrow = val % nra
        for s in np.unique(owner):
            m = np.flatnonzero(owner == s)
            per_shard.setdefault(int(s), []).append(
                (lrow[m], nbr_n[m], msk_n[m], ety_n[m])
            )
    shards = list(sl.shards)
    for s, rows in per_shard.items():
        lay = shards[s]
        fs = _first_steps(lay)
        flat, vn, vm, ve = [], [], [], []
        for lrow, nbr_n, msk_n, ety_n in rows:
            idx = _row_flat_index(fs, lrow, sl.t_tile, sl.w, nbr_n.shape[1])
            flat.append(idx.ravel())
            vn.append(nbr_n.ravel())
            vm.append(msk_n.ravel())
            ve.append(ety_n.ravel())
        nbr, msk, ety = lay.nbr.copy(), lay.msk.copy(), lay.ety.copy()
        ii = np.concatenate(flat)
        nbr.reshape(-1)[ii] = np.concatenate(vn).astype(np.int32)
        msk.reshape(-1)[ii] = np.concatenate(vm)
        ety.reshape(-1)[ii] = np.concatenate(ve).astype(np.int32)
        shards[s] = dataclasses.replace(lay, nbr=nbr, msk=msk, ety=ety)
    return dataclasses.replace(sl, shards=tuple(shards))


def _scatter_rows(arr: np.ndarray, rows: np.ndarray, new: np.ndarray):
    out = arr.copy()
    out[rows] = new.astype(arr.dtype, copy=False)
    return out


def _absorb(
    sg: BucketedSemanticGraph,
    gsrc: np.ndarray,
    dst: np.ndarray,
    ety_d: np.ndarray,
    *,
    union: bool,
    has_loops: bool,
    loop_base: int,
) -> Optional[BucketedSemanticGraph]:
    """Insert delta edges into existing bucket slack, or return ``None``
    when any touched row outgrows its bucket capacity (spill).

    Every dirty row is re-packed by one stable lexsort over
    ``(row, relation-key, old-before-delta)`` with arrival order as the
    tiebreak — exactly the slot order a from-scratch ``_pad_csc`` of the
    appended edge list produces. A row that ever hit a degree cap sits at
    ``deg == capacity`` (full), so it can never take the absorb path with
    a scrambled arrival order.
    """
    bucket_of, row_of = sg.row_lookup()
    targets = np.unique(dst)
    add = np.bincount(dst, minlength=sg.num_targets)[targets]
    deg = _degrees_of(sg, targets, bucket_of, row_of)
    caps = np.asarray(sg.bucket_capacities, np.int64)
    if np.any(deg + add > caps[bucket_of[targets]]):
        return None
    t_index = np.full(sg.num_targets, -1, np.int64)
    t_index[targets] = np.arange(targets.size)
    bsel = bucket_of[targets]
    edge_b = bsel[t_index[dst]]  # owning bucket of each delta edge
    new_buckets = list(sg.buckets)
    patches: List[_Patch] = []
    for bi, b in enumerate(sg.buckets):
        hit = np.flatnonzero(bsel == bi)
        if hit.size == 0:
            continue
        t_b = targets[hit]  # sorted local target ids in this bucket
        rows_b = row_of[t_b]
        nbr_o = b.nbr_idx[rows_b]
        msk_o = b.nbr_mask[rows_b]
        ety_o = b.edge_type[rows_b]
        deg_b = msk_o.sum(axis=1)
        # old slots: np.nonzero is row-major, preserving per-row arrival
        oi, oj = np.nonzero(msk_o)
        nbr_ov = nbr_o[oi, oj].astype(np.int64)
        if union:
            k1_o = ety_o[oi, oj].astype(np.int64)
        else:
            k1_o = np.zeros(oi.size, np.int64)
            if has_loops:
                is_loop = (oj == deg_b[oi] - 1) & (nbr_ov == loop_base + t_b[oi])
                k1_o[is_loop] = _LOOP_KEY
        # delta slots bound for this bucket, in delta arrival order
        dsel = np.flatnonzero(edge_b == bi)
        di = np.searchsorted(t_b, dst[dsel])
        k1_d = ety_d[dsel] if union else np.zeros(dsel.size, np.int64)
        row_all = np.concatenate([oi, di])
        k1_all = np.concatenate([k1_o, k1_d])
        k2_all = np.concatenate(
            [np.zeros(oi.size, np.int64), np.ones(dsel.size, np.int64)]
        )
        nbr_all = np.concatenate([nbr_ov, gsrc[dsel]])
        ety_all = np.concatenate([ety_o[oi, oj].astype(np.int64), ety_d[dsel]])
        order = np.lexsort((k2_all, k1_all, row_all))  # stable: arrival ties
        row_s = row_all[order]
        cnt = deg_b + np.bincount(di, minlength=hit.size)
        starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        pos = np.arange(row_all.size, dtype=np.int64) - np.repeat(starts, cnt)
        cap = b.capacity
        nbr_n = np.zeros((hit.size, cap), np.int32)
        msk_n = np.zeros((hit.size, cap), bool)
        ety_n = np.zeros((hit.size, cap), np.int32)
        nbr_n[row_s, pos] = nbr_all[order].astype(np.int32)
        msk_n[row_s, pos] = True
        ety_n[row_s, pos] = ety_all[order].astype(np.int32)
        new_buckets[bi] = DegreeBucket(
            targets=b.targets,
            nbr_idx=_scatter_rows(b.nbr_idx, rows_b, nbr_n),
            nbr_mask=_scatter_rows(b.nbr_mask, rows_b, msk_n),
            edge_type=_scatter_rows(b.edge_type, rows_b, ety_n),
        )
        patches.append((bi, t_b, nbr_n, msk_n, ety_n))
    new_sg = BucketedSemanticGraph(
        name=sg.name,
        src_types=sg.src_types,
        dst_type=sg.dst_type,
        num_targets=sg.num_targets,
        buckets=tuple(new_buckets),
        num_edge_types=sg.num_edge_types,
    )
    # no row moves: permutations and the bucket/row lookup carry over
    new_sg._perm = sg.target_perm()
    new_sg._lookup = sg._lookup
    for key, lay in sg._grouped.items():
        new_sg._grouped[key] = _patch_grouped(lay, patches)
    for key, sl in sg._sharded.items():
        new_sg._sharded[key] = _patch_sharded(sl, patches)
    return new_sg


def _mirror_layouts(old: BucketedSemanticGraph, new: BucketedSemanticGraph):
    """Build on the new slice every grouped/sharded layout key the old
    slice carried, so a publish never lazily rebuilds on the serve path."""
    for (t_tile, w) in old._grouped:
        new.grouped(t_tile, w)
    for (n, t_tile, w) in old._sharded:
        new.sharded(n, t_tile, w)


def _row_diff(a: BucketedSemanticGraph, b: BucketedSemanticGraph) -> np.ndarray:
    """Local target ids whose padded-CSC row content differs between two
    layouts of the same target set (bucket placement is ignored — logits
    only depend on within-row content)."""
    width = max(a.max_degree, b.max_degree)
    rows = np.arange(a.num_targets, dtype=np.int64)
    na, ma, ea, _ = slice_rows(a, rows, width=width)
    nb, mb, eb, _ = slice_rows(b, rows, width=width)
    diff = (ma != mb) | (ma & ((na != nb) | (ea != eb)))
    return np.flatnonzero(diff.any(axis=1))


def apply_delta(
    sgs: Sequence[BucketedSemanticGraph],
    graph: HetGraph,
    new_graph: HetGraph,
    delta: GraphDelta,
    *,
    kind: str,
    metapaths: Optional[Dict[str, Sequence[str]]] = None,
    max_degree: Optional[int] = None,
    seed: int = 0,
    bucket_sizes=None,
    add_self_loops: bool = True,
    cap_fanout: int = 4096,
) -> Tuple[List[BucketedSemanticGraph], Dict[str, np.ndarray], MergeStats]:
    """Merge one delta into a served semantic-graph stack.

    ``graph``/``new_graph`` are the pre/post-delta :class:`HetGraph`
    (see :func:`repro_torch.stream.delta.apply_to_graph`); the builder arguments
    must match the ones the stack was originally built with — they decide
    both the spill-rebuild output and the parity contract.

    Returns ``(new_sgs, dirty, stats)``: the stack in input order (clean
    slices are the SAME objects), ``dirty`` mapping node type → sorted
    local target ids whose rows changed (the ego-invalidation set), and
    the per-tier :class:`MergeStats`.
    """
    for sg in sgs:
        if not isinstance(sg, BucketedSemanticGraph):
            raise TypeError(
                "apply_delta needs bucketed layouts; flat SemanticGraph "
                f"slices (got {type(sg).__name__}) must be rebuilt cold"
            )
    if bucket_sizes is None:
        raise ValueError("apply_delta needs the build-time bucket_sizes")
    if kind == "metapath" and not metapaths:
        raise ValueError("kind='metapath' needs the metapaths table")
    stats = MergeStats()
    dirty_parts: Dict[str, List[np.ndarray]] = {}

    def rebuild_slice(sg: BucketedSemanticGraph) -> BucketedSemanticGraph:
        crng = _CountingRng(np.random.default_rng(seed))
        if kind == "relation":
            built = build_relation_graphs(
                new_graph, max_degree=max_degree,
                add_self_loops=add_self_loops, bucket_sizes=bucket_sizes,
                rng=crng, only=(sg.name,),
            )
            out = built[0]
        elif kind == "union":
            out = build_union_graph(
                new_graph, dst_types=(sg.dst_type,), max_degree=max_degree,
                add_self_loops=add_self_loops, bucket_sizes=bucket_sizes,
                rng=crng,
            )[sg.dst_type]
        else:
            out = build_metapath_graphs(
                new_graph, {sg.name: metapaths[sg.name]},
                max_degree=max_degree, cap_fanout=cap_fanout,
                bucket_sizes=bucket_sizes, rng=crng,
            )[0]
        if crng.draws:
            raise _NeedsFullRebuild(
                f"slice {sg.name!r} rebuild consumed {crng.draws} RNG "
                "draw(s) (degree-cap overflow or fanout cap)"
            )
        _mirror_layouts(sg, out)
        return out

    try:
        new_sgs = _merge(
            sgs, graph, delta, kind, metapaths, add_self_loops,
            rebuild_slice, stats, dirty_parts,
        )
    except _NeedsFullRebuild as e:
        stats.full_rebuild = True
        stats.full_rebuild_reason = str(e)
        new_sgs = _rebuild_all(
            sgs, new_graph, kind, metapaths=metapaths, max_degree=max_degree,
            seed=seed, bucket_sizes=bucket_sizes,
            add_self_loops=add_self_loops, cap_fanout=cap_fanout,
        )
        dirty_parts = {}
        for sg in sgs:
            dirty_parts.setdefault(sg.dst_type, []).append(
                np.arange(sg.num_targets, dtype=np.int64)
            )
    dirty = {
        t: np.unique(np.concatenate(parts))
        for t, parts in dirty_parts.items()
        if parts
    }
    stats.dirty_targets = int(sum(d.size for d in dirty.values()))
    return new_sgs, dirty, stats


def _merge(
    sgs, graph, delta, kind, metapaths, add_self_loops,
    rebuild_slice, stats, dirty_parts,
):
    offs = graph.type_offsets()
    out: List[BucketedSemanticGraph] = []
    if kind == "metapath":
        touched = set(delta.edges)

        def base(rel: str) -> str:
            return rel[:-4] if rel.endswith("_rev") else rel

        for sg in sgs:
            chain = metapaths[sg.name]
            if not any(base(r) in touched for r in chain):
                out.append(sg)
                stats.clean_slices += 1
                continue
            nsg = rebuild_slice(sg)
            stats.rebuilt_slices += 1
            dirty_parts.setdefault(sg.dst_type, []).append(_row_diff(sg, nsg))
            out.append(nsg)
        return out
    if kind == "union":
        rel_ids = {name: i for i, (_, name, _) in enumerate(graph.relations)}
        per_dst: Dict[str, List[Tuple[np.ndarray, ...]]] = {}
        for (src_t, name, dst_t) in graph.relations:
            pair = delta.edges.get(name)
            if pair is None or len(pair[0]) == 0:
                continue
            s, d = pair
            per_dst.setdefault(dst_t, []).append(
                (
                    s + offs[src_t],
                    d,
                    np.full(len(s), rel_ids[name], np.int64),
                )
            )
        for sg in sgs:
            parts = per_dst.get(sg.dst_type)
            if not parts:
                out.append(sg)
                stats.clean_slices += 1
                continue
            gsrc = np.concatenate([p[0] for p in parts])
            dst = np.concatenate([p[1] for p in parts])
            ety_d = np.concatenate([p[2] for p in parts])
            nsg = _absorb(
                sg, gsrc, dst, ety_d, union=True, has_loops=add_self_loops,
                loop_base=offs[sg.dst_type],
            )
            if nsg is None:
                nsg = rebuild_slice(sg)
                stats.spilled_slices += 1
            else:
                stats.absorbed_slices += 1
                stats.absorbed_edges += int(len(gsrc))
            dirty_parts.setdefault(sg.dst_type, []).append(np.unique(dst))
            out.append(nsg)
        return out
    # relation kind
    for sg in sgs:
        pair = delta.edges.get(sg.name)
        if pair is None or len(pair[0]) == 0:
            out.append(sg)
            stats.clean_slices += 1
            continue
        src, dst = pair
        src_t, _, dst_t = graph.rel(sg.name)
        gsrc = src + offs[src_t]
        ety_d = np.zeros(len(gsrc), np.int64)
        nsg = _absorb(
            sg, gsrc, dst, ety_d, union=False,
            has_loops=add_self_loops and src_t == dst_t,
            loop_base=offs[dst_t],
        )
        if nsg is None:
            nsg = rebuild_slice(sg)
            stats.spilled_slices += 1
        else:
            stats.absorbed_slices += 1
            stats.absorbed_edges += int(len(gsrc))
        dirty_parts.setdefault(dst_t, []).append(np.unique(dst))
        out.append(nsg)
    return out


def _rebuild_all(
    sgs, new_graph, kind, *, metapaths, max_degree, seed, bucket_sizes,
    add_self_loops, cap_fanout,
):
    """The parity-trivial fallback: rebuild the whole stack from scratch
    on the post-delta graph (one shared RNG stream, exactly like the
    original build) and mirror each old slice's layout keys."""
    if kind == "relation":
        built = build_relation_graphs(
            new_graph, max_degree=max_degree, add_self_loops=add_self_loops,
            seed=seed, bucket_sizes=bucket_sizes,
        )
        by = {sg.name: sg for sg in built}
    elif kind == "union":
        by = {
            sg.name: sg
            for sg in build_union_graph(
                new_graph, max_degree=max_degree,
                add_self_loops=add_self_loops, seed=seed,
                bucket_sizes=bucket_sizes,
            ).values()
        }
    else:
        built = build_metapath_graphs(
            new_graph, metapaths, max_degree=max_degree,
            cap_fanout=cap_fanout, seed=seed, bucket_sizes=bucket_sizes,
        )
        by = {sg.name: sg for sg in built}
    out = []
    for old in sgs:
        nsg = by[old.name]
        _mirror_layouts(old, nsg)
        out.append(nsg)
    return out
