"""Ego-subgraph extraction: a query's forward on its targets' neighborhood.

A serving query asks for the logits of a handful of target vertices, but a
full ``GraphBatch`` forward pays for the whole graph. This module slices the
L-hop metapath / relation neighborhood of a query's targets out of the
(possibly memory-mapped, SGB-cache-loaded) layouts into a fixed-shape padded
:class:`EgoBatch`, so the host rows gathered, the bytes read and the forward
itself scale with the neighborhood, not with ``|V|``.

Shapes sit on a small capacity ladder, so a handful of programs (on a card,
one captured CUDA graph per :class:`EgoSignature`) serve every query:

* per node type, the ego vertex capacity comes from
  :func:`~repro_torch.core.hetgraph.autotune_bucket_sizes` run over sampled
  closure sizes, the DP that picks degree buckets and request ladders;
* per semantic graph, the padded neighbor width comes from the graph's own
  bucket capacities, so an ego table no wider than the pruner's K takes the
  paper's §4.3 bypass, and a wider one the flat fused kernel.

A closure that outgrows the top capacity is not an error: ``extract``
returns ``None`` and ``InferenceSession.query_ego`` serves the query with
the full forward (``session.query``), counted in
``flows.DISPATCH["ego_fallback"]``.

Exactness: with ``depth = L`` model layers, every vertex whose layer-``l``
activation (``l >= 1``) feeds a target keeps its full neighborhood row (the
sets ``B_L = targets``, ``B_{l-1} = B_l ∪ N_in(B_l)``), and the outermost
frontier is admitted with masked (empty) rows, whose activations after
layer 0 never reach a target. Graph-global quantities a neighborhood cannot
reproduce (HAN's semantic-attention β) are injected through
``HGNNModel.ego_globals``.

``extract`` builds host numpy arrays, the reference's bit for bit;
:meth:`EgoBatch.to` puts them on a device. A captured session copies them
into its static inputs instead (``core/session.py``).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import from_host
from repro_torch.core.hetgraph import (
    BucketedSemanticGraph,
    SemanticGraph,
    autotune_bucket_sizes,
    slice_rows,
)


@dataclasses.dataclass(frozen=True)
class EgoSgSpec:
    """Static shape and identity of one semantic graph in an ego batch."""

    name: str
    src_types: Tuple[str, ...]
    dst_type: str
    d_cap: int
    num_edge_types: int


@dataclasses.dataclass(frozen=True)
class EgoSignature:
    """The static half of an :class:`EgoBatch`, hashed by value: two
    extractions with the same capacities share one program."""

    node_types: Tuple[str, ...]
    caps: Tuple[int, ...]
    label_type: str
    out_capacity: int
    sgs: Tuple[EgoSgSpec, ...]
    global_keys: Tuple[str, ...]

    @property
    def total_nodes(self) -> int:
        return int(sum(self.caps))

    @property
    def max_d_cap(self) -> int:
        return max((s.d_cap for s in self.sgs), default=1)


class EgoBatch:
    """A fixed-shape ego neighborhood, duck-typed as a ``GraphBatch``.

    Leaves (per query): per-type feature tables padded to the signature's
    vertex capacities, per semantic graph ``(nbr int32, msk bool, ety
    int32)`` padded-CSC tables holding EGO-LOCAL neighbor ids, ``out_rows``
    (the query's positions among the ego label rows, int32) and the injected
    ``ego_globals``. As ``extract`` returns it the table leaves are host
    numpy arrays; :meth:`to` gives the tensor batch a model runs on.

    Semantic graphs are flat :class:`SemanticGraph` views over the tables;
    ``flows.run_aggregate_graph`` takes tensor tables as they are and caches
    nothing on them.
    """

    def __init__(
        self,
        sig: EgoSignature,
        features: Dict[str, object],
        tables: Tuple[Tuple[object, object, object], ...],
        out_rows,
        ego_globals: Dict[str, torch.Tensor],
    ):
        self.sig = sig
        self.features = features
        self.tables = tables
        self.out_rows = out_rows
        self.ego_globals = ego_globals
        self._sgs: Optional[Tuple[SemanticGraph, ...]] = None

    def to(self, device) -> "EgoBatch":
        """The same batch with every leaf a tensor on ``device`` (host
        arrays copied, tensors moved)."""
        device = torch.device(device)

        def put(x):
            return x.to(device) if isinstance(x, torch.Tensor) else from_host(x, device)

        return EgoBatch(
            self.sig,
            {t: put(f) for t, f in self.features.items()},
            tuple(tuple(put(a) for a in tab) for tab in self.tables),
            put(self.out_rows),
            {k: put(v) for k, v in self.ego_globals.items()},
        )

    def host_leaves(self) -> Tuple[np.ndarray, ...]:
        """The per-query host arrays in a fixed order: features by node
        type, then each table's (nbr, msk, ety), then ``out_rows``."""
        out = [self.features[t] for t in self.sig.node_types]
        for tab in self.tables:
            out.extend(tab)
        out.append(self.out_rows)
        return tuple(out)

    # -- the GraphBatch protocol --------------------------------------------

    @property
    def device(self) -> torch.device:
        f = self.features[self.sig.node_types[0]]
        return f.device if isinstance(f, torch.Tensor) else torch.device("cpu")

    @property
    def node_types(self) -> Tuple[str, ...]:
        return self.sig.node_types

    @property
    def label_type(self) -> str:
        return self.sig.label_type

    @property
    def num_nodes(self) -> Dict[str, int]:
        return dict(zip(self.sig.node_types, self.sig.caps))

    @property
    def offsets(self) -> Dict[str, int]:
        out, off = {}, 0
        for t, c in zip(self.sig.node_types, self.sig.caps):
            out[t] = off
            off += c
        return out

    @property
    def total_nodes(self) -> int:
        return self.sig.total_nodes

    @property
    def num_targets(self) -> int:
        return self.num_nodes[self.sig.label_type]

    @property
    def dst_offset(self) -> int:
        return self.offsets[self.sig.label_type]

    @property
    def sgs(self) -> Tuple[SemanticGraph, ...]:
        if self._sgs is None:
            self._sgs = tuple(
                SemanticGraph(
                    name=s.name, src_types=s.src_types, dst_type=s.dst_type,
                    nbr_idx=nbr, nbr_mask=msk, edge_type=ety,
                    num_edge_types=s.num_edge_types,
                )
                for s, (nbr, msk, ety) in zip(self.sig.sgs, self.tables)
            )
        return self._sgs

    @property
    def sg_by_dst(self) -> Dict[str, SemanticGraph]:
        return {sg.dst_type: sg for sg in self.sgs}

    def constrain(self, x, role: str):
        """Ego forwards run on one device: the identity."""
        return x


@dataclasses.dataclass
class EgoStats:
    """Host-side accounting, summed over extractions."""

    queries: int = 0
    fallbacks: int = 0
    feature_rows: int = 0
    adjacency_rows: int = 0
    bytes_read: int = 0
    closure_hits: int = 0

    def reset(self) -> None:
        self.queries = 0
        self.fallbacks = 0
        self.feature_rows = 0
        self.adjacency_rows = 0
        self.bytes_read = 0
        self.closure_hits = 0

    @property
    def rows_per_query(self) -> float:
        n = max(self.queries - self.fallbacks, 1)
        return (self.feature_rows + self.adjacency_rows) / n

    def summary(self) -> Dict[str, float]:
        return {
            "queries": self.queries,
            "fallbacks": self.fallbacks,
            "feature_rows": self.feature_rows,
            "adjacency_rows": self.adjacency_rows,
            "bytes_read": self.bytes_read,
            "closure_hits": self.closure_hits,
            "rows_per_query": round(self.rows_per_query, 2),
        }


class EgoPlanner:
    """Extracts :class:`EgoBatch` es from one ``GraphBatch``'s layouts.

    Feature rows are gathered on the host. With no ``features`` the planner
    takes one host copy of each of the batch's feature tensors, once, here;
    ``features`` may instead give host arrays (for example
    ``data.sgb_cache.open_mmap_arrays`` views of a dataset dump), whose rows
    are then read straight off the mapping per query.

    ``capacities`` (per-type vertex ladders) defaults to
    ``autotune_bucket_sizes`` over the closure sizes of ``sample`` seeded
    random queries, their sizes cycling through ``sample_sizes`` (pass the
    serving ``BatchPolicy.capacities``).

    ``closure_cache > 0`` bounds an LRU of computed ``(full, inner)``
    closures keyed by the query's seed set: :meth:`invalidate` drops the
    entries whose closure touches a dirty vertex, and :meth:`carry_from`
    adopts a predecessor planner's clean entries across a graph-version
    swap. ``0`` (the default) keeps none.
    """

    def __init__(
        self,
        batch,
        depth: int,
        features: Optional[Dict[str, np.ndarray]] = None,
        capacities: Optional[Dict[str, Sequence[int]]] = None,
        max_capacities: int = 4,
        sample: int = 48,
        sample_sizes: Sequence[int] = (1, 4),
        seed: int = 0,
        closure_cache: int = 0,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self.node_types: Tuple[str, ...] = tuple(batch.node_types)
        self.label_type: str = batch.label_type
        self.sgs = tuple(batch.sgs)
        self._offsets = dict(batch.offsets)
        self._num_nodes = dict(batch.num_nodes)
        self._starts = np.array([self._offsets[t] for t in self.node_types], dtype=np.int64)
        src = features if features is not None else batch.features
        self.features = {t: _host(src[t]) for t in self.node_types}
        self._d_ladders = {
            sg.name: (
                tuple(sg.bucket_capacities)
                if isinstance(sg, BucketedSemanticGraph)
                else (int(sg.max_degree),)
            )
            for sg in self.sgs
        }
        self.stats = EgoStats()
        self.closure_cache = int(closure_cache)
        self._closures: "OrderedDict[bytes, Tuple[Dict, Dict]]" = OrderedDict()
        if capacities is None:
            capacities = self._tune_capacities(sample, tuple(sample_sizes), max_capacities, seed)
        self.capacities = _equalize_ladders(capacities, self.node_types)

    # -- the capacity ladder --------------------------------------------------

    def _tune_capacities(
        self, sample: int, sample_sizes: Tuple[int, ...], max_caps: int, seed: int
    ) -> Dict[str, Tuple[int, ...]]:
        """Per-type vertex ladders from the closure sizes of seeded random
        queries: the degree-bucket DP applied to ego sizes."""
        rng = np.random.default_rng(seed)
        n_lbl = int(self._num_nodes[self.label_type])
        sizes = {t: [] for t in self.node_types}
        for i in range(max(int(sample), 1)):
            k = min(int(sample_sizes[i % len(sample_sizes)]), n_lbl)
            idx = rng.integers(0, n_lbl, size=max(k, 1))
            full, _ = self._closure(idx)
            for t in self.node_types:
                sizes[t].append(max(int(full[t].size), 1))
        return {
            t: autotune_bucket_sizes(np.asarray(sizes[t]), max_buckets=max_caps)
            for t in self.node_types
        }

    # -- the closure --------------------------------------------------------

    def _closure(
        self, idx: np.ndarray, stats: Optional[EgoStats] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """The L-hop in-neighborhood closure of ``idx`` (label-type local
        ids): ``(full, inner)``, per type sorted unique local ids. ``full``
        is every vertex the ego forward holds; ``inner`` (one hop short)
        every vertex that keeps its full neighborhood row. Each hop slices
        only the rows of the vertices the previous hop found."""
        seeds = np.unique(np.asarray(idx, dtype=np.int64))
        full = {t: np.zeros(0, dtype=np.int64) for t in self.node_types}
        full[self.label_type] = seeds
        frontier: Dict[str, np.ndarray] = {self.label_type: seeds}
        inner: Optional[Dict[str, np.ndarray]] = None
        for hop in range(self.depth):
            if hop == self.depth - 1:
                inner = dict(full)
            if not frontier:
                break
            parts: Dict[str, list] = {t: [] for t in self.node_types}
            for sg in self.sgs:
                rows = frontier.get(sg.dst_type)
                if rows is None or rows.size == 0:
                    continue
                nbr, msk, _, nbytes = slice_rows(sg, rows)
                if stats is not None:
                    stats.adjacency_rows += int(rows.size)
                    stats.bytes_read += nbytes
                g = nbr[msk].astype(np.int64)
                if g.size == 0:
                    continue
                ti = np.searchsorted(self._starts, g, side="right") - 1
                loc = g - self._starts[ti]
                for k in np.unique(ti):
                    parts[self.node_types[int(k)]].append(loc[ti == k])
            frontier = {}
            for t in self.node_types:
                if not parts[t]:
                    continue
                cand = np.unique(np.concatenate(parts[t]))
                fresh = np.setdiff1d(cand, full[t], assume_unique=True)
                if fresh.size:
                    full[t] = np.union1d(full[t], fresh)
                    frontier[t] = fresh
        if inner is None:
            inner = dict(full)
        return full, inner

    def _cached_closure(
        self, idx: np.ndarray, stats: EgoStats
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """``_closure`` behind the bounded LRU (none when disabled), keyed
        by the sorted unique seed set; a hit reads no adjacency row."""
        if not self.closure_cache:
            return self._closure(idx, stats=stats)
        key = np.unique(np.asarray(idx, dtype=np.int64)).tobytes()
        hit = self._closures.get(key)
        if hit is not None:
            self._closures.move_to_end(key)
            stats.closure_hits += 1
            return hit
        full, inner = self._closure(idx, stats=stats)
        self._closures[key] = (full, inner)
        while len(self._closures) > self.closure_cache:
            self._closures.popitem(last=False)
        return full, inner

    def invalidate(self, dirty: Dict[str, np.ndarray]) -> int:
        """Drop every cached closure that holds a dirty vertex (``dirty``:
        node type -> local ids whose neighborhood rows changed). Returns how
        many were dropped."""
        if not self._closures:
            return 0
        dsets = _dirty_sets(dirty)
        if not dsets:
            return 0
        drop = [key for key, (full, _) in self._closures.items() if _touches(full, dsets)]
        for key in drop:
            del self._closures[key]
        return len(drop)

    def carry_from(self, other: "EgoPlanner", dirty: Optional[Dict[str, np.ndarray]] = None) -> int:
        """Adopt ``other``'s cached closures but those holding a ``dirty``
        vertex (a graph-version swap: a clean closure expanded over rows the
        delta did not touch). Both planners must share node types, label
        type and depth. Returns how many were adopted."""
        if not self.closure_cache:
            return 0
        if (
            other.node_types != self.node_types
            or other.label_type != self.label_type
            or other.depth != self.depth
        ):
            raise ValueError(
                "closures are only portable between planners sharing "
                "node types, label type, and depth"
            )
        dsets = _dirty_sets(dirty or {})
        adopted = 0
        for key, pair in other._closures.items():
            if _touches(pair[0], dsets):
                continue
            self._closures[key] = pair
            adopted += 1
        while len(self._closures) > self.closure_cache:
            self._closures.popitem(last=False)
        return adopted

    # -- extraction ---------------------------------------------------------

    def _d_cap(self, sg, rows: np.ndarray) -> int:
        """The tightest width on ``sg``'s bucket ladder that covers the
        selected rows."""
        ladder = self._d_ladders[sg.name]
        if rows.size == 0:
            return int(ladder[0])
        if isinstance(sg, BucketedSemanticGraph):
            bucket_of, _ = sg.row_lookup()
            caps = sg.bucket_capacities
            need = max(caps[int(b)] for b in np.unique(bucket_of[rows]))
        else:
            need = int(sg.max_degree)
        for c in ladder:
            if c >= need:
                return int(c)
        return int(ladder[-1])

    def _remap(
        self,
        nbr: np.ndarray,
        msk: np.ndarray,
        verts: Dict[str, np.ndarray],
        ego_off: Dict[str, int],
    ) -> np.ndarray:
        """Global neighbor ids -> ego-local ids (masked slots -> 0)."""
        g = nbr.astype(np.int64).ravel()
        m = msk.ravel()
        out = np.zeros(g.shape, dtype=np.int64)
        gi = g[m]
        if gi.size:
            ti = np.searchsorted(self._starts, gi, side="right") - 1
            loc = gi - self._starts[ti]
            res = np.empty(gi.shape, dtype=np.int64)
            for k in np.unique(ti):
                t = self.node_types[int(k)]
                sel = ti == k
                vt = verts[t]
                pos = np.searchsorted(vt, loc[sel])
                ok = (pos < vt.size) & (vt[np.minimum(pos, max(vt.size - 1, 0))] == loc[sel])
                if not np.all(ok):
                    raise AssertionError(
                        f"ego closure missed {int((~ok).sum())} neighbors of "
                        f"type {t!r}: internal invariant violated"
                    )
                res[sel] = ego_off[t] + pos
            out[m] = res
        return out.reshape(nbr.shape).astype(np.int32)

    def extract(self, idx, ego_globals: Optional[Dict[str, torch.Tensor]] = None) -> Optional[EgoBatch]:
        """The ego batch of query ``idx`` (host arrays), or ``None`` when
        its closure exceeds the top ladder capacity (the caller falls back
        to the full forward). Ids are not range-checked here:
        ``InferenceSession.query_ego`` checks them first."""
        idx = np.asarray(idx, dtype=np.int64).ravel()
        st = self.stats
        st.queries += 1
        full, inner = self._cached_closure(idx, stats=st)
        need = {t: max(int(full[t].size), 1) for t in self.node_types}
        n_levels = len(self.capacities[self.node_types[0]])
        level = None
        for k in range(n_levels):
            if all(need[t] <= self.capacities[t][k] for t in self.node_types):
                level = k
                break
        if level is None:
            st.fallbacks += 1
            return None
        caps = {t: int(self.capacities[t][level]) for t in self.node_types}
        verts = full
        ego_off, off = {}, 0
        for t in self.node_types:
            ego_off[t] = off
            off += caps[t]
        feats = {}
        for t in self.node_types:
            tab = self.features[t]
            rows = np.asarray(tab[verts[t]])
            st.feature_rows += int(verts[t].size)
            st.bytes_read += int(rows.nbytes)
            padded = np.zeros((caps[t],) + tab.shape[1:], dtype=tab.dtype)
            padded[: rows.shape[0]] = rows
            feats[t] = padded
        tables, specs = [], []
        for sg in self.sgs:
            dt = sg.dst_type
            rows_in = inner[dt]
            d_cap = self._d_cap(sg, rows_in)
            nbr_t = np.zeros((caps[dt], d_cap), dtype=np.int32)
            msk_t = np.zeros((caps[dt], d_cap), dtype=bool)
            ety_t = np.zeros((caps[dt], d_cap), dtype=np.int32)
            if rows_in.size:
                nbr, msk, ety, nbytes = slice_rows(sg, rows_in, width=d_cap)
                st.adjacency_rows += int(rows_in.size)
                st.bytes_read += nbytes
                pos = np.searchsorted(verts[dt], rows_in)
                nbr_t[pos] = self._remap(nbr, msk, verts, ego_off)
                msk_t[pos] = msk
                ety_t[pos] = ety
            tables.append((nbr_t, msk_t, ety_t))
            specs.append(EgoSgSpec(
                name=sg.name, src_types=tuple(sg.src_types), dst_type=dt,
                d_cap=d_cap, num_edge_types=int(sg.num_edge_types),
            ))
        out_rows = np.searchsorted(verts[self.label_type], idx).astype(np.int32)
        gl = dict(ego_globals or {})
        sig = EgoSignature(
            node_types=self.node_types,
            caps=tuple(caps[t] for t in self.node_types),
            label_type=self.label_type,
            out_capacity=int(idx.size),
            sgs=tuple(specs),
            global_keys=tuple(sorted(gl)),
        )
        return EgoBatch(sig, feats, tuple(tables), out_rows, gl)


def _host(x) -> np.ndarray:
    """A feature table as a host array: a tensor copied to the host once,
    an array (a memory-mapped view included) as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dirty_sets(dirty: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {
        t: np.unique(np.asarray(v, dtype=np.int64))
        for t, v in dirty.items()
        if np.asarray(v).size
    }


def _touches(full: Dict[str, np.ndarray], dsets: Dict[str, np.ndarray]) -> bool:
    return any(
        full.get(t) is not None and np.intersect1d(full[t], d, assume_unique=True).size
        for t, d in dsets.items()
    )


def _equalize_ladders(
    capacities: Dict[str, Sequence[int]], node_types: Tuple[str, ...]
) -> Dict[str, Tuple[int, ...]]:
    """Per-type ladders as ascending int tuples of EQUAL length (a short
    ladder repeats its top capacity), so one level indexes a capacity for
    every type."""
    norm = {}
    for t in node_types:
        if t not in capacities:
            raise ValueError(f"capacity ladder missing node type {t!r}")
        lad = tuple(sorted(int(c) for c in capacities[t]))
        if not lad or any(c < 1 for c in lad):
            raise ValueError(f"bad capacity ladder for {t!r}: {lad}")
        norm[t] = lad
    n = max(len(lad) for lad in norm.values())
    return {t: lad + (lad[-1],) * (n - len(lad)) for t, lad in norm.items()}
