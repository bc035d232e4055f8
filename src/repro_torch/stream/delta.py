"""Typed graph deltas and the append-only delta log (the port's copy of
the reference's ``stream/delta.py``, host numpy only).

A :class:`GraphDelta` is one atomic batch of structural edge inserts
(``{rel_name: (src_ids, dst_ids)}``, ids local to their node types) plus
optional node-feature row updates (``{node_type: (rows, values)}``).
Deltas are *additive only*: no node inserts, no deletions — the padded-CSC
merge contract (see ``repro_torch.stream.merge``) leans on monotonicity,
and the serving planes key everything on stable ``num_nodes``.

:class:`DeltaLog` is the monotonically sequenced append-only record of
every batch an ingestor has accepted; ``seq`` numbers line up with the
``GraphPlane`` versions the merged layouts are published under, so an
operator can answer "which edges are in version v?" by replaying the log
prefix.

:func:`apply_to_graph` folds a delta into a **new** :class:`HetGraph` —
never mutating the old one — because the SGB cache fingerprint
(``sgb_cache.structure_hash``) is memoized per graph object: a fresh
object re-fingerprints, so a delta'd graph can never alias the pre-delta
cache entry, and the version-v graph stays alive for in-flight serving.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.hetgraph import HetGraph

EdgeBatch = Mapping[str, Tuple[np.ndarray, np.ndarray]]
FeatureBatch = Mapping[str, Tuple[np.ndarray, np.ndarray]]


def _freeze_edges(edges: EdgeBatch) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    out = {}
    for name, (src, dst) in edges.items():
        out[name] = (
            np.ascontiguousarray(src, dtype=np.int64),
            np.ascontiguousarray(dst, dtype=np.int64),
        )
    return out


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """One atomic batch of edge inserts + feature row updates.

    ``edges[rel] = (src, dst)`` appends edges to an existing relation;
    ``features[t] = (rows, values)`` overwrites feature rows of node type
    ``t`` (``values.shape == (len(rows), F_t)``). ``seq`` is assigned by
    the :class:`DeltaLog` (-1 = unlogged).
    """

    edges: Dict[str, Tuple[np.ndarray, np.ndarray]]
    features: Dict[str, Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default_factory=dict
    )
    seq: int = -1

    @property
    def num_edges(self) -> int:
        return sum(len(src) for src, _ in self.edges.values())

    def dirty_targets(self) -> Dict[str, np.ndarray]:
        """Per-relation sorted unique destination ids the batch touches —
        the seed of the dirty set the merge propagates to layouts and ego
        closures."""
        return {
            name: np.unique(dst) for name, (_, dst) in self.edges.items()
        }


class DeltaLog:
    """Append-only, monotonically sequenced record of accepted deltas.

    ``append`` stamps the next ``seq`` (starting at ``base_seq + 1``) and
    returns the frozen :class:`GraphDelta`. The log never reorders or
    drops entries; ``since(seq)`` replays the strict suffix, which is what
    a follower rebuilding layouts from a checkpointed version needs.
    """

    def __init__(self, base_seq: int = 0):
        self._entries: List[GraphDelta] = []
        self._seq = int(base_seq)

    def append(
        self,
        edges: EdgeBatch,
        features: Optional[FeatureBatch] = None,
    ) -> GraphDelta:
        self._seq += 1
        delta = GraphDelta(
            edges=_freeze_edges(edges),
            features={
                t: (
                    np.ascontiguousarray(rows, dtype=np.int64),
                    np.asarray(vals),
                )
                for t, (rows, vals) in (features or {}).items()
            },
            seq=self._seq,
        )
        self._entries.append(delta)
        return delta

    @property
    def seq(self) -> int:
        """Sequence number of the newest entry (``base_seq`` if empty)."""
        return self._seq

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self) -> Iterator[GraphDelta]:
        return iter(self._entries)

    def since(self, seq: int) -> List[GraphDelta]:
        """Entries with ``entry.seq > seq``, in append order."""
        return [d for d in self._entries if d.seq > seq]


def apply_to_graph(g: HetGraph, delta: GraphDelta) -> HetGraph:
    """Fold a delta into a NEW :class:`HetGraph` (structural append +
    feature row overwrite). Untouched edge lists and feature tables are
    shared by reference; touched ones are copied. The old graph object —
    and its memoized cache fingerprint — is left intact."""
    edges = dict(g.edges)
    for name, (src, dst) in delta.edges.items():
        if name not in edges:
            raise KeyError(f"delta relation {name!r} unknown to graph")
        osrc, odst = edges[name]
        edges[name] = (
            np.concatenate([np.asarray(osrc, np.int64), src]),
            np.concatenate([np.asarray(odst, np.int64), dst]),
        )
    features = dict(g.features)
    for t, (rows, vals) in delta.features.items():
        if t not in features:
            raise KeyError(f"delta feature type {t!r} unknown to graph")
        tab = np.array(features[t], copy=True)
        tab[rows] = np.asarray(vals, dtype=tab.dtype)
        features[t] = tab
    return HetGraph(
        node_types=g.node_types,
        num_nodes=g.num_nodes,
        features=features,
        relations=g.relations,
        edges=edges,
        label_type=g.label_type,
        labels=g.labels,
        num_classes=g.num_classes,
    )
