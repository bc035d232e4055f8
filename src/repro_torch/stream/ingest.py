"""``StreamIngestor`` — the delta path for one served HGNN task (the port's
copy of the reference's ``stream/ingest.py``).

One ``ingest()`` call is one graph version bump, end to end:

  validate  ``HetGraph.validate_delta`` — O(batch) id/relation/dtype
            checks BEFORE any state changes; a bad batch is rejected with
            every problem listed and the served version untouched.
  fold      ``apply_to_graph`` — a NEW :class:`HetGraph` (old object and
            its SGB-cache fingerprint stay intact for version v).
  merge     ``repro_torch.stream.merge.apply_delta`` — clean slices are
            reused by object identity (their device tables included),
            dirty slices absorb into bucket slack or spill to a per-slice
            rebuild; ``MergeStats`` records which tier each slice took.
  session   a successor :class:`InferenceSession` over the merged stack:
            on a CUDA batch a new CUDA graph, captured while the
            predecessor may still be serving (the session captures in
            thread-local mode, so a serving thread's calls are not
            refused). Untouched node types keep the serving batch's
            device feature tensors and their host copies in the ego
            planner; the predecessor's ego closures (minus dirty ones) and
            captured ego graphs are carried over, so clean ego traffic on
            version v+1 never re-walks or recaptures.
  publish   ``GraphPlane.publish`` — prewarms the registered query ladder
            off to the side, then swaps with a pointer assignment.
            In-flight blocks finish on version v; new checkouts see v+1.
            Version v's device memory is reused only after the last replay
            that read it (``InferenceSession``'s stream bookkeeping).

Timings come off the injected ``Clock`` (``FakeClock`` in tests):
``t_merge`` is pure layout work — the number the reference's ≤ 0.2×
cold-rebuild bound is about — while ``t_session`` (warm-up and capture on
a card) and ``t_publish`` isolate the successor's cost.

A successor session takes its predecessor's ``mesh_info``: a version
served sharded over a device mesh stays sharded over the same mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch import from_host
from repro_torch.core.batch import GraphBatch
from repro_torch.core.ego import EgoPlanner
from repro_torch.core.hetgraph import HetGraph
from repro_torch.core.session import InferenceSession
from repro_torch.data.sgb_cache import structure_hash
from repro_torch.serve.clock import Clock, SystemClock
from repro_torch.serve.plane import GraphPlane
from repro_torch.stream.delta import DeltaLog, EdgeBatch, FeatureBatch, apply_to_graph
from repro_torch.stream.merge import MergeStats, apply_delta


@dataclasses.dataclass
class IngestReport:
    """What one ``ingest()`` did, for operators and benchmarks."""

    seq: int
    version: int
    num_edges: int
    structure_hash: str
    stats: MergeStats
    dirty: Dict[str, np.ndarray] = dataclasses.field(repr=False)
    t_merge: float = 0.0
    t_batch: float = 0.0
    t_session: float = 0.0
    t_publish: float = 0.0
    closures_carried: int = 0
    exes_adopted: int = 0

    @property
    def dirty_counts(self) -> Dict[str, int]:
        return {t: int(v.size) for t, v in self.dirty.items()}

    def summary(self) -> Dict[str, object]:
        return {
            "seq": self.seq,
            "version": self.version,
            "num_edges": self.num_edges,
            "t_merge_ms": round(self.t_merge * 1e3, 3),
            "t_batch_ms": round(self.t_batch * 1e3, 3),
            "t_session_ms": round(self.t_session * 1e3, 3),
            "t_publish_ms": round(self.t_publish * 1e3, 3),
            "dirty": self.dirty_counts,
            "closures_carried": self.closures_carried,
            "exes_adopted": self.exes_adopted,
            "merge": self.stats.summary(),
        }


class StreamIngestor:
    """Owns the live graph state for one served task.

    ``task`` supplies the model, params, and the builder arguments
    (``task.sgb_kind`` / ``task.sgb_args`` / ``task.metapaths`` — set by
    ``pipeline.prepare``) that the merge replays for bit-parity;
    ``session`` is the currently serving :class:`InferenceSession` built
    over ``task``'s layouts. The ingestor's ``plane`` is what serving
    code should be handed (``ServeFrontend(plane, ...)``); the ``task``
    object itself is left at the base version as the cold-build
    reference.

    ``closure_cache`` turns on the serving planner's closure LRU (when
    ego is enabled) so clean closures survive version swaps; ``0``
    disables carrying.
    """

    def __init__(
        self,
        task,
        session: InferenceSession,
        *,
        plane: Optional[GraphPlane] = None,
        clock: Optional[Clock] = None,
        closure_cache: int = 256,
    ):
        if not task.sgb_kind:
            raise ValueError(
                "task carries no sgb_kind/sgb_args — build it with "
                "pipeline.prepare() so the merge can replay the builders"
            )
        self.task = task
        self.clock = clock if clock is not None else SystemClock()
        self.log = DeltaLog()
        self.graph: HetGraph = task.graph
        self.sgs = list(task.sgs)
        self.session = session
        self.plane = plane if plane is not None else GraphPlane(session)
        self.closure_cache = int(closure_cache)
        planner = session.ego_planner
        if planner is not None and planner.closure_cache == 0:
            planner.closure_cache = self.closure_cache

    @property
    def version(self) -> int:
        return self.plane.version

    def ingest(
        self,
        edges: EdgeBatch,
        features: Optional[FeatureBatch] = None,
    ) -> IngestReport:
        """Apply one delta batch and publish the successor version."""
        # validate against the LIVE graph before touching any state — a
        # rejected batch must leave the log and the served version alone
        self.graph.validate_delta(edges)
        delta = self.log.append(edges, features)
        new_graph = apply_to_graph(self.graph, delta)

        t0 = self.clock.now()
        new_sgs, dirty, stats = apply_delta(
            self.sgs, self.graph, new_graph, delta,
            kind=self.task.sgb_kind, metapaths=self.task.metapaths,
            **self.task.sgb_args,
        )
        t_merge = self.clock.now() - t0

        t0 = self.clock.now()
        new_batch = self._successor_batch(new_graph, new_sgs, delta)
        t_batch = self.clock.now() - t0

        t0 = self.clock.now()
        new_session = InferenceSession(
            self.task.model, new_batch, self.session.flow, params=self.task.params,
            mesh_info=self.session.mesh_info,
        )
        carried, adopted = self._carry_ego(new_session, new_batch, new_graph, delta, dirty)
        t_session = self.clock.now() - t0

        t0 = self.clock.now()
        version = self.plane.publish(new_session)
        t_publish = self.clock.now() - t0

        self.graph, self.sgs, self.session = new_graph, new_sgs, new_session
        return IngestReport(
            seq=delta.seq,
            version=version,
            num_edges=delta.num_edges,
            structure_hash=structure_hash(new_graph),
            stats=stats,
            dirty=dirty,
            t_merge=t_merge,
            t_batch=t_batch,
            t_session=t_session,
            t_publish=t_publish,
            closures_carried=carried,
            exes_adopted=adopted,
        )

    def _successor_batch(self, new_graph, new_sgs, delta) -> GraphBatch:
        """The successor's :class:`GraphBatch` — node types the delta did
        not touch keep the SERVING batch's device feature tensors (no
        upload); touched types are uploaded from the new host tables."""
        old = self.session.graph_batch
        feats = {}
        for t in old.node_types:
            if t in delta.features:
                feats[t] = from_host(np.asarray(new_graph.features[t], np.float32), old.device)
            else:
                feats[t] = old.features[t]
        return GraphBatch.from_graph(new_graph, new_sgs, old.device, features=feats)

    def _carry_ego(
        self, new_session, new_batch, new_graph, delta, dirty
    ) -> Tuple[int, int]:
        """Ego continuity across the swap: a fresh planner over the merged
        layouts adopts the predecessor's clean closures and the successor
        session adopts every captured ego graph — signatures are
        value-hashed shape statics, so clean traffic does not recapture
        (``DISPATCH["ego_traces"]`` is the proof). The planner takes the
        predecessor's host feature arrays for the types the delta did not
        touch (no download of the device tables) and the new host tables
        for the touched ones."""
        old_planner = self.session.ego_planner
        if old_planner is None:
            return 0, 0
        host = {
            t: (np.asarray(new_graph.features[t], np.float32) if t in delta.features
                else old_planner.features[t])
            for t in old_planner.node_types
        }
        planner = EgoPlanner(
            new_batch,
            depth=old_planner.depth,
            features=host,
            capacities=old_planner.capacities,
            closure_cache=self.closure_cache,
        )
        carried = planner.carry_from(old_planner, dirty)
        new_session.enable_ego(planner=planner)
        adopted = new_session.adopt_ego_cache(self.session)
        return carried, adopted


def replay(ingestor: StreamIngestor, deltas: Sequence) -> list:
    """Apply a sequence of ``(edges, features)`` pairs (or bare edge
    dicts) in order; returns the reports. Convenience for benchmarks and
    the ``--deltas`` serving example."""
    reports = []
    for d in deltas:
        if isinstance(d, tuple):
            edges, features = d
        else:
            edges, features = d, None
        reports.append(ingestor.ingest(edges, features))
    return reports
