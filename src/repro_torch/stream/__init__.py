"""``repro_torch.stream`` — incremental SGB delta ingestion under live
traffic (the port's copy of the reference's ``stream/``).

Streamed edge inserts (and node-feature updates) against a served
bucketed semantic-graph stack, merge-upgraded instead of rebuilt cold:
``delta`` (typed deltas and the append-only log), ``merge`` (the clean /
absorb / spill / full-rebuild merge engine with its bit-parity contract)
and ``ingest`` (validate → merge → successor session → ``GraphPlane``
publish). On a card each successor session is a new CUDA graph over the
merged tables, captured while its predecessor serves.
"""
from repro_torch.stream.delta import DeltaLog, GraphDelta, apply_to_graph
from repro_torch.stream.ingest import IngestReport, StreamIngestor, replay
from repro_torch.stream.merge import MergeStats, apply_delta

__all__ = [
    "DeltaLog",
    "GraphDelta",
    "IngestReport",
    "MergeStats",
    "StreamIngestor",
    "apply_delta",
    "apply_to_graph",
    "replay",
]
