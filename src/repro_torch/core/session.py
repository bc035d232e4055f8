"""``InferenceSession`` — the serving entry point.

A session binds one model, one ``GraphBatch`` and one ``FlowConfig``, and
runs the forward pass eagerly under ``torch.inference_mode()``:

  * ``session(params)`` — ``(num_targets, num_classes)`` logits, the same
    program as ``model.apply(params, batch, flow)``;
  * ``session.query(params, idx)`` — the logits rows of one padded query
    block: the full forward, then an ``index_select``, so the rows are
    bit-identical to ``session(params)[idx]``;
  * ``compile_query(capacity)`` and ``prewarm(capacities)`` check a block
    capacity or a ladder of them before traffic. The eager forward
    compiles nothing, so they build nothing; ``out_shape`` is the forward's
    output shape.

``params`` is a flat mapping of parameter name to tensor on the batch's
device, as ``dict(model.named_parameters())`` gives it.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from repro_torch.core import flows
from repro_torch.core.batch import GraphBatch
from repro_torch.core.flows import FlowConfig


def _gather(out: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return out.index_select(0, idx)


class InferenceSession:
    """One model forward over one batch under one flow, served many times."""

    def __init__(self, model, batch: GraphBatch, flow: FlowConfig = FlowConfig()):
        self.model = model
        self.graph_batch = batch
        self.flow = flow

    def __call__(self, params) -> torch.Tensor:
        """(num_targets, num_classes) logits."""
        with torch.inference_mode():
            return self.model.apply(params, self.graph_batch, self.flow)

    def compile_query(self, capacity: int) -> Callable:
        """The gather serving ``(capacity,)`` query blocks."""
        if int(capacity) < 1:
            raise ValueError(f"query capacity must be >= 1, got {capacity}")
        return _gather

    def query(self, params, idx) -> torch.Tensor:
        """Logits for one padded query block: ``idx`` is a 1-D vector of
        target ids (its length is the block capacity); the result is the
        ``(len(idx), num_classes)`` rows of ``session(params)[idx]``. Padded
        slots should repeat a valid id; callers discard their rows."""
        idx = torch.as_tensor(idx, dtype=torch.long, device=self.graph_batch.device)
        if idx.dim() != 1:
            raise ValueError(
                f"query block must be a 1-D id vector, got shape {tuple(idx.shape)}"
            )
        gather = self.compile_query(idx.shape[0])
        out = self(params)
        flows.DISPATCH["query_calls"] += 1
        with torch.inference_mode():
            return gather(out, idx)

    def prewarm(self, capacities: Sequence[int]) -> "InferenceSession":
        """Check every capacity of a query ladder. Returns self."""
        for cap in capacities:
            self.compile_query(cap)
        return self

    @property
    def out_shape(self) -> Tuple[int, int]:
        """Forward-output shape ``(num_targets, num_classes)``."""
        return (self.graph_batch.num_targets, self.model.num_classes)

    def __repr__(self):
        return (
            f"InferenceSession(flow={self.flow.flow!r}, "
            f"device={self.graph_batch.device})"
        )
