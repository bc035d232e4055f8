"""``InferenceSession`` — the serving entry point, one program per call.

A session binds one model, one ``GraphBatch`` and one ``FlowConfig``. Like
the reference's, it builds its program once, at construction, against
example ``params``:

  * on a CUDA batch the whole forward ``model.apply(params, batch, flow)``
    is captured as one CUDA graph (the counterpart of the reference's AOT
    executable). The session clones the example params into static input
    tensors it owns, runs the eager forward once on a side stream (which
    fills every lazy device cache and builds the kernel library), then
    captures the forward into a memory pool of its own (so no other
    session's replay reuses the buffers its kernels write). A call copies
    its params into the static inputs (one ``torch._foreach_copy_``) and
    replays the graph: no Python NA dispatch, no kernel wrapper runs, so
    the launch counters (``flows.DISPATCH``, the kernels' ``LAUNCHES``)
    tick at the warm-up and at the capture, never on a replay. A capture
    that fails raises; the session never gives way to the eager forward;
  * on a CPU batch it runs the same eager forward under
    ``torch.inference_mode()`` on every call.

The program is specialized to the example params' names, shapes and
dtypes: a params mapping that differs in any of them raises
``ValueError``, never a silent recapture. Entry points:

  * ``session(params)`` — ``(num_targets, num_classes)`` logits, a fresh
    tensor: a call never writes to a caller's tensor, and a later call
    never changes an earlier call's result;
  * ``session.query(params, idx)`` — the logits rows of one padded query
    block: the forward, then an ``index_select`` on the device, so the rows
    are bit-identical to ``session(params)[idx]``; an id outside
    ``[0, num_targets)`` raises ``IndexError`` before any launch;
  * ``session.batch(params_list)`` — one forward per parameter set, each
    result its own tensor;
  * ``compile_query(capacity)`` / ``prewarm(capacities)`` record the block
    capacities of a query ladder (the gather needs no program of its own)
    and ``query_capacities`` lists them;
  * ``cost_analysis()`` is ``None``: there is no compiler estimate.

``params`` is a flat mapping of parameter name to tensor, as
``dict(model.named_parameters())`` gives it.
"""
from __future__ import annotations

from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core import flows
from repro_torch.core.batch import GraphBatch
from repro_torch.core.flows import FlowConfig

ParamSpec = Tuple[Tuple[str, Tuple[int, ...], torch.dtype], ...]


def param_spec(params: Mapping[str, torch.Tensor]) -> ParamSpec:
    """What a session's program is specialized to: each parameter's name,
    shape and dtype, in name order. Hashable."""
    return tuple(sorted((n, tuple(t.shape), t.dtype) for n, t in params.items()))


def _gather(out: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return out.index_select(0, idx)


class InferenceSession:
    """One model forward over one batch under one flow, built once (a CUDA
    graph on a CUDA batch) and served many times."""

    def __init__(
        self,
        model,
        batch: GraphBatch,
        flow: FlowConfig = FlowConfig(),
        params: Optional[Mapping[str, torch.Tensor]] = None,
    ):
        if params is None:
            raise ValueError("InferenceSession needs example params to build its program against")
        self.model = model
        self.graph_batch = batch
        self.flow = flow
        self._spec = param_spec(params)
        self._capacities: set = set()
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        if batch.device.type == "cuda":
            self._capture(params)

    def _capture(self, params) -> None:
        """Static inputs, one eager warm-up forward on a side stream, then
        the forward captured into a private pool. Raises if it cannot."""
        dev = self.graph_batch.device
        self._names = tuple(name for name, _, _ in self._spec)
        with torch.no_grad():
            self._inputs = [params[n].detach().clone() for n in self._names]
        static = dict(zip(self._names, self._inputs))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.inference_mode():
            self.model.apply(static, self.graph_batch, self.flow)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(graph):
            out = self.model.apply(static, self.graph_batch, self.flow)
        self._graph, self._out = graph, out

    def _check(self, params) -> None:
        got = param_spec(params)
        if got != self._spec:
            want = {n: (s, d) for n, s, d in self._spec}
            have = {n: (s, d) for n, s, d in got}
            raise ValueError(
                "params do not match the session's program: missing "
                f"{sorted(set(want) - set(have))}, unexpected {sorted(set(have) - set(want))}, "
                f"shape or dtype differs for {sorted(n for n in set(want) & set(have) if want[n] != have[n])}"
            )

    def _forward(self, params) -> torch.Tensor:
        """The forward's output: the graph's static output after a replay
        (valid until the next replay), or a fresh eager result."""
        self._check(params)
        with torch.inference_mode():
            if self._graph is None:
                return self.model.apply(params, self.graph_batch, self.flow)
            torch._foreach_copy_(self._inputs, [params[n] for n in self._names])
            self._graph.replay()
            return self._out

    def __call__(self, params) -> torch.Tensor:
        """(num_targets, num_classes) logits, a tensor of the caller's own."""
        out = self._forward(params)
        if self._graph is None:
            return out
        with torch.inference_mode():
            return out.clone()

    def batch(self, params_list: Sequence) -> List[torch.Tensor]:
        """One forward per parameter set (an ensemble, A/B weights), each
        result its own tensor."""
        return [self(p) for p in params_list]

    def compile_query(self, capacity: int) -> Callable:
        """The gather serving ``(capacity,)`` query blocks; records the
        capacity."""
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"query capacity must be >= 1, got {capacity}")
        self._capacities.add(capacity)
        return _gather

    def query(self, params, idx) -> torch.Tensor:
        """Logits for one padded query block: ``idx`` is a 1-D vector of
        target ids (its length is the block capacity); the result is the
        ``(len(idx), num_classes)`` rows of ``session(params)[idx]``. Padded
        slots should repeat a valid id; callers discard their rows.

        An id outside ``[0, num_targets)`` raises ``IndexError`` naming the
        bad ids, before any launch (the reference's gather wraps a negative
        id and clamps a large one without a word). Ids given on the host (a
        sequence, a numpy array, a CPU tensor) are checked there; a CUDA id
        tensor costs one reduction on the device and one synchronize."""
        idx = torch.as_tensor(idx, dtype=torch.long)
        if idx.dim() != 1:
            raise ValueError(
                f"query block must be a 1-D id vector, got shape {tuple(idx.shape)}"
            )
        n = self.graph_batch.num_targets
        if idx.numel():
            lo, hi = torch.stack(torch.aminmax(idx)).tolist()
            if lo < 0 or hi >= n:
                bad = idx[(idx < 0) | (idx >= n)].tolist()
                raise IndexError(f"query ids outside [0, {n}): {bad}")
        idx = idx.to(self.graph_batch.device)
        gather = self.compile_query(idx.shape[0])
        out = self._forward(params)
        flows.DISPATCH["query_calls"] += 1
        with torch.inference_mode():
            return gather(out, idx)

    def prewarm(self, capacities: Sequence[int]) -> "InferenceSession":
        """Record every capacity of a query ladder. Returns self."""
        for cap in capacities:
            self.compile_query(cap)
        return self

    @property
    def query_capacities(self) -> Tuple[int, ...]:
        """The capacities recorded by ``compile_query``, ascending."""
        return tuple(sorted(self._capacities))

    @property
    def captured(self) -> bool:
        """Whether calls replay a captured CUDA graph (a CUDA batch)."""
        return self._graph is not None

    def cost_analysis(self):
        """The reference returns XLA's per-call estimate, or ``None`` where
        its backend has none. A CUDA graph carries no compiler estimate, so
        this is ``None``."""
        return None

    @property
    def out_shape(self) -> Tuple[int, int]:
        """Forward-output shape ``(num_targets, num_classes)``."""
        return (self.graph_batch.num_targets, self.model.num_classes)

    def __repr__(self):
        return (
            f"InferenceSession(flow={self.flow.flow!r}, "
            f"device={self.graph_batch.device}, captured={self.captured})"
        )
