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
    session's replay reuses the buffers its kernels write), one capture at
    a time in the process and in thread-local mode, so other threads keep
    serving while a session (a graph version's successor) is captured. A
    call copies its params into the static inputs (one
    ``torch._foreach_copy_``) and replays the graph: no Python NA
    dispatch, no kernel wrapper runs, so the launch counters
    (``flows.DISPATCH``, the kernels' ``LAUNCHES``) tick at the warm-up and
    at the capture, never on a replay. A capture that fails raises; the
    session never gives way to the eager forward;
  * on a CPU batch it runs the same eager forward under
    ``torch.inference_mode()`` on every call.

The program is specialized to the example params' names, shapes and
dtypes: a params mapping that differs in any of them raises
``ValueError``, never a silent recapture.

A captured session is shared state: every call copies into the same static
inputs and replays into the same static output. So a call runs copy →
replay → read-out (the clone or the gather) under the session's lock, on
the caller's current stream, and when that stream is not the one the
previous call ran on, it first waits for that one: replays of one session
are serialized on the card whichever threads and streams call it, and a
caller that stays on one stream (the serving front-end's stepper) pays no
cross-stream wait. The device tensors a replay reads outside its pool
(static inputs, features, tables) are marked used on every stream a call
runs on, so the memory of a dropped session (a retired graph version) is
handed out again only after its last replay has ended. Host query ids go
to the card through pinned memory, asynchronously: a call does not wait
for an earlier call's forward.
``forwards`` counts the forwards run through this session object (graph
replays on a CUDA batch).
Entry points:

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
  * ``enable_ego(...)`` attaches an ``EgoPlanner`` (``core/ego.py``) and
    ``session.query_ego(params, idx)`` serves a block on its targets'
    extracted neighborhood: one program per ``EgoSignature``, on a CUDA
    batch a CUDA graph captured at the signature's first query (static
    inputs: the params, one byte buffer holding the extracted arrays, the
    injected ``ego_globals``; a warm-up on a side stream, then the capture
    into a private pool), on a CPU batch the eager forward. A call copies
    the extracted arrays through one pinned buffer into the graph's static
    inputs and replays it, on the caller's stream under the graph's own
    lock, ordered as ``_run`` orders a session's calls; a replay ticks no
    launch or dispatch counter. An id outside ``[0, num_targets)`` raises
    ``IndexError`` before any extraction (the reference wraps a negative
    id and fails inside the extraction on a large one). A block whose
    closure outgrows the planner's top capacity is served by ``query``.

``params`` is a flat mapping of parameter name to tensor, as
``dict(model.named_parameters())`` gives it.

A session resolves the ambient device mesh once, at build
(``mesh_info``, default ``distributed.sharding.graph_mesh()``), and runs
its forward pinned to it (``flows.mesh_scope(pinned=...)``): under a mesh
its ``fused_kernel`` NA runs one launch per shard and one all-gather, and
the captured graph holds that all-gather (warmed up first, which creates
the communicator). Every rank of the mesh must build and call the session
alike. Ego programs run on one device, pinned to no mesh.

``donate_params=True`` marks a session for weight streaming
(``serve.WeightPlane(stream=True)`` hands it fresh tensors per call). A
CUDA graph cannot take a caller's buffers, so the session copies the params
into its static inputs, as every session does, and keeps no reference to
them. The reference's donation also invalidates the caller's arrays; that
has no counterpart here: the caller's tensors stay valid. So the flag
changes no program: ``with_donation`` gives a second handle on the same
captured graph, static buffers and lock (``HGNNTask.compile`` uses it), and
only the serving front-end reads the flag.
"""
from __future__ import annotations

import contextlib
import copy
import threading
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import flows
from repro_torch.core.batch import GraphBatch
from repro_torch.core.ego import EgoBatch, EgoPlanner
from repro_torch.core.flows import FlowConfig
from repro_torch.distributed import sharding as dist

ParamSpec = Tuple[Tuple[str, Tuple[int, ...], torch.dtype], ...]


def param_spec(params: Mapping[str, torch.Tensor]) -> ParamSpec:
    """What a session's program is specialized to: each parameter's name,
    shape and dtype, in name order. Hashable."""
    return tuple(sorted((n, tuple(t.shape), t.dtype) for n, t in params.items()))


def _gather(out: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return out.index_select(0, idx)


_UNSET = object()


def mesh_fingerprint(gm) -> Optional[Tuple]:
    """Hashable identity of a resolved ``dist.graph_mesh()`` result, for
    keying session caches: ``None`` (no mesh) or ``(mesh, axis, size)``."""
    if gm is None:
        return None
    mesh, axis, n = gm
    return (mesh, axis, n)


# One capture at a time in the process: entering a capture synchronizes
# the device and empties the allocator's cache, which must not meet another
# thread's capture in progress. Every capture warms up on one side stream
# per device: cuBLAS keeps a workspace for each stream it has run on for the
# life of the process, so a fresh stream a capture (a graph version's
# successor) would hold 32 MiB more each time.
_CAPTURE_LOCK = threading.Lock()
_WARMUP_STREAMS: dict = {}


def _capture_graph(forward: Callable[[], object], device: torch.device, inference: bool = True):
    """``(graph, out)``: ``forward`` run once eagerly on the device's
    warm-up stream (which fills every lazy device cache, initializes a
    process group's communicator and builds the kernels), then captured as
    a CUDA graph into a private pool. The capture is thread-local: other
    threads may replay, allocate, copy and synchronize meanwhile (a
    successor captured while its predecessor serves, a training step
    captured while another tenant is served), and only this thread is held
    to the capture's rules. Both runs are under ``torch.inference_mode()``
    unless ``inference=False`` (a training step, which differentiates).
    Raises if the capture fails. Every capture of the port goes through
    here: sessions, ego graphs, ``TrainStep`` and ``DecodeStep``; each
    records the build spans ``warmup`` and ``capture``."""
    mode = torch.inference_mode if inference else contextlib.nullcontext
    with _CAPTURE_LOCK:
        side = _WARMUP_STREAMS.get(device)
        if side is None:
            side = _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with trace.span("warmup", always=True), torch.cuda.stream(side), mode():
            forward()
            side.synchronize()  # the warm-up's device work is the warm-up's
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with trace.span("capture", always=True):
            with mode(), torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = forward()
    return graph, out


def _device_tensors(obj, out: list) -> list:
    """Every CUDA tensor in ``obj``, a tensor or nested tuples, lists and
    dict values of them."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _device_tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _device_tensors(x, out)
    return out


def sg_tensors(sg) -> list:
    """The device tensors cached on one semantic graph: its tables
    (``_device``), its grouped layouts' (``_dev``) and its sharded
    layouts' (their own ``_dev`` and each shard's)."""
    devs = [lay._dev for lay in getattr(sg, "_grouped", {}).values()]
    for sl in getattr(sg, "_sharded", {}).values():
        devs += [sl._dev] + [sh._dev for sh in sl.shards]
    return _device_tensors([sg._device, *devs], [])


def _batch_tensors(batch: GraphBatch) -> list:
    """The device tensors of a batch that its captured forward reads: the
    feature tensors and the semantic graphs' cached device tables (filled
    at the warm-up)."""
    return _device_tensors(batch.features, []) + [t for sg in batch.sgs for t in sg_tensors(sg)]


class _Serial:
    """What orders the calls of one captured program, shared by every
    handle on it: the lock and the stream the last call ran on.

    It also holds the device tensors a replay reads outside the graph's
    private pool (static inputs, features, tables), and marks each as used
    on every stream a call runs on (``record_stream``): when the program
    is dropped (a retired graph version), the caching allocator hands
    their memory out again only after the work queued on those streams
    has ended, the last replay included. The pool itself is returned to
    the device only by a synchronizing free."""

    def __init__(self, stream: torch.cuda.Stream, held: Sequence[torch.Tensor]):
        self.lock, self.stream = threading.Lock(), stream
        self._held, self._used = tuple(held), set()
        self._use(stream)

    def _use(self, stream: torch.cuda.Stream) -> None:
        if stream not in self._used:
            self._used.add(stream)
            for t in self._held:
                t.record_stream(stream)

    def follow(self, stream: torch.cuda.Stream) -> None:
        """Under ``lock``, before a call's work on ``stream``: order it
        after the previous call's stream."""
        if stream != self.stream:
            stream.wait_stream(self.stream)
            self.stream = stream
            self._use(stream)


class InferenceSession:
    """One model forward over one batch under one flow, built once (a CUDA
    graph on a CUDA batch) and served many times."""

    def __init__(
        self,
        model,
        batch: GraphBatch,
        flow: FlowConfig = FlowConfig(),
        params: Optional[Mapping[str, torch.Tensor]] = None,
        donate_params: bool = False,
        mesh_info=_UNSET,
    ):
        if params is None:
            raise ValueError("InferenceSession needs example params to build its program against")
        if mesh_info is _UNSET:
            # the session's one mesh resolution: its forward runs pinned to it
            mesh_info = dist.graph_mesh()
        self.mesh_info = mesh_info
        self.model = model
        self.graph_batch = batch
        self.flow = flow
        self.donate_params = bool(donate_params)
        self._spec = param_spec(params)
        self._capacities: set = set()
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._stages: Optional[trace.Stages] = None  # device stages (trace.stage_ms)
        self.forwards = 0
        # ego serving: the planner, one program per EgoSignature, and the
        # ego globals of the last params seen (by tensor and version)
        self._ego = None
        self._ego_exes: dict = {}
        self._ego_globals_cache = None
        if batch.device.type == "cuda":
            self._capture(params)
            self._serial = _Serial(
                torch.cuda.current_stream(batch.device), self._inputs + _batch_tensors(batch)
            )

    def with_donation(self, donate_params: bool) -> "InferenceSession":
        """A handle on this session's program (its graph, static buffers and
        lock) whose ``donate_params`` is the one given; its query ladder
        and ``forwards`` start empty."""
        other = copy.copy(self)
        other.donate_params = bool(donate_params)
        other._capacities, other.forwards = set(), 0
        return other

    def _capture(self, params) -> None:
        """Static inputs, then the forward warmed up and captured
        (``_capture_graph``). Raises if it cannot."""
        self._names = tuple(name for name, _, _ in self._spec)
        with torch.no_grad():
            self._inputs = [params[n].detach().clone() for n in self._names]
        static = dict(zip(self._names, self._inputs))
        with trace.stages_of_capture() as stages:
            self._graph, self._out = _capture_graph(
                lambda: self._forward(static), self.graph_batch.device
            )
        self._stages = stages

    def _forward(self, params) -> torch.Tensor:
        """The eager forward, pinned to the mesh resolved at build."""
        with flows.mesh_scope(pinned=self.mesh_info):
            return self.model.apply(params, self.graph_batch, self.flow)

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

    def _run(self, params, read_out: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """``read_out(forward output)``: on a captured session, the copy of
        ``params`` into the static inputs, the replay and ``read_out`` run on
        the caller's stream under the session's lock, after the stream of
        the previous call (module docstring); otherwise the eager forward,
        then ``read_out``. Tracing off (no ``trace.enable()``, no profiler
        recording, no device stages) costs this call one check; otherwise
        :meth:`_run_traced` runs it."""
        if self._stages is not None or trace.recording():
            return self._run_traced(params, read_out)
        self._check(params)
        with torch.inference_mode():
            if self._graph is None:
                self.forwards += 1
                return read_out(self._forward(params))
            serial = self._serial
            with serial.lock:
                serial.follow(torch.cuda.current_stream(self.graph_batch.device))
                torch._foreach_copy_(self._inputs, [params[n] for n in self._names])
                self._graph.replay()
                self.forwards += 1
                return read_out(self._out)

    def _run_traced(self, params, read_out: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """:meth:`_run` with its spans: ``session.call`` holding
        ``session.check``, ``session.copy_in``, ``session.replay`` and
        ``session.read_out``. A session captured under device tracing also
        records its call's events (``trace.stage_ms``) whatever the
        switch."""
        with trace.span("session.call"):
            with trace.span("session.check"):
                self._check(params)
            with torch.inference_mode():
                if self._graph is None:
                    self.forwards += 1
                    return read_out(self._forward(params))
                serial, st = self._serial, self._stages
                with serial.lock:
                    stream = torch.cuda.current_stream(self.graph_batch.device)
                    serial.follow(stream)
                    with trace.span("session.copy_in"):
                        if st is not None:
                            st.point(0, stream)
                        torch._foreach_copy_(self._inputs, [params[n] for n in self._names])
                    with trace.span("session.replay"):
                        if st is not None:
                            st.point(1, stream)
                        self._graph.replay()
                        if st is not None:
                            st.point(2, stream)
                    self.forwards += 1
                    with trace.span("session.read_out"):
                        out = read_out(self._out)
                        if st is not None:
                            st.point(3, stream)
                    return out

    def __call__(self, params) -> torch.Tensor:
        """(num_targets, num_classes) logits, a tensor of the caller's own."""
        return self._run(params, lambda out: out if self._graph is None else out.clone())

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
        gather = self.compile_query(idx.shape[0])
        dev = self.graph_batch.device
        if dev.type == "cuda" and idx.device.type == "cpu":
            idx = idx.pin_memory()  # an asynchronous copy, on the caller's stream

        def read_out(out):
            return gather(out, idx.to(dev, non_blocking=True))

        rows = self._run(params, read_out)
        flows.DISPATCH["query_calls"] += 1
        return rows

    def prewarm(self, capacities: Sequence[int]) -> "InferenceSession":
        """Record every capacity of a query ladder. Returns self."""
        for cap in capacities:
            self.compile_query(cap)
        return self

    # -- ego-subgraph serving -----------------------------------------------

    def enable_ego(self, planner=None, **planner_kw) -> "InferenceSession":
        """Attach an :class:`~repro_torch.core.ego.EgoPlanner` for
        ``query_ego``. With no ``planner``, builds one over this session's
        batch with ``depth = model.num_layers`` (``capacities``,
        ``features``, ``sample_sizes``, ``seed``, … pass through). Returns
        self."""
        if planner is None:
            depth = getattr(self.model, "num_layers", None)
            if depth is None:
                raise ValueError(
                    "model exposes no num_layers; pass an EgoPlanner "
                    "built with an explicit depth"
                )
            planner = EgoPlanner(self.graph_batch, depth=depth, **planner_kw)
        self._ego = planner
        return self

    @property
    def ego_planner(self):
        """The attached planner (``None`` until ``enable_ego``)."""
        return self._ego

    def _ego_globals_for(self, params):
        """``model.ego_globals`` cached per weight version: the name, the
        tensor and its in-place version counter of every parameter, so an
        in-place update (``mul_``, an optimizer step) or a key reassigned
        in the same mapping computes it anew. (The reference keys on the
        params object alone, and serves a stale β after its keys are
        reassigned.) Parameters that are inference tensors carry no
        version counter; with one of them nothing is cached. A front-end
        routing weight versions caches per version itself and passes the
        result in."""
        tensors = tuple(params[n] for n in sorted(params))
        if any(t.is_inference() for t in tensors):
            return self.model.ego_globals(params, self.graph_batch, self.flow)
        token = tuple((n, t._version) for n, t in zip(sorted(params), tensors))
        ent = self._ego_globals_cache
        if ent is None or ent[0] != token or any(a is not b for a, b in zip(ent[1], tensors)):
            # the entry holds the tensors, so no id is reused while cached
            ent = (token, tensors, self.model.ego_globals(params, self.graph_batch, self.flow))
            self._ego_globals_cache = ent
        return ent[2]

    def compile_ego(self, ego_batch, params):
        """The program of ``ego_batch``'s signature, ``exe(params, batch)
        -> model.apply(params, batch, flow)[batch.out_rows]``, built at the
        signature's first batch and cached: on a CUDA batch a CUDA graph
        captured against ``params`` and ``ego_batch`` (raises if it cannot),
        on a CPU batch the eager forward. Counted in
        ``DISPATCH["ego_traces"]``."""
        exe = self._ego_exes.get(ego_batch.sig)
        if exe is None:
            flows.DISPATCH["ego_traces"] += 1
            if self.graph_batch.device.type == "cuda":
                exe = _EgoGraph(self.model, self.flow, ego_batch, params, self.graph_batch.device)
            else:
                exe = _EagerEgo(self.model, self.flow)
            self._ego_exes[ego_batch.sig] = exe
        return exe

    def adopt_ego_cache(self, other: "InferenceSession") -> int:
        """Adopt ``other``'s ego programs (a graph-version swap). A program
        reads nothing of its session's graph: every table comes in with the
        ego batch, and a captured graph carries its own static inputs and
        lock, so it serves this session's params, never ``other``'s. Needs
        the same model object, an equal flow and the same device; entries
        already here are kept. Returns how many were adopted
        (``ego_traces`` does not tick)."""
        if (
            other.model is not self.model
            or other.flow != self.flow
            or other.graph_batch.device != self.graph_batch.device
        ):
            raise ValueError(
                "ego programs are only portable between sessions "
                "sharing the model object, flow config and device"
            )
        adopted = 0
        for sig, exe in other._ego_exes.items():
            if sig not in self._ego_exes:
                self._ego_exes[sig] = exe
                adopted += 1
        return adopted

    def query_ego(self, params, idx, ego_globals=_UNSET) -> torch.Tensor:
        """Logits for one padded query block, the forward run on the
        extracted L-hop neighborhood of ``idx``: the contract of
        :meth:`query`, within 1e-5 of its rows (another program over the
        same arithmetic). An id outside ``[0, num_targets)`` raises
        ``IndexError`` before any extraction. A block whose closure outgrows
        the planner's top capacity is served by :meth:`query`
        (``DISPATCH["ego_fallback"]``); one whose ego tables are all at most
        ``prune_k`` wide takes the §4.3 bypass on every graph
        (``DISPATCH["ego_bypass"]``). ``ego_globals`` defaults to the
        model's, computed once per params object."""
        if self._ego is None:
            raise RuntimeError("ego path not enabled: call session.enable_ego() first")
        if isinstance(idx, torch.Tensor):
            idx = idx.detach().cpu().numpy()
        ids = np.asarray(idx)
        if ids.ndim != 1:
            raise ValueError(f"query block must be a 1-D id vector, got shape {ids.shape}")
        ids = ids.astype(np.int64)
        n = self.graph_batch.num_targets
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            bad = ids[(ids < 0) | (ids >= n)].tolist()
            raise IndexError(f"query ids outside [0, {n}): {bad}")
        self._check(params)
        idx = ids.astype(np.int32)
        gl = self._ego_globals_for(params) if ego_globals is _UNSET else ego_globals
        eb = self._ego.extract(idx, ego_globals=gl)
        if eb is None:
            flows.DISPATCH["ego_fallback"] += 1
            return self.query(params, idx)  # takes the session's lock itself
        exe = self.compile_ego(eb, params)
        flows.DISPATCH["ego_calls"] += 1
        if (
            self.flow.flow in ("fused", "fused_kernel")
            and self.flow.prune_k is not None
            and eb.sig.max_d_cap <= self.flow.prune_k
        ):
            flows.DISPATCH["ego_bypass"] += 1
        return exe(params, eb)

    @property
    def query_capacities(self) -> Tuple[int, ...]:
        """The capacities recorded by ``compile_query``, ascending."""
        return tuple(sorted(self._capacities))

    @property
    def captured(self) -> bool:
        """Whether calls replay a captured CUDA graph (a CUDA batch)."""
        return self._graph is not None

    @property
    def out_shape(self) -> Tuple[int, int]:
        """Forward-output shape ``(num_targets, num_classes)``."""
        return (self.graph_batch.num_targets, self.model.num_classes)

    def __repr__(self):
        return (
            f"InferenceSession(flow={self.flow.flow!r}, "
            f"device={self.graph_batch.device}, captured={self.captured})"
        )


class _EagerEgo:
    """An ego program on the CPU: the eager forward."""

    def __init__(self, model, flow: FlowConfig):
        self.model, self.flow = model, flow

    def __call__(self, params, ego_batch) -> torch.Tensor:
        with torch.inference_mode(), flows.mesh_scope(pinned=None):
            b = ego_batch.to("cpu")
            return self.model.apply(params, b, self.flow).index_select(0, b.out_rows)


class _EgoGraph:
    """One ego signature's forward captured as a CUDA graph.

    Static inputs: clones of the params, one device byte buffer whose
    256-byte-aligned segments are typed views holding the extracted host
    arrays (``EgoBatch.host_leaves``: features, tables, ``out_rows``; the
    alignment of a tensor of its own, so a library kernel chosen by
    alignment is the eager forward's), and clones of the injected
    ``ego_globals``. A call packs the host arrays
    into one fresh pinned buffer (the caching host allocator does not hand
    it out again before its copy ends), copies it with the params and the
    globals into the static inputs and replays, all on the caller's stream
    under the graph's own lock, after the stream of the previous call; the
    result is a clone of the static output."""

    def __init__(self, model, flow: FlowConfig, ego_batch, params, device: torch.device):
        self.model, self.flow, self.sig = model, flow, ego_batch.sig
        leaves = ego_batch.host_leaves()
        self._layout, off = [], 0
        for a in leaves:
            self._layout.append((off, a.nbytes))
            off += -(-a.nbytes // 256) * 256
        self._nbytes = max(off, 16)
        self._buf = torch.zeros(self._nbytes, dtype=torch.uint8, device=device)
        views = [
            self._buf[o:o + n].view(torch.from_numpy(np.empty(0, a.dtype)).dtype).view(a.shape)
            for (o, n), a in zip(self._layout, leaves)
        ]
        nt = len(self.sig.node_types)
        tables = tuple(tuple(views[nt + 3 * i: nt + 3 * i + 3]) for i in range(len(self.sig.sgs)))
        self._names = tuple(sorted(params))
        with torch.no_grad():
            self._inputs = [params[n].detach().clone() for n in self._names]
            self._globals = {k: v.detach().clone() for k, v in ego_batch.ego_globals.items()}
        static = EgoBatch(
            self.sig, dict(zip(self.sig.node_types, views[:nt])), tables, views[-1], self._globals
        )
        self._buf.copy_(self._pack(leaves), non_blocking=True)
        p = dict(zip(self._names, self._inputs))

        def forward():
            with flows.mesh_scope(pinned=None):
                return model.apply(p, static, flow).index_select(0, static.out_rows)

        self._graph, self._out = _capture_graph(forward, device)
        self._serial = _Serial(
            torch.cuda.current_stream(device), [self._buf, *self._inputs, *self._globals.values()]
        )
        self.forwards = 0

    def _pack(self, leaves) -> torch.Tensor:
        host = torch.empty(self._nbytes, dtype=torch.uint8, pin_memory=True)
        hn = host.numpy()
        for (o, n), a in zip(self._layout, leaves):
            hn[o:o + n] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        return host

    def __call__(self, params, ego_batch) -> torch.Tensor:
        """The block's logits; with tracing off one check more than the
        replay, otherwise :meth:`_call_traced`."""
        if trace.recording():
            return self._call_traced(params, ego_batch)
        if ego_batch.sig != self.sig:
            raise ValueError("ego batch's signature is not this program's")
        host = self._pack(ego_batch.host_leaves())
        with torch.inference_mode():
            serial = self._serial
            with serial.lock:
                serial.follow(torch.cuda.current_stream(self._buf.device))
                self._copy_in(params, ego_batch, host)
                self._graph.replay()
                self.forwards += 1
                return self._out.clone()

    def _copy_in(self, params, ego_batch, host) -> None:
        """The params, the ego globals and the packed host arrays into the
        static inputs, on the current stream."""
        torch._foreach_copy_(self._inputs, [params[n] for n in self._names])
        for k, v in self._globals.items():
            v.copy_(ego_batch.ego_globals[k], non_blocking=True)
        self._buf.copy_(host, non_blocking=True)

    def _call_traced(self, params, ego_batch) -> torch.Tensor:
        """``__call__`` with the session's spans, plus ``ego.pack``."""
        with trace.span("session.call"):
            with trace.span("session.check"):
                if ego_batch.sig != self.sig:
                    raise ValueError("ego batch's signature is not this program's")
            with trace.span("ego.pack"):
                host = self._pack(ego_batch.host_leaves())
            with torch.inference_mode():
                serial = self._serial
                with serial.lock:
                    serial.follow(torch.cuda.current_stream(self._buf.device))
                    with trace.span("session.copy_in"):
                        self._copy_in(params, ego_batch, host)
                    with trace.span("session.replay"):
                        self._graph.replay()
                    self.forwards += 1
                    with trace.span("session.read_out"):
                        return self._out.clone()
