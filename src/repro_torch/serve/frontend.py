"""``ServeFrontend`` — the async microbatching loop over a session.

Two decoupled roles (the grl2 actor/learner split, serving-shaped):

  * the COLLECTOR drains the request queue into padded
    :class:`~repro_torch.serve.queueing.QueryBlock`\\ s (host-side numpy
    assembly) and feeds a bounded block pipe;
  * the STEPPER pops blocks and steps the session's query —
    DOUBLE-BUFFERED: it dispatches block *k+1* to the device before
    resolving block *k*'s result, so host-side batch assembly and future
    completion overlap device execution and the session never idles
    waiting on Python.

Both roles go through the clock/executor seam (``repro_torch.serve.clock``):
``ThreadExecutor`` runs them as real threads for production,
``InlineExecutor`` leaves the front-end passive so tests and deterministic
benchmarks drive the SAME drain → dispatch → resolve code with
``pump()`` — no sleeps, no races, same double-buffered dispatch window.

Every block capacity in the policy ladder is recorded at construction
(``session.compile_query``), so serving never meets a new block shape.
Tenant routing happens at block granularity: each block runs under the
weights ``WeightPlane.checkout(tenant)`` returns.

ON A CARD the session is a captured CUDA graph, and the double buffer has
to be earned on the host (the reference's one sync point,
``block_until_ready`` at resolve, has no cost on the dispatch side):

  * dispatch enqueues the block's forward and gather (the session runs
    them under its lock on the stepper's stream, ids through pinned
    memory) and then a
    ``non_blocking`` copy of the block's rows into a pinned host buffer,
    with a ``torch.cuda.Event`` recorded after it;
  * resolve waits on that event only — never on the stream, which by then
    may hold block *k+1*'s forward — and completes the futures with host
    numpy rows (as the reference's futures hold);
  * each loop thread binds the session's device first.

An asynchronous device fault poisons the CUDA context, so nothing the
front-end can recover from may fail on the device: query ids are checked
on the host at ``submit`` (``IndexError`` naming them, before the request
is queued), and the session checks its params before any launch.

FAULT TOLERANCE (the supervised serving contract — no future is EVER
stranded; every one resolves with a result or a typed error from
``repro_torch.serve.health``):

  * ADMISSION — ``BatchPolicy.max_pending`` bounds the queue; an over-
    bound ``submit`` sheds fast with ``QueueFullError``. Per-request
    deadlines (``submit(timeout=...)``) expire stale work AT DRAIN TIME
    with ``DeadlineExceededError`` — a dead request never costs a
    forward.
  * SUPERVISION — both loops run under a supervisor: an exception while
    serving a block fails ONLY that block's futures and the loop keeps
    serving; a poisoned drain is caught and retried; a loop escaping its
    supervisor entirely (a bug) fails every outstanding future with
    ``StepperDiedError`` rather than stranding them. A threaded collector
    whose drain fails backs off (``SupervisorPolicy.backoff``) on the
    clock before it retries, and once ``close(timeout)`` has waited its
    timeout it fails every queued request with ``ServeClosedError`` and
    exits; the stepper exits on the sentinel that follows. (The
    reference's collector spins on a drain that keeps failing and never
    exits.)
  * RETRY + DEGRADATION — transient dispatch failures retry with capped
    exponential backoff on the injected clock
    (:class:`~repro_torch.serve.health.SupervisorPolicy`); a block whose
    primary flow still fails is served by the prewarmed FALLBACK
    session (ADE-HGNN's §6 accuracy budget licenses the cheaper flow),
    and ``breaker_threshold`` consecutive primary failures trip a
    circuit breaker that routes blocks straight to the fallback until a
    cooldown-gated half-open probe recovers. ``health()`` exposes
    liveness / breaker / queue-depth state.
  * INJECTION — an optional :class:`~repro_torch.serve.faults.FaultPlan` fires
    at the checkout / dispatch / drain seams, so every failure mode
    above is deterministically testable on ``FakeClock`` +
    ``InlineExecutor`` with zero real sleeps (``benchmarks/serve_chaos``).
"""
from __future__ import annotations

import queue as _queue
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.clock import Clock, SystemClock, ThreadExecutor
from repro_torch.serve.faults import FaultContext, FaultPlan
from repro_torch.serve.health import (
    CircuitBreaker,
    DeadlineExceededError,
    FlushTimeout,
    HealthReport,
    QueueFullError,
    ServeClosedError,
    StepperDiedError,
    SupervisorPolicy,
    TenantUnpublishedError,
)
from repro_torch.serve.plane import GraphPlane, WeightPlane
from repro_torch.serve.queueing import (
    BatchPolicy,
    QueryBlock,
    RequestQueue,
    ServeFuture,
)


class ServeStats:
    """Serving accounting on the injected clock — with a ``FakeClock``
    every quantity below is exactly computable by the test. ``completed``
    counts successfully served requests; ``shed``/``expired``/``failed``
    partition every request that resolved with a typed error instead."""

    _QPS_EPS = 1e-6  # minimum accounting window (s): fake-clock bursts
    # can complete everything on the submit instant

    def __init__(self):
        self._lock = threading.Lock()
        self.latencies: List[float] = []
        self.block_sizes: List[int] = []
        self.submitted = 0
        self.completed = 0
        self.blocks = 0
        self.valid_slots = 0
        self.padded_slots = 0
        self.t_first_submit: Optional[float] = None
        self.t_last_done: Optional[float] = None
        # robustness accounting
        self.shed = 0             # admission-control rejections
        self.expired = 0          # deadline expiries at drain
        self.failed = 0           # requests failed by a serving error
        self.failed_blocks = 0
        self.retries = 0          # transient-dispatch re-attempts
        self.fallback_blocks = 0  # blocks served degraded

    def on_submit(self, now: float) -> None:
        with self._lock:
            self.submitted += 1
            if self.t_first_submit is None:
                self.t_first_submit = now

    def on_block(self, blk: QueryBlock, now: float, engine: str = "primary") -> None:
        with self._lock:
            self.blocks += 1
            self.block_sizes.append(blk.n_valid)
            self.valid_slots += blk.n_valid
            self.padded_slots += blk.padded_slots
            self.completed += len(blk.requests)
            if engine == "fallback":
                self.fallback_blocks += 1
            for req, _ in blk.requests:
                self.latencies.append(now - req.t_submit)
            self.t_last_done = now

    def on_shed(self, now: float) -> None:
        with self._lock:
            self.shed += 1

    def on_expired(self, req) -> None:
        with self._lock:
            self.expired += 1

    def on_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def on_failed_block(self, blk: QueryBlock, now: float) -> None:
        with self._lock:
            self.failed_blocks += 1
            self.failed += len(blk.requests)

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self.latencies:
                return float("nan")
            return float(np.percentile(np.asarray(self.latencies), q))

    @property
    def pad_fraction(self) -> float:
        tot = self.valid_slots + self.padded_slots
        return self.padded_slots / tot if tot else 0.0

    def qps(self) -> float:
        """Completed requests over the submit→last-completion window,
        floored at ``_QPS_EPS`` — on a ``FakeClock`` an entire burst can
        complete on the submit instant, and a zero-width window must
        read as "very fast", not NaN."""
        if (
            self.completed == 0
            or self.t_first_submit is None or self.t_last_done is None
        ):
            return float("nan")
        window = max(self.t_last_done - self.t_first_submit, self._QPS_EPS)
        return self.completed / window

    def summary(self) -> Dict[str, float]:
        return {
            "requests": self.completed,
            "blocks": self.blocks,
            "p50_ms": self.percentile(50) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
            "qps": self.qps(),
            "mean_batch": (
                float(np.mean(self.block_sizes)) if self.block_sizes else 0.0
            ),
            "pad_fraction": self.pad_fraction,
            "shed": self.shed,
            "expired": self.expired,
            "failed": self.failed,
            "retries": self.retries,
            "fallback_blocks": self.fallback_blocks,
        }


class ServeFrontend:
    """Microbatching serving front-end over one ``InferenceSession``.

    ``plane`` may be a :class:`WeightPlane` (multi-tenant) or a bare param
    tree (wrapped as the single ``"default"`` tenant). With a threaded
    executor call ``start()`` (or use the context manager) before
    submitting; with ``InlineExecutor`` just ``submit`` + ``pump``.

    ``session`` may instead be a :class:`~repro_torch.serve.plane.GraphPlane`
    — the live-graph-evolution mode: every primary block checks out the
    plane's CURRENT session at dispatch time, so a streamed-delta publish
    swaps the graph under live traffic with zero failed or stranded
    requests (in-flight blocks finish on the version they checked out;
    see the reference's ``src/repro/serve/README.md``). The fallback session, when given,
    stays pinned to the construction-time graph — degraded answers come
    from a known-good version by design.

    ``fallback`` is an optional second session (same model/batch, a
    cheaper flow, built — on a card, captured — before serving starts)
    serving degraded blocks when the primary fails — its whole capacity
    ladder is prewarmed here, at construction. ``supervisor``
    configures retry/backoff/breaker; ``faults`` threads a
    :class:`FaultPlan` through the checkout/dispatch/drain seams.

    ``BatchPolicy(ego=True)`` raises ``NotImplementedError``: ego serving
    waits for ``core/ego.py`` (ROADMAP §1 item 4).
    """

    _PIPE_DEPTH = 2  # double buffer: one block in flight, one staged

    def __init__(
        self,
        session,
        plane,
        policy: BatchPolicy = BatchPolicy(),
        clock: Optional[Clock] = None,
        executor=None,
        fallback=None,
        supervisor: Optional[SupervisorPolicy] = None,
        faults: Optional[FaultPlan] = None,
    ):
        if getattr(policy, "ego", False):
            raise NotImplementedError(
                "BatchPolicy(ego=True): ego-subgraph serving is not ported "
                "yet (ROADMAP §1 item 4); serve full forwards with ego=False"
            )
        self.graphs: Optional[GraphPlane] = None
        if isinstance(session, GraphPlane):
            # live graph evolution: serve whatever version the plane has
            # published at each block's dispatch; register the policy's
            # ladder so successors are prewarmed BEFORE they go current
            self.graphs = session
            session = self.graphs.current()
            self.graphs.register_capacities(policy.capacities)
        if not isinstance(plane, WeightPlane):
            params = plane
            plane = WeightPlane(params, stream=session.donate_params)
            plane.publish("default", params)
        if session.donate_params and not plane.stream:
            raise ValueError(
                "a donate_params session consumes its input buffers: pair "
                "it with WeightPlane(stream=True)"
            )
        self.session = session
        self.plane = plane
        self.policy = policy
        self.clock = clock if clock is not None else SystemClock()
        self.executor = executor if executor is not None else ThreadExecutor()
        self.supervisor = supervisor if supervisor is not None else SupervisorPolicy()
        self.faults = faults
        self.fallback = fallback
        self.breaker = CircuitBreaker(self.supervisor, self.clock)
        self.stats = ServeStats()
        self.queue = RequestQueue(maxsize=policy.max_pending)
        if fallback is not None:
            p_shape = getattr(session, "out_shape", None)
            f_shape = getattr(fallback, "out_shape", None)
            if p_shape is not None and f_shape is not None and p_shape != f_shape:
                raise ValueError(
                    f"fallback session output {f_shape} is not compatible "
                    f"with the primary's {p_shape}: a degraded block must "
                    f"serve the same (num_targets, num_classes) table"
                )
        # pre-warm the whole ladder — PRIMARY AND FALLBACK: serving can
        # never meet a new shape
        for sess in (session, fallback):
            if sess is None:
                continue
            for cap in policy.capacities:
                sess.compile_query(cap)
        # submit checks ids on the host against the served rows (a session
        # without out_shape, like a test double, skips the check)
        out_shape = getattr(session, "out_shape", None)
        self._num_targets = None if out_shape is None else int(out_shape[0])
        # the card the loop threads bind before any device work
        dev = getattr(getattr(session, "graph_batch", None), "device", None)
        self._device = None
        if dev is not None and dev.type == "cuda":
            self._device = torch.device(
                "cuda", dev.index if dev.index is not None else torch.cuda.current_device()
            )
        self._pipe: "_queue.Queue[Optional[QueryBlock]]" = _queue.Queue(
            maxsize=self._PIPE_DEPTH
        )
        self._inflight = None  # (block, device_out, engine) staged by stepper
        self._outstanding: set = set()
        self._outstanding_lock = threading.Lock()
        self._stop = threading.Event()
        self._abandon = threading.Event()  # close() timed out: give up the queue
        self._started = False
        self._closed = False
        self._collector_errors = 0
        self._stepper_errors = 0
        self._last_error: Optional[BaseException] = None

    # -- request side ------------------------------------------------------
    def submit(
        self, targets, tenant: str = "default",
        timeout: Optional[float] = None,
    ) -> ServeFuture:
        """Enqueue one query; returns its future. Never blocks: when the
        queue is at ``policy.max_pending`` it sheds with
        ``QueueFullError`` instead. ``timeout`` (seconds on the serving
        clock) sets the request's deadline — expired-in-queue requests
        fail with ``DeadlineExceededError`` at drain time. An id outside
        ``[0, num_targets)`` raises ``IndexError`` naming the bad ids,
        before the request is queued, so a bad id never fails a block nor
        reaches the device (the reference's gather wraps or clamps it)."""
        if self._closed:
            raise RuntimeError("front-end is closed")
        if tenant not in self.plane:
            raise KeyError(
                f"unknown tenant {tenant!r}; published: {self.plane.tenants()}"
            )
        if self._num_targets is not None:
            ids = np.asarray(targets).ravel()
            n = self._num_targets
            if ids.size and (ids.min() < 0 or ids.max() >= n):
                bad = ids[(ids < 0) | (ids >= n)].tolist()
                raise IndexError(f"query ids outside [0, {n}): {bad}")
        now = self.clock.now()
        deadline = None
        if timeout is not None:
            timeout = float(timeout)
            if timeout <= 0:
                raise ValueError(f"deadline timeout must be > 0, got {timeout}")
            deadline = now + timeout
        try:
            req = self.queue.put(
                targets, tenant, now, self.policy.max_batch, deadline=deadline
            )
        except QueueFullError:
            self.stats.on_shed(now)
            raise
        with self._outstanding_lock:
            self._outstanding.add(req.future)
        self.stats.on_submit(now)
        return req.future

    # -- the drain → dispatch → resolve core (both modes share it) ---------
    def _ctx(self, site: str, **kw) -> FaultContext:
        return FaultContext(site=site, clock=self.clock, frontend=self, **kw)

    def _raw_dispatch(self, blk: QueryBlock, session, engine: str):
        if self.faults is not None:
            self.faults.fire("checkout", self._ctx(
                "checkout", tenant=blk.tenant, block=blk, engine=engine,
            ))
        params = self.plane.checkout(blk.tenant)
        if self.faults is not None:
            self.faults.fire("dispatch", self._ctx(
                "dispatch", tenant=blk.tenant, block=blk, engine=engine,
            ))
        return _stage(session.query(params, blk.idx))

    def _dispatch_with_retry(self, blk: QueryBlock, session, engine: str):
        """Dispatch with capped exponential backoff on the injected clock
        for ``supervisor.retryable`` exceptions; anything else (including
        ``TenantUnpublishedError``) propagates immediately."""
        attempt = 0
        while True:
            try:
                return self._raw_dispatch(blk, session, engine)
            except self.supervisor.retryable:
                if attempt >= self.supervisor.max_retries:
                    raise
                self.stats.on_retry()
                self.clock.sleep(self.supervisor.backoff(attempt))
                attempt += 1

    def _supervised_dispatch(self, blk: QueryBlock):
        """Serve one block under the supervisor: primary (breaker
        permitting, with retries) → fallback → typed failure. Returns
        ``(staged_out, engine)`` or None when the block's futures were
        failed here. NEVER raises for a per-block serving failure."""
        primary_allowed = self.fallback is None or self.breaker.allow_primary()
        primary_exc: Optional[BaseException] = None
        # resolve the primary ONCE per block: a graph-plane publish between
        # blocks changes what this returns; retries within the block stay
        # pinned to the version it checked out
        primary = (
            self.graphs.current() if self.graphs is not None else self.session
        )
        if primary_allowed:
            try:
                out = self._dispatch_with_retry(blk, primary, "primary")
            except TenantUnpublishedError as exc:
                # the tenant is gone, not the flow: fail this block only,
                # never count it against the breaker
                self._fail_block(blk, exc)
                return None
            except Exception as exc:  # noqa: BLE001 - supervisor boundary
                primary_exc = exc
                self.breaker.record_failure()
            else:
                self.breaker.record_success()
                return out, "primary"
        if self.fallback is None:
            self._fail_block(blk, primary_exc)
            return None
        try:
            out = self._dispatch_with_retry(blk, self.fallback, "fallback")
        except Exception as exc:  # noqa: BLE001 - supervisor boundary
            self._fail_block(blk, exc if primary_exc is None else primary_exc)
            return None
        return out, "fallback"

    def _fail_block(self, blk: QueryBlock, exc: BaseException) -> None:
        """Complete every future of ``blk`` with ``exc`` (idempotently)
        — the per-block blast radius the supervisor guarantees."""
        self._last_error = exc
        self.stats.on_failed_block(blk, self.clock.now())
        with self._outstanding_lock:
            for req, _ in blk.requests:
                self._outstanding.discard(req.future)
        for req, _ in blk.requests:
            req.future.set_exception(exc)

    def _on_expired(self, req) -> None:
        """Drain-time deadline expiry: typed error + accounting."""
        self.stats.on_expired(req)
        with self._outstanding_lock:
            self._outstanding.discard(req.future)
        req.future.set_exception(DeadlineExceededError(
            f"request expired in queue: deadline {req.deadline:.6f} <= "
            f"drain time {self.clock.now():.6f} "
            f"(submitted {req.t_submit:.6f})"
        ))

    def _drain_safe(self, force: bool) -> List[QueryBlock]:
        """The collector's drain under supervision: a poisoned drain
        (injected or real) is caught and counted, the requests stay
        pending, and the next iteration retries — the collector never
        dies on one bad drain."""
        try:
            if self.faults is not None:
                self.faults.fire("drain", self._ctx("drain"))
            return self.queue.drain(
                self.policy, self.clock.now(), force=force,
                on_expired=self._on_expired,
            )
        except Exception as exc:  # noqa: BLE001 - supervisor boundary
            self._collector_errors += 1
            self._last_error = exc
            return []

    def _resolve(self, staged) -> None:
        if staged is None:
            return
        blk, out, engine = staged
        try:
            # THE sanctioned sync point: this block's event, nothing later
            rows = _host_rows(out)
        except Exception as exc:  # device failure surfaces at the sync
            self._fail_block(blk, exc)
            return
        # account BEFORE completing futures: a flush() waiting on the last
        # future must observe final stats the moment it unblocks
        self.stats.on_block(blk, self.clock.now(), engine)
        with self._outstanding_lock:
            for req, _ in blk.requests:
                self._outstanding.discard(req.future)
        for req, slc in blk.requests:
            req.future.set_result(rows[slc], via=engine)

    def _step(self, blk: QueryBlock) -> None:
        """Double-buffered step: dispatch this block, then resolve the
        PREVIOUS one — its device work overlapped this dispatch. A block
        whose dispatch failed was already resolved (with an error) by the
        supervisor; the staged block stays staged."""
        res = self._supervised_dispatch(blk)
        if res is None:
            return
        out, engine = res
        prev, self._inflight = self._inflight, (blk, out, engine)
        self._resolve(prev)

    def _drain_inflight(self) -> None:
        prev, self._inflight = self._inflight, None
        self._resolve(prev)

    # -- inline mode -------------------------------------------------------
    def pump(self, force: bool = False) -> int:
        """Run one collector+stepper iteration synchronously (inline
        mode): drain emit-ready blocks at the current clock time, step
        each through the double-buffered window, resolve the tail.
        Returns the number of blocks executed."""
        assert not self.executor.threaded, "pump() is for inline mode"
        return self._pump_core(force)

    def _pump_core(self, force: bool = False) -> int:
        blocks = self._drain_safe(force)
        for blk in blocks:
            try:
                self._step(blk)
            except Exception as exc:  # noqa: BLE001 - supervisor boundary
                self._stepper_errors += 1
                self._fail_block(blk, exc)
        self._drain_inflight()
        return len(blocks)

    # -- threaded mode -----------------------------------------------------
    def start(self) -> "ServeFrontend":
        if self.executor.threaded and not self._started:
            self._started = True
            self.executor.spawn(
                "serve-collector", lambda: self._guard_loop(self._collect_loop)
            )
            self.executor.spawn(
                "serve-stepper", lambda: self._guard_loop(self._step_loop)
            )
        return self

    def _guard_loop(self, loop) -> None:
        """Last-ditch supervision: a loop escaping its own handlers is a
        bug, but even then no future may be stranded — fail everything
        outstanding with ``StepperDiedError`` before the thread dies."""
        try:
            loop()
        except BaseException as exc:  # noqa: BLE001 - terminal boundary
            self._last_error = exc
            with self._outstanding_lock:
                victims = list(self._outstanding)
                self._outstanding.clear()
            died = StepperDiedError(
                f"serving loop died: {type(exc).__name__}: {exc}"
            )
            for fut in victims:
                fut.set_exception(died)
            raise

    def _bind_device(self) -> None:
        if self._device is not None:
            torch.cuda.set_device(self._device)

    def _collect_loop(self) -> None:
        self._bind_device()
        failures = 0
        while True:
            if self._abandon.is_set():
                self._fail_queued()
                self._pipe.put(None)
                return
            stopping = self._stop.is_set()
            seen = self.queue.version  # snapshot BEFORE draining
            errors = self._collector_errors
            blocks = self._drain_safe(force=stopping)
            for blk in blocks:
                self._pipe.put(blk)  # bounded: backpressure to the queue
            if self._collector_errors != errors:
                # a failed drain leaves the queue as it was: back off on the
                # clock before retrying, never spin on an expired deadline
                self.clock.sleep(self.supervisor.backoff(failures))
                failures += 1
                continue
            failures = 0
            if stopping and len(self.queue) == 0:
                self._pipe.put(None)
                return
            deadline = self.queue.next_deadline(self.policy)
            timeout = (
                None if deadline is None
                else max(0.0, deadline - self.clock.now())
            )
            self.queue.wait_for(
                lambda: self.queue.version != seen or self._stop.is_set(),
                timeout,
            )

    def _fail_queued(self) -> None:
        """Fail every still-queued request with ``ServeClosedError``: the
        collector's way out once ``close`` has waited its timeout."""
        victims = self.queue.take_all()
        with self._outstanding_lock:
            for req in victims:
                self._outstanding.discard(req.future)
        for req in victims:
            req.future.set_exception(ServeClosedError(
                "front-end closed with this request still queued"
            ))

    def _step_loop(self) -> None:
        self._bind_device()
        while True:
            blk = self._pipe.get()
            while True:
                if blk is None:
                    self._drain_inflight()
                    return
                try:
                    self._step(blk)
                except Exception as exc:  # noqa: BLE001 - supervisor
                    self._stepper_errors += 1
                    self._fail_block(blk, exc)
                # keep the window full while blocks are back-to-back; the
                # moment the pipe runs dry, resolve the staged block
                # instead of parking it until the next burst
                try:
                    blk = self._pipe.get_nowait()
                except _queue.Empty:
                    self._drain_inflight()
                    break

    # -- observability -----------------------------------------------------
    def health(self) -> HealthReport:
        """One consistent liveness/breaker/queue-depth snapshot — the
        state a load balancer or readiness probe reads."""
        threaded = self.executor.threaded
        if threaded and self._started:
            collector = self.executor.alive("serve-collector")
            stepper = self.executor.alive("serve-stepper")
        else:
            collector = stepper = not threaded and not self._closed
        with self._outstanding_lock:
            outstanding = len(self._outstanding)
        return HealthReport(
            mode="threaded" if threaded else "inline",
            closed=self._closed,
            started=self._started,
            collector_alive=bool(collector),
            stepper_alive=bool(stepper),
            queue_depth=len(self.queue),
            outstanding=outstanding,
            breaker_state=self.breaker.state,
            breaker_trips=self.breaker.trips,
            breaker_recoveries=self.breaker.recoveries,
            consecutive_failures=self.breaker.consecutive_failures,
            shed=self.stats.shed,
            expired=self.stats.expired,
            failed=self.stats.failed,
            retries=self.stats.retries,
            fallback_blocks=self.stats.fallback_blocks,
            collector_errors=self._collector_errors,
            stepper_errors=self._stepper_errors,
        )

    # -- draining / shutdown -----------------------------------------------
    def flush(self, timeout: float = 30.0) -> None:
        """Wait until every submitted request has RESOLVED (result or
        typed error — an errored future counts as flushed; read
        ``future.result()`` for the outcome). Inline mode force-pumps
        until the queue is empty; threaded mode waits on the outstanding
        futures under ONE SHARED deadline — ``timeout`` bounds the whole
        flush, not each future — and raises :class:`FlushTimeout` with
        the still-pending count when the budget runs out."""
        if not self.executor.threaded:
            stalls = 0
            while len(self.queue) > 0:
                before_len = len(self.queue)
                before_err = self._collector_errors
                self.pump(force=True)
                if len(self.queue) < before_len:
                    stalls = 0
                    continue
                # no progress: retry only while the stall is a supervised
                # drain fault (a transiently poisoned drain heals itself);
                # a genuinely stuck queue fails loudly instead of looping
                stalls += 1
                if self._collector_errors == before_err or stalls > 8:
                    raise FlushTimeout(
                        f"inline flush made no progress: {len(self.queue)} "
                        f"requests still pending (poisoned drain?)",
                        pending=len(self.queue),
                    )
            self._drain_inflight()
            return
        with self._outstanding_lock:
            waiting = list(self._outstanding)
        t_end = self.clock.now() + timeout
        for fut in waiting:
            remaining = t_end - self.clock.now()
            if remaining <= 0 or not fut.wait(remaining):
                pending = sum(1 for f in waiting if not f.done())
                raise FlushTimeout(
                    f"flush deadline ({timeout:.3f}s shared budget) "
                    f"exhausted with {pending} requests still pending",
                    pending=pending,
                )

    def close(self, timeout: float = 30.0) -> None:
        """Serve everything still queued, then stop the loops. A threaded
        front-end that was never ``start()``ed serves its backlog INLINE
        here (force-pump) — queued work is never silently dropped. Any
        future somehow still incomplete after shutdown is failed with
        ``ServeClosedError`` rather than stranded.

        Threaded, ``timeout`` bounds the wait for the loops to serve the
        backlog; if they have not ended by then (a drain that keeps
        failing), the collector fails what is still queued with
        ``ServeClosedError`` and exits, the stepper exits on the sentinel
        after it, and ``close`` waits a further grace
        (``1 s + supervisor.backoff_cap``, the collector's longest
        backoff) for both to end."""
        if self._closed:
            return
        self._closed = True
        if self.executor.threaded and self._started:
            self._stop.set()
            self.queue.notify_all()
            self.executor.join(timeout)
            if any(self.executor.liveness().values()):
                self._abandon.set()
                self.queue.notify_all()
                self.executor.join(1.0 + self.supervisor.backoff_cap)
        else:
            # inline mode, or threaded-but-never-started: the caller is
            # the loop — run the drain → dispatch → resolve core directly
            self._pump_core(force=True)
        with self._outstanding_lock:
            leftovers = [f for f in self._outstanding if not f.done()]
            self._outstanding.clear()
        for fut in leftovers:
            fut.set_exception(ServeClosedError(
                "front-end closed with this request still unserved"
            ))

    def __enter__(self) -> "ServeFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def _stage(out):
    """Start a block's rows on their way to the host. A CUDA tensor is
    copied (``non_blocking``) into a pinned host buffer on the current
    stream, with an event recorded after the copy; anything else (a CPU
    tensor, a test double's array) is already there."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(out.device))
        return host, done
    return out, None


def _host_rows(staged) -> np.ndarray:
    """The staged rows as a host numpy array: waits on the block's own
    event only (never the whole stream, which may already hold the next
    block's forward); the pinned buffer is copied out so it returns to
    the allocator's cache."""
    out, done = staged
    if done is not None:
        done.synchronize()
        return out.numpy().copy()
    if isinstance(out, torch.Tensor):
        return out.numpy()
    return np.asarray(out)
