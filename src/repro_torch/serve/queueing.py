"""Request queue + capacity-bucketed microbatching.

A request is "logits for these target vertices, under this tenant's
weights". The queue collects concurrent requests and ``drain`` packs them
into :class:`QueryBlock`\\ s — padded int32 id vectors whose length comes
from a FIXED capacity ladder (:class:`BatchPolicy`), so the downstream
``InferenceSession.query`` never sees a block shape its ladder does not
name (the port's session replays one captured forward for every block and
gathers the block's rows after it). This is the degree-bucket idea applied
at the request level:
degree buckets pad neighbor rows to the tightest capacity; query buckets
pad request microbatches the same way, and :func:`tune_capacities` reuses
the SAME DP (``hetgraph.autotune_bucket_sizes``) over an observed
batch-size histogram instead of a degree histogram.

Flush policy (the microbatching contract, asserted in
``tests/test_torch_serve.py``, as the reference's ``tests/test_serve.py``
asserts it):

  * SATURATION — while a tenant's pending targets fill the largest
    capacity, full blocks are emitted immediately (no timeout waits);
  * TIMEOUT — a partial block is emitted once its oldest request has
    waited ``flush_timeout`` seconds (bounded tail latency);
  * FORCE — ``drain(..., force=True)`` flushes everything (shutdown).

Requests are never split across blocks (a request's rows come back from
one session dispatch) and never reordered within a tenant (FIFO), and
blocks are single-tenant — tenant routing happens here, not on device.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hetgraph import autotune_bucket_sizes
from repro_torch.serve.health import DeadlineExceededError, QueueFullError


class ServeFuture:
    """Completion handle for one request: ``result(timeout)`` returns the
    ``(num_query_targets, num_classes)`` logits rows (or re-raises the
    serving error). Thread-safe; in inline mode it is completed
    synchronously during ``pump()``.

    Completion is IDEMPOTENT: the first ``set_result``/``set_exception``
    wins and later calls are no-ops (returning False) — so a request that
    raced two completion paths (e.g. expired at drain while a retry was
    resolving, or a supervisor failing a block the stepper already
    served) can never flip an already-delivered answer. ``via`` records
    which engine served it (``"primary"``/``"fallback"``/``None``)."""

    __slots__ = ("_event", "_value", "_error", "_lock", "via")

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._value = None
        self._error: Optional[BaseException] = None
        self.via: Optional[str] = None

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, value, via: Optional[str] = None) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._value = value
            self.via = via
            self._event.set()
            return True

    def set_exception(self, exc: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._error = exc
            self._event.set()
            return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True once completed (result OR error) — never raises, unlike
        ``result``; the deadline-aware ``flush`` is built on this."""
        return self._event.wait(timeout)

    def exception(self, timeout: Optional[float] = None):
        """The completing exception, or None for a successful result."""
        if not self._event.wait(timeout):
            raise TimeoutError("request not served within timeout")
        return self._error

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request not served within timeout")
        if self._error is not None:
            raise self._error
        return self._value


@dataclasses.dataclass
class Request:
    """One submitted query: ``targets`` is an int32 vector of target
    vertex ids for ``tenant``'s weights; ``t_submit`` is the queue's
    clock stamp at submission (latency accounting baseline).
    ``deadline`` (a clock time, not a duration; None = no deadline) is
    the point past which the request must NOT be served — ``drain``
    expires stale requests instead of wasting a forward on them."""

    targets: np.ndarray
    tenant: str
    t_submit: float
    future: ServeFuture
    seq: int
    deadline: Optional[float] = None

    @property
    def size(self) -> int:
        return int(self.targets.shape[0])


@dataclasses.dataclass
class QueryBlock:
    """One padded microbatch: ``idx`` has length ``capacity`` (a ladder
    capacity), rows ``[:n_valid]`` are real query ids in request order,
    padded slots repeat a valid id and are discarded. ``requests`` maps
    each member request to its row slice of the block output."""

    tenant: str
    idx: np.ndarray
    requests: List[Tuple[Request, slice]]
    n_valid: int
    t_oldest: float

    @property
    def capacity(self) -> int:
        return int(self.idx.shape[0])

    @property
    def padded_slots(self) -> int:
        return self.capacity - self.n_valid


def tune_capacities(
    batch_sizes: Sequence[int], max_buckets: int = 4
) -> Tuple[int, ...]:
    """Capacity ladder from an observed microbatch-size histogram — the
    degree-bucket autotuner pointed at request batches: minimizes total
    padded slots over ≤ ``max_buckets`` capacities, so a front-end can
    re-derive its ladder from production traffic instead of guessing."""
    return autotune_bucket_sizes(np.asarray(batch_sizes), max_buckets)


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """When to flush, and to what shapes.

    ``capacities`` is the ascending query-block ladder (every block is
    padded to the tightest member ≥ its request total; the largest entry
    is the microbatch ceiling). ``flush_timeout`` bounds how long a
    partial block may wait for more requests (seconds, on the serving
    clock). ``max_pending`` is the admission-control bound: with more
    than this many requests already queued, ``submit`` sheds the new one
    with :class:`~repro_torch.serve.health.QueueFullError` instead of letting
    the backlog (and every queued request's latency) grow without bound
    (None = unbounded, the pre-robustness behavior).

    ``ego=True`` is the reference's ego-subgraph routing (each primary
    block's forward on its extracted O(neighborhood) batch). The port
    accepts the field, and ``ServeFrontend`` raises ``NotImplementedError``
    when it is set: ego serving waits for ``core/ego.py`` (ROADMAP §1
    item 4)."""

    capacities: Tuple[int, ...] = (1, 4, 8, 16)
    flush_timeout: float = 2e-3
    max_pending: Optional[int] = None
    ego: bool = False

    def __post_init__(self):
        caps = tuple(int(c) for c in self.capacities)
        assert caps and all(c > 0 for c in caps), caps
        assert list(caps) == sorted(set(caps)), f"ascending, unique: {caps}"
        object.__setattr__(self, "capacities", caps)
        assert self.max_pending is None or self.max_pending >= 1

    @property
    def max_batch(self) -> int:
        return self.capacities[-1]

    def capacity_for(self, n: int) -> int:
        """Tightest ladder capacity ≥ n (n must fit the ladder)."""
        assert 0 < n <= self.max_batch, (n, self.capacities)
        for c in self.capacities:
            if c >= n:
                return c
        raise AssertionError  # pragma: no cover - guarded above

    @classmethod
    def tuned(
        cls,
        batch_sizes: Sequence[int],
        max_buckets: int = 4,
        flush_timeout: float = 2e-3,
    ) -> "BatchPolicy":
        return cls(tune_capacities(batch_sizes, max_buckets), flush_timeout)


class RequestQueue:
    """Thread-safe FIFO of pending requests with the drain/flush logic.

    ``put`` never blocks (serving backpressure is the block pipe's job,
    not the queue's) — with a ``maxsize`` it SHEDS instead, raising
    :class:`~repro_torch.serve.health.QueueFullError` the moment the bound is
    hit (fail fast beats queueing work that will miss its deadline
    anyway); ``drain`` is the ONLY consumer and implements the
    saturation/timeout/force policy above, expiring deadline-stale
    requests before packing. ``wait``/``notify`` let a collector thread
    sleep until work or a deadline arrives without polling."""

    def __init__(self, maxsize: Optional[int] = None):
        assert maxsize is None or maxsize >= 1, maxsize
        self.maxsize = maxsize
        self._cond = threading.Condition()
        self._pending: List[Request] = []
        self._seq = 0

    def __len__(self) -> int:
        with self._cond:
            return len(self._pending)

    @property
    def version(self) -> int:
        """Monotonic put counter: a collector snapshots it before
        draining and waits for it to move (or a deadline/shutdown), so a
        put landing between drain and wait can never be missed."""
        return self._seq

    def put(
        self,
        targets,
        tenant: str,
        now: float,
        max_batch: int,
        deadline: Optional[float] = None,
    ) -> Request:
        targets = np.asarray(targets, np.int32).ravel()
        if targets.size == 0:
            raise ValueError("empty query: need at least one target id")
        if targets.size > max_batch:
            raise ValueError(
                f"query of {targets.size} targets exceeds the largest "
                f"block capacity {max_batch}; split it client-side"
            )
        with self._cond:
            if (
                self.maxsize is not None
                and len(self._pending) >= self.maxsize
            ):
                raise QueueFullError(
                    f"request queue full: {len(self._pending)} pending >= "
                    f"max_pending {self.maxsize}; shedding"
                )
            req = Request(
                targets=targets, tenant=tenant, t_submit=float(now),
                future=ServeFuture(), seq=self._seq,
                deadline=None if deadline is None else float(deadline),
            )
            self._seq += 1
            self._pending.append(req)
            self._cond.notify_all()
        return req

    def take_all(self) -> List[Request]:
        """Remove and return every pending request, bypassing the flush
        policy: the shutdown path of a collector whose drain keeps failing,
        which fails them with ``ServeClosedError`` instead of leaving them
        queued."""
        with self._cond:
            taken, self._pending = self._pending, []
        return taken

    def wait_for(self, predicate, timeout: Optional[float]) -> None:
        """Block until ``predicate()`` holds or the timeout elapses. The
        predicate is (re)checked under the queue lock BEFORE sleeping, so
        a state change that happened-before this call (a put, a shutdown
        flag set + ``notify_all``) is seen immediately — no missed
        wakeups; spurious returns are fine, the collector loops."""
        with self._cond:
            self._cond.wait_for(predicate, timeout)

    def notify_all(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def next_deadline(self, policy: BatchPolicy) -> Optional[float]:
        """Next clock time at which a drain becomes due: the earliest
        flush-timeout expiry OR request deadline over the pending set
        (None when the queue is empty) — a collector sleeping until this
        time both emits aged partial blocks and expires stale requests
        promptly."""
        with self._cond:
            if not self._pending:
                return None
            t = min(r.t_submit for r in self._pending) + policy.flush_timeout
            dl = [r.deadline for r in self._pending if r.deadline is not None]
            return min([t] + dl)

    def drain(
        self,
        policy: BatchPolicy,
        now: float,
        force: bool = False,
        on_expired=None,
    ) -> List[QueryBlock]:
        """Pack pending requests into emit-ready blocks.

        Deadline-stale requests (``deadline <= now``) are EXPIRED first:
        removed from the queue and handed to ``on_expired(request)`` (by
        default their futures complete with
        :class:`~repro_torch.serve.health.DeadlineExceededError`) — a dead
        request must never cost a forward, and expiring at drain time
        means even ``force=True`` shutdown flushes fail them loudly
        instead of serving them late.

        Then per tenant (tenants in first-arrival order, requests FIFO):
        greedy-pack requests until the next one would overflow
        ``max_batch``; a block closed by overflow is SATURATED and always
        emits, the tenant's final partial block emits only when forced or
        when its oldest member has aged past ``flush_timeout``. Emitted
        requests leave the queue; everything else stays pending."""
        with self._cond:
            expired = [
                r for r in self._pending
                if r.deadline is not None and r.deadline <= now
            ]
            if expired:
                gone = {r.seq for r in expired}
                self._pending = [
                    r for r in self._pending if r.seq not in gone
                ]
            by_tenant: "OrderedDict[str, List[Request]]" = OrderedDict()
            for r in self._pending:
                by_tenant.setdefault(r.tenant, []).append(r)

            blocks: List[QueryBlock] = []
            emitted: set = set()
            for tenant, reqs in by_tenant.items():
                group: List[Request] = []
                total = 0
                for r in reqs + [None]:
                    if r is not None and total + r.size <= policy.max_batch:
                        group.append(r)
                        total += r.size
                        continue
                    if group:
                        # closed by overflow, or exactly full: no more
                        # batching is possible, emit without waiting
                        saturated = (
                            r is not None or total >= policy.max_batch
                        )
                        t_old = group[0].t_submit
                        if (
                            saturated or force
                            or now - t_old >= policy.flush_timeout
                        ):
                            blocks.append(self._pack(group, total, policy))
                            emitted.update(g.seq for g in group)
                    group, total = ([r], r.size) if r is not None else ([], 0)
            if emitted:
                self._pending = [
                    r for r in self._pending if r.seq not in emitted
                ]
        # complete expired futures OUTSIDE the queue lock: handlers touch
        # other locks (stats, outstanding set) and must not nest under it
        for r in expired:
            if on_expired is not None:
                on_expired(r)
            else:
                r.future.set_exception(DeadlineExceededError(
                    f"request expired in queue: deadline {r.deadline:.6f} "
                    f"<= drain time {now:.6f} (submitted {r.t_submit:.6f})"
                ))
        return blocks

    @staticmethod
    def _pack(group: List[Request], total: int, policy: BatchPolicy) -> QueryBlock:
        cap = policy.capacity_for(total)
        idx = np.empty(cap, np.int32)
        requests: List[Tuple[Request, slice]] = []
        off = 0
        for r in group:
            idx[off : off + r.size] = r.targets
            requests.append((r, slice(off, off + r.size)))
            off += r.size
        idx[off:] = idx[0]  # pad with a valid id; rows are discarded
        return QueryBlock(
            tenant=group[0].tenant, idx=idx, requests=requests,
            n_valid=off, t_oldest=group[0].t_submit,
        )
