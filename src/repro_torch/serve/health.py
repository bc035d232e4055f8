"""Failure taxonomy, circuit breaker, and health reporting for serving.

Fault tolerance starts with NAMING the failure modes: every way a request
can fail to be served resolves its future with one of the typed errors
below, so a client can always tell "shed at admission" from "expired in
queue" from "the model itself failed" — and a chaos harness (the
reference's ``benchmarks/serve_chaos.py``) can assert that NO future is ever
stranded: each one completes with a result or a typed error, under every
injected fault class.

The :class:`CircuitBreaker` implements the paper-grounded degradation
lever: ADE-HGNN's own accuracy budget (0.11-1.47% from top-K pruning, §6)
licenses trading the primary flow for a cheaper prebuilt one
(``fused_kernel`` → ``fused``, or the §4.3 pruner-bypass small-K path)
when the primary keeps failing — serve slightly different bits rather
than failing requests. All timing (backoff, cooldown) runs on the
injected serving clock, so the whole state machine is deterministic under
``FakeClock`` — breaker trips and recoveries are exact functions of the
fault plan.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Tuple, Type


# ---------------------------------------------------------------------------
# failure taxonomy — every failed future carries one of these
# ---------------------------------------------------------------------------


class ServeError(RuntimeError):
    """Base class for typed serving failures."""


class QueueFullError(ServeError):
    """Admission control shed this request: the bounded queue is at
    ``max_pending``. Raised synchronously from ``submit`` — shedding
    fails FAST, it never costs the client a timeout."""


class DeadlineExceededError(ServeError):
    """The request's deadline passed while it waited in the queue; it was
    expired at drain time instead of being served dead."""


class TenantUnpublishedError(ServeError, KeyError):
    """``plane.checkout`` found the block's tenant gone — unpublished
    between ``submit`` and dispatch. Fails the affected block's futures
    only; never retried (the tenant is not coming back by waiting), never
    counted against the flow's circuit breaker."""

    def __str__(self) -> str:  # KeyError would repr() the message
        return self.args[0] if self.args else ""


class TransientDispatchError(ServeError):
    """A dispatch failure worth retrying (flaky link, transient resource
    exhaustion). The supervised stepper retries these with capped
    exponential backoff before treating the block as failed."""


class StepperDiedError(ServeError):
    """A serving loop escaped its supervisor (a bug, not a fault): every
    outstanding future is failed with this instead of being stranded."""


class ServeClosedError(ServeError):
    """The front-end was closed while this request was still unserved."""


class FlushTimeout(ServeError, TimeoutError):
    """``flush`` exhausted its SHARED deadline with requests still
    pending; ``pending`` counts the futures not yet complete."""

    def __init__(self, msg: str, pending: int):
        super().__init__(msg)
        self.pending = int(pending)


# ---------------------------------------------------------------------------
# supervision policy + circuit breaker
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SupervisorPolicy:
    """How the supervised stepper responds to dispatch failures.

    ``max_retries`` bounds re-dispatch attempts per block for exceptions
    in ``retryable`` (capped exponential backoff on the injected clock:
    ``min(backoff_cap, backoff_base * 2**attempt)``). A block whose
    primary dispatch still fails counts ONE consecutive-failure against
    the breaker; ``breaker_threshold`` consecutive failures trip it OPEN,
    and after ``breaker_cooldown`` seconds one HALF_OPEN probe decides
    recovery."""

    max_retries: int = 2
    backoff_base: float = 1e-3
    backoff_cap: float = 0.1
    retryable: Tuple[Type[BaseException], ...] = (TransientDispatchError,)
    breaker_threshold: int = 3
    breaker_cooldown: float = 0.05

    def __post_init__(self):
        assert self.max_retries >= 0 and self.breaker_threshold >= 1
        assert self.backoff_base >= 0 and self.backoff_cap >= 0
        assert self.breaker_cooldown >= 0

    def backoff(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (0-based), capped exponential."""
        return min(self.backoff_cap, self.backoff_base * (2.0**attempt))


class CircuitBreaker:
    """CLOSED → (N consecutive primary failures) → OPEN → (cooldown) →
    HALF_OPEN probe → CLOSED on success / OPEN on failure.

    Driven entirely by the stepper (single caller), clocked by the
    injected serving clock; ``allow_primary`` answers "may this block try
    the primary flow?" — while OPEN the answer is no and blocks go
    straight to the prebuilt fallback."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, policy: SupervisorPolicy, clock):
        self.policy = policy
        self.clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at: Optional[float] = None
        self.trips = 0
        self.recoveries = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive

    def allow_primary(self) -> bool:
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                elapsed = self.clock.now() - self._opened_at
                if elapsed >= self.policy.breaker_cooldown:
                    self._state = self.HALF_OPEN  # this block is the probe
                    return True
                return False
            # HALF_OPEN: a probe is already in flight (the stepper is
            # sequential, so this only fires if record_* was skipped)
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                self.recoveries += 1
            self._state = self.CLOSED
            self._consecutive = 0

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == self.HALF_OPEN:
                # failed probe: straight back to OPEN, restart cooldown
                self._state = self.OPEN
                self._opened_at = self.clock.now()
                return
            if (
                self._state == self.CLOSED
                and self._consecutive >= self.policy.breaker_threshold
            ):
                self._state = self.OPEN
                self._opened_at = self.clock.now()
                self.trips += 1


# ---------------------------------------------------------------------------
# health reporting
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """One consistent snapshot of the front-end's liveness + load +
    degradation state (``ServeFrontend.health()``). ``live`` means the
    serving loops can still make progress: inline mode is live until
    closed (the caller IS the loop); threaded mode requires both threads
    running. ``healthy`` additionally requires the breaker CLOSED — a
    live-but-degraded front-end is serving, just not the primary flow."""

    mode: str                 # "inline" | "threaded"
    closed: bool
    started: bool
    collector_alive: bool
    stepper_alive: bool
    queue_depth: int
    outstanding: int
    breaker_state: str
    breaker_trips: int
    breaker_recoveries: int
    consecutive_failures: int
    shed: int
    expired: int
    failed: int
    retries: int
    fallback_blocks: int
    collector_errors: int
    stepper_errors: int

    @property
    def live(self) -> bool:
        if self.closed:
            return False
        if self.mode == "inline":
            return True
        return self.started and self.collector_alive and self.stepper_alive

    @property
    def healthy(self) -> bool:
        return self.live and self.breaker_state == CircuitBreaker.CLOSED
