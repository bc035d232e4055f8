"""The injectable clock/executor seam the serving loop is built on.

Every time-dependent decision in ``repro_torch.serve`` — flush-timeout expiry,
latency stamps, open-loop arrival pacing — goes through a ``Clock``, and
every concurrency decision goes through an ``Executor``. Production runs
``SystemClock`` + ``ThreadExecutor`` (a collector thread drains the queue
while a stepper thread steps the session). Tests run ``FakeClock`` +
``InlineExecutor``: the test advances time explicitly and drives the loop
with ``frontend.pump()``, so queue saturation, timeout flushes, and
p50/p99 accounting are exercised with ZERO real sleeps and zero threads —
the whole load test is deterministic by construction (the grl2
actor/learner decoupling, with the wall clock abstracted out).

This module is the only place in ``serve/`` that reads the wall clock
(each such line is marked ``allow(serve-wallclock)``;
``tests/test_torch_serve.py`` holds every other module to it).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List


class Clock:
    """Monotonic time source + sleep; the only two time ops serving uses."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, dt: float) -> None:
        raise NotImplementedError


class SystemClock(Clock):
    def now(self) -> float:
        # repro: allow(serve-wallclock) -- the seam's real-time impl
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            # repro: allow(serve-wallclock) -- the seam's real-time impl
            time.sleep(dt)


class FakeClock(Clock):
    """Deterministic manual time. ``sleep`` ADVANCES the clock (so a paced
    open-loop load generator runs instantly but stamps honest arrival
    times); ``advance`` moves time without a sleep (the test aging the
    queue past a flush timeout). Every sleep is recorded for asserting
    pacing behavior."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)
        self.sleeps: List[float] = []

    def now(self) -> float:
        return self._t

    def sleep(self, dt: float) -> None:
        self.sleeps.append(float(dt))
        if dt > 0:
            self._t += float(dt)

    def advance(self, dt: float) -> None:
        assert dt >= 0, dt
        self._t += float(dt)


class InlineExecutor:
    """No threads: the front-end stays passive and the caller drives it
    with ``pump()``. ``spawn`` is a loud error — nothing in inline mode
    may depend on a background loop existing."""

    threaded = False

    def spawn(self, name: str, fn: Callable[[], None]):
        raise RuntimeError(
            f"InlineExecutor cannot spawn {name!r}: drive the front-end "
            "with pump()/flush() instead"
        )

    def liveness(self) -> dict:
        """No loops to be alive; the caller is the loop."""
        return {}


class ThreadExecutor:
    """Daemon threads, tracked by name for join-on-close and liveness
    reporting (``ServeFrontend.health()`` reads ``alive``)."""

    threaded = True

    def __init__(self):
        self.threads: List[threading.Thread] = []
        self._by_name: dict = {}

    def spawn(self, name: str, fn: Callable[[], None]) -> threading.Thread:
        t = threading.Thread(target=fn, name=name, daemon=True)
        t.start()
        self.threads.append(t)
        self._by_name[name] = t
        return t

    def alive(self, name: str) -> bool:
        t = self._by_name.get(name)
        return bool(t is not None and t.is_alive())

    def liveness(self) -> dict:
        return {n: t.is_alive() for n, t in self._by_name.items()}

    def join(self, timeout: float = 10.0) -> None:
        """Join every thread under ONE shared deadline: ``timeout`` bounds
        the whole call, not each thread (the reference waits up to
        ``timeout`` per thread)."""
        # repro: allow(serve-wallclock) -- the seam's real-time impl
        t_end = time.monotonic() + timeout
        for t in self.threads:
            # repro: allow(serve-wallclock) -- the seam's real-time impl
            t.join(max(0.0, t_end - time.monotonic()))
