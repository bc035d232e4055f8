"""Straggler detection and mitigation hooks (the reference's
``repro/runtime/straggler.py``).

On a multi-host deployment each host reports step wall-time; the monitor
flags hosts whose time exceeds ``threshold × rolling-p50`` and the launcher
reacts (re-shard around the host, checkpoint pre-emptively, swap in a hot
spare). In one process the monitor runs on the one step stream and
exercises the same detection and response state machine; the response is
logged and counted rather than re-scheduling hardware.
"""
from __future__ import annotations

import collections
import statistics
import time
from typing import Callable, Deque, Optional


class StragglerMonitor:
    def __init__(
        self,
        window: int = 32,
        threshold: float = 2.0,
        on_straggler: Optional[Callable[[int, float, float], None]] = None,
    ):
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.threshold = threshold
        self.on_straggler = on_straggler
        self.events = []
        self._t0 = None

    def step_start(self):
        self._t0 = time.perf_counter()

    def step_end(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        if len(self.window) >= 8:
            p50 = statistics.median(self.window)
            if dt > self.threshold * p50:
                self.events.append((step, dt, p50))
                if self.on_straggler:
                    self.on_straggler(step, dt, p50)
        self.window.append(dt)
        return dt
