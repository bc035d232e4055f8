"""The port's tracing: spans on the host clock, and the forward's stages on
the device. The launch and slot counters live beside the code they count
(``flows.DISPATCH``, the kernels' ``LAUNCHES``, ``NA_SLOTS``); this module
holds what has a start and an end.

Spans. ``with trace.span(name, **attrs) as sp:`` records the name, its
start and end (``time.perf_counter_ns``), the span it opened inside on its
thread (its parent), the thread and a few attributes (``sp.set(...)`` adds
some before the span closes, such as a cache status). Totals by name
(count, seconds) are always kept; the spans themselves go into a ring of
the last ``RING``. ``spans()``, ``totals()`` and ``reset()`` read and clear
them. Nothing is written to disk.

The switch. A per-call span (``session.call`` and its parts) is recorded
while tracing is on: under :func:`enable` (or ``REPRO_TORCH_TRACE=1`` at
import). A hot path reads :func:`recording` once a call and, while it
is false, opens no span at all. A build span
(``always=True``: ``prepare``, ``sgb``, ``upload``, ``model``,
``compile``, ``warmup``, ``capture`` and their parts; once a build) is
recorded whatever the switch says. While a ``torch`` profiler records,
every span is also a profiler range (``torch``'s C++ record function,
several times cheaper than ``torch.profiler.record_function``), on the
profiler's clock with the device trace, so a profile names the host's
stages; with tracing off a per-call span is then that range alone,
neither kept nor totalled, which leaves the host of a profiled loop
nearly as fast as without the spans.

Device stages. With ``enable(device=True)`` in force when a session is
captured, the forward's stage boundaries (:func:`mark` in
``HGNNModel.apply``: ``project``, ``na.<graph>``, ``fuse``, ``readout``) are
timing events recorded into the CUDA graph (``external=True``), and each
call of the session records events on its stream around the copy-in, the
replay and the read-out. :func:`stage_ms` waits for the session's last
call and returns its device ms by stage. Off, a capture records no event:
the graph is the one without tracing, node for node.
"""
from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

RING = 4096  # spans kept, the newest

_on = os.environ.get("REPRO_TORCH_TRACE", "") == "1"
_device = False
_ring: collections.deque = collections.deque(maxlen=RING)
_totals: Dict[str, List[int]] = {}  # name -> [count, nanoseconds]
_lock = threading.Lock()
_local = threading.local()  # .stack: open span ids; .stages: the recorder of a capture
_ids = itertools.count(1)
# a profiler range: torch's C++ one where it has it, else the Python one
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function


class Span(NamedTuple):
    """One closed span; ``parent`` is the id of the span it opened inside
    on its thread (``None`` at the top)."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    thread: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span being recorded (what ``span`` gives while tracing records)."""

    __slots__ = ("name", "attrs", "id", "parent", "start", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> "_Open":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Open":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _Range(self.name)
            self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        rec = Span(self.id, self.name, self.start, end, self.parent, threading.get_ident(), self.attrs)
        with _lock:
            tot = _totals.setdefault(self.name, [0, 0])
            tot[0] += 1
            tot[1] += end - self.start
            _ring.append(rec)
        return False


class _Null:
    """What ``span`` gives while tracing is off: records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_Null":
        return self


_NULL = _Null()


class _RangeOnly:
    """What ``span`` gives for a per-call span while tracing is off and a
    profiler records: the profiler range, nothing kept."""

    __slots__ = ("_range",)

    def __init__(self, name: str):
        self._range = _Range(name)

    def __enter__(self) -> "_RangeOnly":
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        return False

    def set(self, **attrs) -> "_RangeOnly":
        return self


def span(name: str, always: bool = False, **attrs):
    """A context manager recording the span ``name`` with ``attrs``: a
    build span (``always=True``) whatever the switch says, a per-call span
    only while tracing is on, and only as a profiler range while it is off
    and a profiler records (module docstring). It yields an object whose
    ``set(**attrs)`` adds attributes."""
    if always or _on:
        return _Open(name, attrs)
    if _profiler._is_profiler_enabled:
        return _RangeOnly(name)
    return _NULL


def enable(device: bool = False) -> None:
    """Record per-call spans; with ``device=True`` also the device stages
    of every session captured from now on."""
    global _on, _device
    _on, _device = True, bool(device)


def disable() -> None:
    """Record build spans only (per-call spans are profiler ranges alone
    while a profiler records); sessions captured from now on carry no
    stage events."""
    global _on, _device
    _on = _device = False


def enabled() -> bool:
    """Whether per-call spans are recorded now."""
    return _on


def recording() -> bool:
    """Whether a per-call span site records anything now: tracing is on,
    or a ``torch`` profiler records (then as a profiler range). A hot path
    reads this once a call and, while it is false, opens no span."""
    return _on or _profiler._is_profiler_enabled


def spans() -> List[Span]:
    """The spans in the ring, oldest first."""
    with _lock:
        return list(_ring)


def totals() -> Dict[str, Tuple[int, float]]:
    """``{name: (count, seconds)}`` over every span closed since the last
    ``reset``, ring or not."""
    with _lock:
        return {name: (n, ns / 1e9) for name, (n, ns) in _totals.items()}


def reset() -> None:
    """Forget every closed span and total (open spans record on closing)."""
    with _lock:
        _ring.clear()
        _totals.clear()


class Stages:
    """The device stages of one captured forward: ``marks``, the
    ``(stage, event)`` boundaries recorded into its graph in order (the
    stage ``None`` closes the last one), and four events each call records
    on its stream: before the copy-in, before the replay, after the replay
    and after the read-out (:meth:`point`)."""

    def __init__(self):
        self.marks: List[Tuple[Optional[str], torch.cuda.Event]] = []
        self.points: List[torch.cuda.Event] = []

    def point(self, i: int, stream: torch.cuda.Stream) -> None:
        """Record the call's ``i``-th event on ``stream``."""
        if not self.points:
            self.points = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        self.points[i].record(stream)


class stages_of_capture:
    """Around a capture: while device tracing is on, collects the stage
    marks the captured forward records (``as rec``: the :class:`Stages`,
    or ``None`` with device tracing off)."""

    def __enter__(self) -> Optional[Stages]:
        self._prev = getattr(_local, "stages", None)
        self.rec = Stages() if _device else None
        _local.stages = self.rec
        return self.rec

    def __exit__(self, *exc) -> bool:
        _local.stages = self._prev
        return False


def mark(stage: Optional[str]) -> None:
    """A stage boundary of the forward: from here to the next mark the
    device runs ``stage`` (``None`` after the last stage). Recorded only
    inside :class:`stages_of_capture` with device tracing on, while the
    stream is capturing; anywhere else it does nothing."""
    rec = getattr(_local, "stages", None)
    if rec is None or not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        return
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    rec.marks.append((stage, ev))


def stage_ms(session) -> Optional[Dict[str, float]]:
    """Device ms of the session's last call by stage: ``copy_in``, each
    stage the forward marked (summed by name), ``read_out``, and
    ``replay``, the whole replay, which the marked stages split but for
    ``launch`` (from the replay's start to its first stage) and ``tail``
    (from its last stage to its end). Waits for that call. ``None`` for a
    session captured without device tracing, or not called since."""
    rec = getattr(session, "_stages", None)
    if rec is None or not rec.points:
        return None
    p, marks = rec.points, rec.marks
    p[3].synchronize()
    out = {"copy_in": p[0].elapsed_time(p[1]), "launch": p[1].elapsed_time(marks[0][1])}
    for (stage, a), (_, b) in zip(marks, marks[1:]):
        out[stage] = out.get(stage, 0.0) + a.elapsed_time(b)
    out["tail"] = marks[-1][1].elapsed_time(p[2])
    out["read_out"] = p[2].elapsed_time(p[3])
    out["replay"] = p[1].elapsed_time(p[2])
    return out
