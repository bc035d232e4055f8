"""Reading a traced window: device time by kernel name, the device's busy
time, and the longest idle gaps with what the host was doing in each.

``device_ms`` is the reduction of ``chip_smoke.py``'s ``device_times``
(lines 1395-1404): the self device time of every CUDA event summed by
name, taken over the profile's events rather than ``key_averages`` so that
the GPU-side copies of host annotations (``record_function`` spans, which
are no device work) are left out. ``timeline`` reads the same events as
intervals for the busy time (their union) and the gaps.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def _device_work(ev) -> bool:
    from torch.autograd import DeviceType

    return ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)


def device_ms(prof) -> Dict[str, float]:
    """Device ms by kernel (or copy) name over the whole profile."""
    per_kernel: Dict[str, float] = {}
    for ev in prof.events():
        if _device_work(ev):
            us = ev.time_range.elapsed_us()
            if us > 0:
                per_kernel[ev.name] = per_kernel.get(ev.name, 0.0) + us / 1e3
    return per_kernel


def timeline(prof, skip=()) -> Tuple[List[Tuple[float, float]], List[Tuple[float, float, str, int]]]:
    """``(device intervals, host intervals)`` in µs on the profiler's
    clock: every device event as ``(start, end)`` (names in ``skip``, the
    run's own annotations, left out), every host event as ``(start, end,
    name, thread)``."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if _device_work(ev) and ev.name not in skip:
            dev.append((tr.start, tr.end))
        elif ev.device_type != DeviceType.CUDA:
            host.append((tr.start, tr.end, ev.name, ev.thread))
    return dev, host


def busy_and_gaps(dev: List[Tuple[float, float]], lo: float, hi: float):
    """``(busy µs, gaps)`` of the device intervals clipped to ``[lo, hi]``:
    the union's length, and every idle stretch between ``lo`` and ``hi`` as
    ``(start, end)``."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    pos = lo
    for s, e in sorted(dev):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > pos:
                gaps.append((pos, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        pos = max(pos, cur_e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if hi > pos:
        gaps.append((pos, hi))
    return busy, gaps


def name_gap(host, at: float, thread) -> str:
    """What the host thread ``thread`` was doing at ``at``: the innermost
    (latest starting) host event that covers it, or ``host`` if none."""
    best = None
    for s, e, name, th in host:
        if th == thread and s <= at < e and (best is None or s >= best[0]):
            best = (s, name)
    return best[1] if best else "host"
