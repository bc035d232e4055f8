"""Probe mode (the reference's ``repro/distributed/probe.py``): the
context variable the dry-run sets while it counts a probe cell.

The reference needs probes because XLA's cost analysis visits a ``while``
body once: it compiles shallow copies of a cell with every scan unrolled
(``xscan`` under ``probe_mode()``) and extrapolates to the real depth. The
port's loops over layers, flash chunks and RWKV chunks are Python loops,
so its counts are exact at any depth and nothing here unrolls: the
dry-run (``launch/dryrun.py``) still counts the reference's probe configs
and fits them as the reference does, and :func:`probing` says whether a
probe is being counted. ``xscan`` has no caller in the port and is not
ported.
"""
from __future__ import annotations

import contextlib
import contextvars

_PROBE = contextvars.ContextVar("repro_torch_probe_mode", default=False)


@contextlib.contextmanager
def probe_mode():
    """Mark the block as a probe's count."""
    tok = _PROBE.set(True)
    try:
        yield
    finally:
        _PROBE.reset(tok)


def probing() -> bool:
    """Whether a :func:`probe_mode` block is running."""
    return _PROBE.get()
