"""What the program records about itself, read in the run's own process:
the build spans' totals (``repro_torch.trace``) and the NA slot counters
(``kernels/fused_prune_aggregate/ops.py``). A program that records none
(an older checkout) gives ``None``, never an error."""
from __future__ import annotations

from typing import Optional


def span_seconds(name: str) -> Optional[float]:
    """Host seconds of every span ``name`` the program closed, or ``None``."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    got = trace.totals().get(name)
    return got[1] if got else None


def na_slots() -> Optional[dict]:
    """The program's ``NA_SLOTS`` (candidate slots its NA launches visited,
    the valid ones among them, ...), or ``None`` where it keeps none or
    counted no launch."""
    try:
        from repro_torch.kernels.fused_prune_aggregate import ops
    except ImportError:
        return None
    slots = getattr(ops, "NA_SLOTS", None)
    return slots if slots and slots.get("slots") else None
