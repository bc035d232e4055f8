"""Share of the candidate slots NA's launches visit that hold a candidate:
100 × ``valid`` ÷ ``slots`` of the program's ``NA_SLOTS``
(``kernels/fused_prune_aggregate/ops.py``). The counters tick at the
session's warm-up and capture, never on a replay, so the ratio is one
forward's; the rest is the layout's padding."""
from portbench.program_trace import na_slots

UNIT = "%"


def read(ctx):
    slots = na_slots() if ctx.cuda else None
    return None if slots is None else 100.0 * slots["valid"] / slots["slots"]
