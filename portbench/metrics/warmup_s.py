"""Host seconds of the session's eager warm-up before its capture: the
program's span ``warmup`` (``core/session._capture_graph``), which holds
the kernel library's load and the first fill of NA's device tables."""
from portbench.program_trace import span_seconds

UNIT = "s"


def read(ctx):
    return span_seconds("warmup") if ctx.cuda else None
