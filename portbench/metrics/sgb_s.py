"""Host seconds of the SGB in ``pipeline.prepare``: the program's span
``sgb`` (``data/sgb_cache.build_or_load``: the graph's fingerprint, then
the cache entry read, or the build and its save)."""
from portbench.program_trace import span_seconds

UNIT = "s"


def read(ctx):
    return span_seconds("sgb") if ctx.cuda else None
