"""Host seconds of ``pipeline.prepare`` (``core/pipeline.py``,
``core/hetgraph.py``, ``data/sgb_cache.py``): the SGB built or read from
the checkout's cache, the batch uploaded, the model built."""
UNIT = "s"


def read(ctx):
    return ctx.prepare_s
