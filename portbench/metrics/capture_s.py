"""Host seconds of ``HGNNTask.compile`` (``core/session.py``): the eager
warm-up (device tables uploaded, kernels loaded) and the CUDA graph's
capture."""
UNIT = "s"


def read(ctx):
    return ctx.capture_s
