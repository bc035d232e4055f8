"""Host µs a ``session(params)`` call (``core/session.py``: the parameter
copy-in, the graph replay, the output clone enqueued), host clock around
each call of the run's untraced window."""
UNIT = "us"


def read(ctx):
    return ctx.host_s / ctx.forwards * 1e6
