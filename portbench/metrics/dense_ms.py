"""Device ms a forward of every device operation that is not an NA kernel:
projections, Eq. 2's contractions, fusion, the readout, the parameter
copy-in and the output's clone (``core/projection.py``,
``core/attention.py``, ``core/semantic_fusion.py``, ``core/models/*``,
``core/session.py``)."""
import re

UNIT = "ms"
NA_KERNEL = re.compile(r"(grouped|flat)_(prune_aggregate|prune|aggregate)_kernel")


def read(ctx):
    if not ctx.device_ms:
        return None
    return sum(ms for name, ms in ctx.device_ms.items() if not NA_KERNEL.search(name)) / ctx.traced_forwards
