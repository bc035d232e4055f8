"""Device ms a forward of the NA kernels (``kernels/fused_prune_aggregate``:
the fused grouped and flat launches, and the K1 / K2 step kernels should a
path launch them apart), from the profiler by kernel name."""
import re

UNIT = "ms"
NA_KERNEL = re.compile(r"(grouped|flat)_(prune_aggregate|prune|aggregate)_kernel")


def read(ctx):
    if not ctx.device_ms:
        return None
    return sum(ms for name, ms in ctx.device_ms.items() if NA_KERNEL.search(name)) / ctx.traced_forwards
