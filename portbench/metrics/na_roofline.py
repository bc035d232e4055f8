"""The NA kernels' share of their roofline: the least time of every NA of
one forward (``yardstick.na_bound`` on the bytes and operations the
reference's own top-K needs: valid slots, distinct sources, kept slots and
rows) over their measured device time (``na_ms``)."""
import re

UNIT = "%"
NA_KERNEL = re.compile(r"(grouped|flat)_(prune_aggregate|prune|aggregate)_kernel")


def read(ctx):
    na = sum(ms for name, ms in ctx.device_ms.items() if NA_KERNEL.search(name)) / ctx.traced_forwards if ctx.device_ms else 0.0
    if na <= 0:
        return None
    return 100.0 * sum(r["bound"][0] for r in ctx.records) / na
