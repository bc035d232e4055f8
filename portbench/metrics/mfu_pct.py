"""The whole forward's share of the card's float32 peak: the model FLOPs of
one forward (each configuration's ``flops``, from shapes and the kept
slots) over the time a forward of the run's untraced window (host clock,
ending in a synchronize) at 67 TFLOP/s."""
from portbench.yardstick import PEAK_F32_FLOPS

UNIT = "%"


def read(ctx):
    if not ctx.cuda:
        return None
    return 100.0 * ctx.model_flops / (ctx.forward_ms / 1e3 * PEAK_F32_FLOPS)
