"""Share of the untraced window in which the device had no forward on its
stream: the time from one call's end to the next call's start, by the CUDA
events that bracket every call (``harness.window``), over the time from the
first call's start to the last call's end. It is the idle the host's pacing
leaves (the calls' host work, the waits, anything else the process does);
gaps inside a replay are the replay's and count as busy."""
UNIT = "%"


def read(ctx):
    if not ctx.span_s:
        return None
    return 100.0 * ctx.idle_s / ctx.span_s
