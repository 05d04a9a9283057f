"""Share of the measured window in which no device activity ran, in %,
from the timeline (device activity alone, so the host keeps nearly its
untraced pace)."""


def read(ctx):
    tr = ctx.timeline
    if tr is None or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
