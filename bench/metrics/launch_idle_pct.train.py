"""Share of the timeline window in which the device sat idle while the host
was inside the program's ``train_step`` span (issuing the forward, backward
and optimizer), in %.  With ``boundary_idle_pct.train`` it makes up
``device_idle_pct.train``."""
from bench.harness import spans


def read(ctx):
    split = spans.idle_split(ctx)
    if split is None:
        return None
    return 100.0 * split[0] / ctx.timeline.window_s()
