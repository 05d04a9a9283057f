"""Device milliseconds a step of the timeline window in the optimizer: the
CUDA events at the ends of the program's ``step.optimizer`` span (the
clip, AdamW and the parameter update), averaged over the window's steps."""
from bench.harness import spans


def read(ctx):
    win = spans.of(ctx)
    if win is None:
        return None
    return spans.per_step(win, ("step.optimizer",),
                          lambda sp: sp.device_ms)
