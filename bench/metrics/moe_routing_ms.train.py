"""Device milliseconds a step of the timeline window in the MoE layer's
routing: the CUDA events at the ends of the program's ``moe.route``,
``moe.dispatch`` and ``moe.combine`` spans, in the forward pass and in its
recompute, summed over the layers and averaged over the window's steps."""
from bench.harness import spans


def read(ctx):
    win = spans.of(ctx)
    if win is None:
        return None
    return spans.per_step(win, ("moe.route", "moe.dispatch", "moe.combine"),
                          lambda sp: sp.device_ms)
