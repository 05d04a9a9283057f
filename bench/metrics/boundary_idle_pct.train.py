"""Share of the timeline window in which the device sat idle while the host
was outside the program's ``train_step`` span: the trainer's control plane,
the tail of the step's one host transfer, the harness between steps; in
%."""
from bench.harness import spans


def read(ctx):
    split = spans.idle_split(ctx)
    if split is None:
        return None
    return 100.0 * split[1] / ctx.timeline.window_s()
