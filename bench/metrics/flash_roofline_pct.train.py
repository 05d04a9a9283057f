"""The flash-attention kernels (forward, backward preprocess, dQ, dK/dV),
found by name in the traced window: summed bound over summed device time,
in %.  Each launch's shape is its step's rows and length with the model's
heads and head size."""
from bench.costs import flash
from bench.costs.peaks import bound_s
from bench.reference.transformer import head_dim


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    heads, d = ctx.m["n_heads"], head_dim(ctx.m)
    bound, busy = 0.0, 0.0
    for k in tr.in_window():
        kind = flash.kind_of(k.name)
        step = tr.step_of(k.start_ns) if kind else None
        if step is None:
            continue
        bound += bound_s(*flash.cost(kind, step.rows * heads, step.seq, d))
        busy += (k.end_ns - k.start_ns) / 1e9
    return 100.0 * bound / busy if busy > 0 else None
