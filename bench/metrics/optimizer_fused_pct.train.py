"""Share of the parameter elements the optimizer updated that its fused
route updated (one in-place kernel pass), over the timeline window's
steps: the program's ``optim.fused`` counter over ``optim.params``, in
%."""
from bench.harness import spans


def read(ctx):
    win = spans.of(ctx)
    if win is None:
        return None
    counts = [win.spans[i].counts for i in win.steps]
    params = sum(c.get("optim.params", 0) for c in counts)
    if params <= 0:
        return None
    return 100.0 * sum(c.get("optim.fused", 0) for c in counts) / params
