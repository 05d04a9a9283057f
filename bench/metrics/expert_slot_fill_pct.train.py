"""Share of the routed experts' capacity slots that hold a token, over the
timeline window's steps: the program's ``moe.kept`` counter (top-k
assignments inside the capacity) over ``moe.slots`` (batch rows x experts
x capacity, summed over the layers), in %."""
from bench.harness import spans


def read(ctx):
    win = spans.of(ctx)
    if win is None:
        return None
    counts = [win.spans[i].counts for i in win.steps]
    slots = sum(c.get("moe.slots", 0) for c in counts)
    if slots <= 0:
        return None
    return 100.0 * sum(c.get("moe.kept", 0) for c in counts) / slots
