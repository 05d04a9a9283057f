"""``torch.cuda.max_memory_allocated()`` over the window, in 1e9 bytes."""


def read(ctx):
    peak = ctx.window["peak_bytes"]
    return peak / 1e9 if peak > 0 else None
