"""Peak device memory of the window less what the trainer holds between
steps (``memory_allocated()`` at the window's start), in 1e9 bytes: the
activations, gradients and temporaries of a step."""


def read(ctx):
    w = ctx.window
    if w["peak_bytes"] <= 0:
        return None
    return (w["peak_bytes"] - w["base_bytes"]) / 1e9
