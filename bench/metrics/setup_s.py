"""Host-clock seconds from the process's start to the window's start:
imports, the kernels' libraries (built on a checkout's first run), weights,
optimizer state and the warm-up steps."""


def read(ctx):
    return ctx.setup_s
