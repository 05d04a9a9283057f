"""Every ``aten::mm`` / ``addmm`` / ``bmm`` of the traced window: summed
roofline bound over the summed device time of the kernels each launched,
in %."""
from bench.costs.matmul import share


def read(ctx):
    return share(ctx.trace)
