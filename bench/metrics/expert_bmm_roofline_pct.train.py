"""The MoE layer's expert products: the ``aten::bmm`` calls whose batch
dimension is the expert count; summed bound over summed device time, in %."""
from bench.costs.matmul import share


def read(ctx):
    experts = ctx.m.get("n_experts", 0)
    if not experts:
        return None
    return share(ctx.trace, lambda op, shapes: op == "aten::bmm"
                 and shapes[0][0] == experts)
