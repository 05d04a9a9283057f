"""Operations and bytes of one matrix product, from the shapes and dtypes
the profiler records for ``aten::mm``, ``aten::addmm`` and ``aten::bmm``:
2 M N K FLOPs (times the batch for ``bmm``); each operand read once and
the product written once.  Every cell trains in fp32; a product of another
type is not counted.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

ELEMENT_BYTES = {"float": 4}


def cost(op: str, shapes: List[list], dtypes: List[str]
         ) -> Optional[Tuple[float, float]]:
    """(FLOPs, bytes), or None for shapes that are no product or a type
    that is not counted."""
    es = ELEMENT_BYTES.get(dtypes[0] if dtypes else "float")
    if es is None:
        return None
    if op == "aten::mm" and len(shapes) >= 2:
        (m, k), (_, n) = shapes[0], shapes[1]
        return 2.0 * m * n * k, es * (m * k + k * n + m * n)
    if op == "aten::addmm" and len(shapes) >= 3:
        bias, (m, k), (_, n) = shapes[0], shapes[1], shapes[2]
        return 2.0 * m * n * k, es * (math.prod(bias) + m * k + k * n
                                      + m * n)
    if op == "aten::bmm" and len(shapes) >= 2:
        (b, m, k), (_, _, n) = shapes[0], shapes[1]
        return 2.0 * b * m * n * k, es * b * (m * k + k * n + m * n)
    return None


def share(trace, select=lambda op, shapes: True) -> Optional[float]:
    """Summed bound over summed device time, in %, of the traced window's
    products that ``select(op, shapes)`` keeps, each timed by the kernels
    the profiler correlates with it; None where there is none."""
    from bench.costs.peaks import bound_s
    if trace is None:
        return None
    time_of = {}
    for k in trace.in_window():
        if k.corr in trace.matmuls:
            time_of[k.corr] = time_of.get(k.corr, 0) + (k.end_ns - k.start_ns)
    bound, busy = 0.0, 0.0
    for corr, ns in time_of.items():
        op, shapes, dtypes = trace.matmuls[corr]
        got = cost(op, shapes, dtypes) if select(op, shapes) else None
        if got is not None:
            bound += bound_s(*got)
            busy += ns / 1e9
    return 100.0 * bound / busy if busy > 0 else None
