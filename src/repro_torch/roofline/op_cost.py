"""FLOPs and bytes of a step per device, counted from the ops it dispatches
(the counterpart of ``repro/roofline/jaxpr_cost.py``).

The reference walks the traced jaxpr and counts global FLOPs.  Here a
dispatch mode counts the aten ops a call runs.  DTensor ops pass through
it, so DTensor desugars them first and the mode sees each rank's local
ops at their local shapes: the counts are per device, as the reference's
``cost_analysis`` of a sharded module is (``analysis.py:1-12``).  The
ops DTensor runs on global-shape fake tensors to infer an output's shape
are not counted.
(``torch.utils.flop_counter.FlopCounterMode`` alone would count a
DTensor op at its global shape.)

* FLOPs: ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
  SDPA), plus what the CUDA kernels' wrappers report of their own launches
  (``kernels.note_cost``): a kernel called through ctypes is no aten op.
* Bytes: the eager model the port runs, every op reading its inputs and
  writing its output once (views, reshapes and in-place metadata are
  free).  PyTorch eager does not fuse element-wise chains, so this is the
  traffic of the run, not of a fused program.

Both are computed on fake or meta tensors as well as real ones, so a dry
run counts a production-size step with no allocation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels
from repro_torch.distributed.compat import DTensor, marking_shape_inference

_FREE = {"view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
         "t", "squeeze", "unsqueeze", "select", "slice", "alias", "as_strided",
         "detach", "unbind", "split", "split_with_sizes", "chunk",
         "_to_copy_meta", "lift_fresh", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided", "_reshape_alias",
         "view_as_real", "view_as_complex", "unflatten", "flatten",
         "narrow", "diagonal", "sym_size", "sym_stride", "sym_numel",
         "is_same_size", "_local_scalar_dense", "wait_tensor"}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    by_op: Dict[str, float] = field(default_factory=dict)

    def add(self, op: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        if flops:
            self.by_op[op] = self.by_op.get(op, 0.0) + flops

    def top(self, n: int = 8) -> Dict[str, float]:
        return dict(sorted(self.by_op.items(), key=lambda kv: -kv[1])[:n])


def _tensor_bytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _on_meta(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return x.device.type == "meta"
    if isinstance(x, (list, tuple)):
        return any(_on_meta(t) for t in x)
    return False


class _CostMode(TorchDispatchMode):
    def __init__(self, cost: Cost, inferring: list):
        super().__init__()
        self.cost = cost
        self.inferring = inferring

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor desugar into local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        if ("c10d" in str(func) or name in _FREE or self.inferring[0]
                or _on_meta(out)):
            return out
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        nbytes = (sum(_tensor_bytes(a) for a in args)
                  + sum(_tensor_bytes(v) for v in kwargs.values())
                  + _tensor_bytes(out))
        self.cost.add(name, flops, nbytes)
        return out


def analyze_fn(fn, *args, **kwargs) -> Tuple[Cost, Any]:
    """Run ``fn(*args, **kwargs)`` and count its FLOPs and bytes on this
    device -> (cost, fn's result)."""
    cost = Cost()
    kernels.COST_SINKS.append(cost.add)
    try:
        with marking_shape_inference([False]) as inferring, \
                _CostMode(cost, inferring):
            result = fn(*args, **kwargs)
    finally:
        kernels.COST_SINKS.remove(cost.add)
    return cost, result
