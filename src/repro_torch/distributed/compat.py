"""One import point for the distributed PyTorch APIs the port uses
(the counterpart of ``repro/distributed/compat.py``, the ``shard_map`` /
``make_mesh`` shim).

The port imports DTensor, the device mesh, ``local_map``,
``CommDebugMode``, the fake process group and ``MemTracker`` from here
only (several live in private or experimental modules), so a release that
moves a name is a change of this file.  Importing this module starts
nothing: no process group, no mesh, no device.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard)
from torch.distributed.tensor import distribute_tensor as _distribute
from torch.distributed.tensor import zeros as _dtensor_zeros
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map as _local_map)

__all__ = ["CommDebugMode", "DTensor", "DeviceMesh", "Partial", "Placement",
           "Replicate", "Shard", "distribute_tensor", "from_local",
           "group_size", "implicit_replication", "init_device_mesh",
           "init_fake_group", "is_dtensor", "local_map", "mem_tracker"]


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def distribute_tensor(t: torch.Tensor, mesh: DeviceMesh,
                      placements: Sequence[Placement]) -> DTensor:
    """``t`` (the same global tensor on every rank) as a DTensor: each rank
    keeps its own shard, with no collective (``src_data_rank=None``)."""
    return _distribute(t, mesh, list(placements), src_data_rank=None)


def from_local(t: torch.Tensor, mesh: DeviceMesh,
               placements: Sequence[Placement], shape=None,
               stride=None) -> DTensor:
    return DTensor.from_local(t, mesh, list(placements), run_check=False,
                              shape=shape, stride=stride)


def local_map(fn, out_placements, in_placements, mesh: DeviceMesh,
              in_grad_placements=None):
    """``fn`` over the local tensors of DTensor arguments.  The caller has
    already redistributed every input to ``in_placements``; non-tensor
    arguments take ``None``.  ``in_grad_placements`` say what each input's
    local gradient is (by default the input's own placements)."""
    return _local_map(fn, out_placements=out_placements,
                      in_placements=in_placements,
                      in_grad_placements=in_grad_placements,
                      device_mesh=mesh, redistribute_inputs=False)


def dtensor_zeros(shape, mesh: DeviceMesh, placements, dtype) -> DTensor:
    """A zero DTensor whose ranks allocate only their own shards."""
    return _dtensor_zeros(tuple(shape), dtype=dtype, device_mesh=mesh,
                          placements=list(placements))


def group_size(group_name: str) -> int:
    """Ranks in the process group a functional collective names."""
    from torch.distributed import distributed_c10d as c10d
    return c10d._resolve_process_group(group_name).size()


def init_fake_group(world_size: int, rank: int = 0) -> None:
    """A process group of ``world_size`` ranks that moves no data (the
    ``"fake"`` backend of PyTorch's test utilities): collectives return at
    once, so one process can trace a step at production mesh size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


@contextlib.contextmanager
def marking_shape_inference(flag: list):
    """While inside, ``flag[0]`` is True during DTensor's own shape
    inference: its sharding propagator runs each new op once on fake
    tensors of the *global* shape to learn the output's metadata, which
    is no work on any device (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``, private)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, op_schema):
        prev, flag[0] = flag[0], True
        try:
            return orig(self, op_schema)
        finally:
            flag[0] = prev

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield flag
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


@contextlib.contextmanager
def mem_tracker():
    """``torch.distributed._tools.mem_tracker.MemTracker`` entered; yields
    the tracker (``get_tracker_snapshot("peak")``)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    mt = MemTracker()
    with mt:
        yield mt
