"""Production mesh builders (``repro/launch/mesh.py:20-41``).

Importing this module starts no process group and builds no mesh: meshes
are built inside functions only, on the process group the caller started
(NCCL across cards, gloo on the CPU, or the fake group of a dry run).

Axis semantics:
  pod   -- data parallelism across pods (the gradient all-reduce)
  data  -- FSDP within a pod (params and optimizer state reduce-scattered)
  model -- tensor and expert parallelism within a pod
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.distributed.compat import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod",
    "data", "model")``, over a process group of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                   device_type: str = "cpu") -> DeviceMesh:
    """A small mesh over the started process group's ranks (the mini-mesh
    tests run it on gloo ranks, the card's phase on one NCCL rank)."""
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def dp_size(mesh) -> int:
    """Data-parallel width: the product of the "pod" and "data" axes."""
    from repro_torch.distributed.sharding import mesh_axes
    sizes = mesh_axes(mesh)
    n = 1
    for a in ("pod", "data"):
        n *= sizes.get(a, 1)
    return n
