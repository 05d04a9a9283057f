"""ctypes wrapper of ``csrc/fused_adamw.cu``: the default AdamW chain of
``repro_torch.optim.transforms`` (clip -> adam -> decay -> lr, then the
update) as two passes over a table of fp32 leaves, in place.

It replaces no TPU kernel: the reference's optimizer is XLA's fusion of the
same chain.  Its plain version is the chain itself: the route that calls
:func:`fused_adamw` (``transforms.fused_adamw_step``) takes CUDA tensors
alone and launches this or raises; ``transforms.optimizer_step`` runs the
chain on any other leaves.

:class:`LeafTable` lays one parameter set out for the kernel once: per leaf
the param, m and v pointers, the length, the decay flag and the leaf's
group (``core.telemetry.leaf_groups``, which indexes
``hyper["leaf_lr_scale"]``), int64 x 5 a leaf; the (leaf, chunk) pairs of
the kernel's fixed chunks; and the scratch of the block partials.  The
params and the moments are updated in place, so their pointers stay put
and one table serves every step.  The gradients are new each step: their
pointers go up in one host-to-device copy from pinned memory, on the
stream, with no wait on the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import note_cost, stream_of
from repro_torch.kernels._build import check, library

# the telemetry the chain reports, in the order the kernel writes it
TELEMETRY = ("grad_norm", "grad_norm_clipped", "var_l1", "var_max", "mom_l1")


@functools.cache
def _lib():
    lib = library("fused_adamw")
    ptr = ctypes.c_void_p
    lib.fused_adamw.argtypes = (
        [ptr, ptr, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
         ctypes.c_int] + [ctypes.c_float] * 8 + [ptr])
    lib.fused_adamw.restype = ctypes.c_int
    lib.fused_adamw_chunk.restype = ctypes.c_int
    lib.fused_adamw_max_grid.restype = ctypes.c_int
    return lib


def chunk_table(lengths: Sequence[int], chunk: int) -> np.ndarray:
    """(n_chunks, 2) int32 (leaf, chunk index in the leaf) of leaves of
    ``lengths`` cut into chunks of ``chunk`` elements, leaf by leaf (an
    empty leaf has none)."""
    lens = np.asarray(lengths, dtype=np.int64)
    per = -(-lens // chunk)
    leaf = np.repeat(np.arange(lens.size, dtype=np.int64), per)
    first = np.repeat(np.cumsum(per) - per, per)
    out = np.stack([leaf, np.arange(leaf.size, dtype=np.int64) - first], 1)
    if out.size and out.max() >= 2 ** 31:
        raise ValueError("too many leaves or chunks for int32")
    return out.astype(np.int32).reshape(-1, 2)


def _key(params, m, v) -> Tuple[int, ...]:
    return tuple(t.data_ptr() for t in (*params, *m, *v)) + tuple(
        p.numel() for p in params)


def _check_leaves(name: str, leaves: Sequence[torch.Tensor],
                  shapes: Sequence[torch.Size], device) -> None:
    for i, (t, shape) in enumerate(zip(leaves, shapes)):
        if (t.dtype != torch.float32 or t.device != device
                or t.shape != shape or not t.is_contiguous()):
            raise ValueError(
                f"{name}[{i}]: want a contiguous float32 {tuple(shape)} on "
                f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


class LeafTable:
    """One parameter set (params and their Adam moments, leaf for leaf) laid
    out for the kernel on the params' device."""

    def __init__(self, params: List[torch.Tensor], m: List[torch.Tensor],
                 v: List[torch.Tensor], decay: Sequence[bool],
                 group_of: Sequence[int]):
        if not params or not (len(params) == len(m) == len(v) == len(decay)
                              == len(group_of)):
            raise ValueError("want params, m, v, decay and group_of leaf for "
                             "leaf")
        self.device = params[0].device
        self.shapes = [p.shape for p in params]
        for name, leaves in (("params", params), ("m", m), ("v", v)):
            _check_leaves(name, leaves, self.shapes, self.device)
        self.key = _key(params, m, v)
        self.numel = sum(p.numel() for p in params)
        self.n_groups = max(group_of) + 1
        rows = [[p.data_ptr(), mm.data_ptr(), vv.data_ptr(), p.numel(),
                 int(d) | (g << 1)]
                for p, mm, vv, d, g in zip(params, m, v, decay, group_of)]
        lib = _lib()
        chunks = chunk_table([r[3] for r in rows], lib.fused_adamw_chunk())
        self.n_chunks = chunks.shape[0]
        self.leaves = torch.tensor(rows, dtype=torch.int64, device=self.device)
        self.chunks = torch.from_numpy(chunks).to(self.device)
        self.grads = torch.empty(len(rows), dtype=torch.int64,
                                 device=self.device)
        self.part = torch.empty(4 * lib.fused_adamw_max_grid(),
                                dtype=torch.float64, device=self.device)
        self.scal = torch.empty(3, dtype=torch.float32, device=self.device)

    def holds(self, params, m, v) -> bool:
        """Whether the table lays out exactly these leaves."""
        return _key(params, m, v) == self.key


def fused_adamw(table: LeafTable, grads: List[torch.Tensor],
                count: torch.Tensor, *, lr: float, clip: bool, limit: float,
                b1: float, b2: float, eps: float, weight_decay: float,
                leaf_lr_scale: torch.Tensor = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One AdamW step of the table's leaves: params, m and v in place.
    ``clip``: scale the gradients to at most ``limit`` in global norm.
    Returns ``count + 1`` (a new 0-dim int32 tensor) and the chain's five
    telemetry scalars (0-dim fp32 tensors on the device).  ``launches``
    counts the calls (four CUDA launches each)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"fused_adamw runs on CUDA tensors, not {dev}; the "
                         f"chain is its plain version")
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    _check_leaves("grads", grads, table.shapes, dev)
    if count.shape != () or count.dtype != torch.int32 or count.device != dev:
        raise ValueError(f"want a 0-dim int32 count on {dev}, got "
                         f"{count.dtype} {tuple(count.shape)} on {count.device}")
    scales_ptr = None
    if leaf_lr_scale is not None:
        leaf_lr_scale = leaf_lr_scale.to(device=dev, dtype=torch.float32
                                         ).contiguous()
        if leaf_lr_scale.shape != (table.n_groups,):
            raise ValueError(f"want leaf_lr_scale ({table.n_groups},), got "
                             f"{tuple(leaf_lr_scale.shape)}")
        scales_ptr = leaf_lr_scale.data_ptr()
    pinned = torch.empty(len(grads), dtype=torch.int64, pin_memory=True)
    pinned.numpy()[:] = [g.data_ptr() for g in grads]
    table.grads.copy_(pinned, non_blocking=True)
    out = torch.empty(len(TELEMETRY), dtype=torch.float32, device=dev)
    new_count = torch.empty((), dtype=torch.int32, device=dev)
    check(_lib().fused_adamw(
        table.leaves.data_ptr(), table.chunks.data_ptr(), table.n_chunks,
        table.grads.data_ptr(), count.data_ptr(), new_count.data_ptr(),
        out.data_ptr(), table.scal.data_ptr(), table.part.data_ptr(),
        scales_ptr, int(clip), limit, lr, b1, b2, 1.0 - b1, 1.0 - b2, eps,
        weight_decay, stream_of(out)), "fused_adamw")
    fused_adamw.launches += 1
    # element-wise work, which the op counter counts as bytes alone: g read
    # twice, p, m, v read and written once
    note_cost("fused_adamw", 0.0, 8 * 4 * table.numel)
    return new_count, dict(zip(TELEMETRY, out.unbind()))


fused_adamw.launches = 0
