"""The legacy monolithic AdamW (copy of ``repro/optim/adam.py:19-75``):
fp32 state ``{"m", "v", "count"}``, global-norm clipping and the paper's
variance telemetry.  The chain in :mod:`repro_torch.optim.transforms`
supersedes it; a legacy state migrates into the chain's format through
``transforms.migrate_opt_state``.  Functional, as the reference: nothing
is updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.stability import momentum_stats, variance_stats
from repro_torch.optim.transforms import (decay_mask_tree, tree_leaves,
                                          tree_map)


def init_opt_state(params: Any) -> Dict[str, Any]:
    zeros = lambda t: tree_map(lambda x: torch.zeros(
        x.shape, dtype=torch.float32, device=x.device), t)
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device)}


def abstract_opt_state(params_shapes: Any) -> Dict[str, Any]:
    """:func:`init_opt_state`'s tree as ``meta`` tensors."""
    meta = lambda t: tree_map(lambda x: torch.empty(
        tuple(x.shape), dtype=torch.float32, device="meta"), t)
    return {"m": meta(params_shapes), "v": meta(params_shapes),
            "count": torch.empty((), dtype=torch.int32, device="meta")}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        [x.float() for x in tree_leaves(tree)], 2)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / gnorm.clamp_min(1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gnorm


def adamw_update(params: Any, grads: Any, opt_state: Dict[str, Any],
                 lr: float, cfg: OptimizerConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step on fp32 (post-clip) grads: ``(new_params,
    new_opt_state, telemetry)``."""
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    count = opt_state["count"] + 1
    cf = count.float()
    bc1 = 1.0 - b1 ** cf
    bc2 = 1.0 - b2 ** cf
    new_m = tree_map(lambda m, g: b1 * m + (1.0 - b1) * g,
                     opt_state["m"], grads)
    new_v = tree_map(lambda v, g: b2 * v + (1.0 - b2) * g * g,
                     opt_state["v"], grads)

    def upd(p, m, v, decay):
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if decay:
            step = step + cfg.weight_decay * p
        return (p - lr * step).to(p.dtype)

    mask = decay_mask_tree(params, cfg.decay_mask)
    new_params = tree_map(upd, params, new_m, new_v, mask)
    telemetry = {**variance_stats(tree_leaves(new_v)),
                 **momentum_stats(tree_leaves(new_m))}
    return new_params, {"m": new_m, "v": new_v, "count": count}, telemetry
