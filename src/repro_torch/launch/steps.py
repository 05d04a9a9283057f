"""The train step and the train state (``repro/launch/steps.py:35-153,
219-226``, default branch).

``make_train_step`` computes the loss and its gradient, runs the optimizer
chain with ``hyper = {"lr", "clip_scale"}`` and returns the new state and
``{**metrics, **telemetry, "lr"}``.  The reference jits the step and
donates the state; here the step runs eagerly and updates the params and
the Adam moments in place.  The GNS measurement and the ``grad_scale`` /
``leaf_lr`` runtime vectors are not ported yet and raise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.models import model_zoo
from repro_torch.optim import transforms as optim_tx


def make_train_step(model, opt_cfg: OptimizerConfig):
    """``train_step(state, batch, lr, clip_scale=1.0) -> (state, metrics)``;
    ``batch`` holds tensors on the params' device.  The metrics are 0-dim
    tensors, the ``lr`` a float."""
    tx = optim_tx.build_optimizer(opt_cfg)

    def train_step(state, batch, lr, clip_scale=1.0, grad_scale=None,
                   leaf_lr=None):
        if grad_scale is not None or leaf_lr is not None:
            raise NotImplementedError("grad_scale / leaf_lr (fault injection "
                                      "and recovery) are not ported yet")
        params = state["params"]
        leaves = optim_tx.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            updates, new_opt, telemetry = tx.update(
                optim_tx.tree_unflatten(params, list(grads)), state["opt"],
                params, {"lr": lr, "clip_scale": clip_scale})
            new_params = optim_tx.apply_updates(params, updates)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return new_state, {**metrics, **telemetry, "lr": lr}

    return train_step


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     opt_cfg: Optional[OptimizerConfig] = None,
                     device: torch.device = torch.device("cuda")
                     ) -> Dict[str, Any]:
    """Params drawn from ``generator`` (the reference's distributions, not
    its numbers), the chain's initial state and step 0."""
    params = model_zoo.init_params(cfg, generator, device)
    tx = optim_tx.build_optimizer(opt_cfg or OptimizerConfig())
    return {"params": params, "opt": tx.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}
