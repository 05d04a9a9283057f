"""Parameters and train state of the JAX package -> those of the port.

The JAX model's parameters, taken to the host as a nested dict of numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``), become the port's
tree: the same keys, each stacked subtree the port keeps as a list
(``layers``; Zamba-2's ``mamba_layers``) unstacked along axis 0 into a
list of per-layer dicts, every shape checked against the port's
``ParamDef``s.
A train state ``{"params", "opt", "step"}`` maps the same way, the chain
state leaf for leaf.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.models import model_zoo
from repro_torch.optim.transforms import build_optimizer
from repro_torch.models.layers import ParamDef


def _convert(defs: Any, tree: Any, path: str, device: torch.device) -> Any:
    if isinstance(defs, ParamDef):
        arr = np.asarray(tree)
        if tuple(arr.shape) != tuple(defs.shape):
            raise ValueError(f"{path}: shape {arr.shape} != port's "
                             f"{defs.shape}")
        return torch.as_tensor(np.array(arr, dtype=np.float32), device=device)
    keys = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
    if keys != sorted(defs):
        raise ValueError(f"{path}: keys {keys} != port's {sorted(defs)}")
    return {k: _convert(defs[k], tree[k], f"{path}/{k}", device)
            for k in sorted(defs)}


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_numpy(tree: Any, cfg: ModelConfig,
                      device: torch.device) -> Any:
    """The port's parameters (fp32 tensors on ``device``) from the JAX tree."""
    defs = model_zoo.model_defs(cfg)
    stacked = [k for k, v in defs.items() if isinstance(v, list)]
    out = _convert({k: v for k, v in defs.items() if k not in stacked},
                   {k: v for k, v in tree.items() if k not in stacked}, "",
                   device)
    for key in stacked:
        out[key] = [_convert(layer_defs, _unstack(tree[key], i),
                             f"/{key}/{i}", device)
                    for i, layer_defs in enumerate(defs[key])]
    return out


def _scalar(x: Any, path: str, device: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.shape != ():
        raise ValueError(f"{path}: shape {arr.shape} != ()")
    return torch.tensor(int(arr), dtype=torch.int32, device=device)


def train_state_from_numpy(tree: Any, cfg: ModelConfig,
                           opt_cfg: OptimizerConfig,
                           device: torch.device) -> Any:
    """The port's train state from the reference's, on the host
    (``jax.tree_util.tree_map(np.asarray, state)``): params as
    :func:`params_from_numpy`; the default chain's state with ``adam.m`` and
    ``adam.v`` shaped like the params, ``adam.count`` and ``step`` int32;
    the stateless transforms' empty dicts."""
    names = sorted(build_optimizer(opt_cfg).init({"w": torch.zeros(1)}))
    opt = tree["opt"]
    if sorted(opt) != names:
        raise ValueError(f"/opt: keys {sorted(opt)} != port's {names}")
    for name in names:
        if name != "adam" and len(opt[name]):
            raise ValueError(f"/opt/{name}: want an empty state")
    adam = opt["adam"]
    if sorted(adam) != ["count", "m", "v"]:
        raise ValueError(f"/opt/adam: keys {sorted(adam)} != "
                         f"['count', 'm', 'v']")
    port_opt = {name: {} for name in names}
    port_opt["adam"] = {
        "m": params_from_numpy(adam["m"], cfg, device),
        "v": params_from_numpy(adam["v"], cfg, device),
        "count": _scalar(adam["count"], "/opt/adam/count", device)}
    return {"params": params_from_numpy(tree["params"], cfg, device),
            "opt": port_opt,
            "step": _scalar(tree["step"], "/step", device)}
