"""Parameters and train state between the JAX package's layout and the
port's, both ways.

The JAX model's parameters, taken to the host as a nested dict of numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``), become the port's
tree: the same keys, each stacked subtree the port keeps as a list
(``layers``; Zamba-2's ``mamba_layers``) unstacked along axis 0 into a
list of per-layer dicts, every shape checked against the port's
``ParamDef``s.
A train state ``{"params", "opt", "step"}`` maps the same way, the chain
state leaf for leaf.  :func:`params_to_numpy` and
:func:`train_state_to_numpy` are the way back: the port's tensors as the
JAX layout's nested dict of numpy arrays, the per-layer lists stacked
along axis 0 again, which is what ``repro_torch.checkpoint`` writes.
Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

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


# ---------------------------------------------------------------------------
# the way back: the port's tensors -> the JAX layout on the host
# ---------------------------------------------------------------------------

def _to_numpy(defs: Any, tree: Any, path: str) -> Any:
    if isinstance(defs, ParamDef):
        arr = tree.detach().cpu().numpy()
        if tuple(arr.shape) != tuple(defs.shape):
            raise ValueError(f"{path}: shape {arr.shape} != "
                             f"{defs.shape}")
        return arr
    if not isinstance(tree, dict) or sorted(tree) != sorted(defs):
        raise ValueError(f"{path}: keys != {sorted(defs)}")
    return {k: _to_numpy(defs[k], tree[k], f"{path}/{k}")
            for k in sorted(defs)}


def _stack(layers: list) -> Any:
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack(layers)


def params_to_numpy(params: Any, cfg: ModelConfig) -> Any:
    """The JAX tree of the port's parameters: numpy arrays on the host,
    ``layers`` / ``mamba_layers`` stacked along axis 0 (the inverse of
    :func:`params_from_numpy`)."""
    defs = model_zoo.model_defs(cfg)
    stacked = [k for k, v in defs.items() if isinstance(v, list)]
    out = _to_numpy({k: v for k, v in defs.items() if k not in stacked},
                    {k: v for k, v in params.items() if k not in stacked}, "")
    for key in stacked:
        if len(params[key]) != len(defs[key]):
            raise ValueError(f"/{key}: {len(params[key])} layers != "
                             f"{len(defs[key])}")
        out[key] = _stack([_to_numpy(layer_defs, layer, f"/{key}/{i}")
                           for i, (layer_defs, layer) in enumerate(
                               zip(defs[key], params[key]))])
    return out


def _scalar_to_numpy(x: torch.Tensor) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy(), dtype=np.int32)


def train_state_to_numpy(state: Any, cfg: ModelConfig) -> Any:
    """The JAX tree of the port's train state (the inverse of
    :func:`train_state_from_numpy`): params, ``opt.adam.m`` and
    ``opt.adam.v`` as :func:`params_to_numpy`, ``opt.adam.count`` and
    ``step`` 0-dim int32, the stateless transforms' empty dicts."""
    opt = {}
    for name, sub in state["opt"].items():
        if name == "adam":
            opt[name] = {"m": params_to_numpy(sub["m"], cfg),
                         "v": params_to_numpy(sub["v"], cfg),
                         "count": _scalar_to_numpy(sub["count"])}
        elif len(sub):
            raise ValueError(f"/opt/{name}: want an empty state")
        else:
            opt[name] = {}
    return {"params": params_to_numpy(state["params"], cfg), "opt": opt,
            "step": _scalar_to_numpy(state["step"])}


class LeafSpec(NamedTuple):
    """Shape and dtype of one leaf (the counterpart of
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: np.dtype


def abstract_train_state(cfg: ModelConfig,
                         opt_cfg: OptimizerConfig) -> Any:
    """The JAX tree of the train state's :class:`LeafSpec` s
    (``repro/launch/steps.py:174``), the ``like`` of a checkpoint
    restore."""
    def spec(defs: Any, n: int = 0) -> Any:
        if isinstance(defs, ParamDef):
            shape = (n,) + tuple(defs.shape) if n else tuple(defs.shape)
            return LeafSpec(shape, np.dtype(np.float32))
        return {k: spec(v, n) for k, v in sorted(defs.items())}
    params = {k: spec(v[0], len(v)) if isinstance(v, list) else spec(v)
              for k, v in sorted(model_zoo.model_defs(cfg).items())}
    count = LeafSpec((), np.dtype(np.int32))
    opt = {name: {} for name in build_optimizer(opt_cfg).init(
        {"w": torch.zeros(1)})}
    opt["adam"] = {"m": params, "v": params, "count": count}
    return {"params": params, "opt": opt, "step": count}
