"""Parameters and train state between the JAX package's layout and the
port's, both ways.

The JAX model's parameters, taken to the host as a nested dict of numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``), become the port's
tree: the same keys, each stacked subtree the port keeps as a list
(``layers``; Zamba-2's ``mamba_layers``) unstacked along axis 0 into a
list of per-layer dicts, every shape checked against the port's
``ParamDef``s.
A train state ``{"params", "opt", "step"}`` maps the same way, the chain
state leaf for leaf: its subtrees shaped like the params (Adam's moments,
SM3's momentum) as the params, and the state the port already keeps in the
reference's stacked layout (SM3's accumulators, Shampoo's statistics) as
it is.  :func:`params_to_numpy` and
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
from repro_torch.models.layers import ParamDef
from repro_torch.optim.transforms import abstract_chain_state, build_optimizer


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


# chain-state subtrees shaped like the params (kept in the port's layout);
# every other chain-state leaf (counts, SM3's accumulators, Shampoo's
# statistics) is in the reference's layout on both sides
_PARAM_SHAPED = {("adam", "m"), ("adam", "v"), ("sm3", "m"),
                 ("shampoo", "adam", "m"), ("shampoo", "adam", "v")}


_NP = {torch.float32: np.float32, torch.int32: np.int32}


def _meta_params(defs: Any) -> Any:
    if isinstance(defs, ParamDef):
        return torch.empty(tuple(defs.shape), device="meta")
    if isinstance(defs, list):
        return [_meta_params(d) for d in defs]
    return {k: _meta_params(v) for k, v in sorted(defs.items())}


def _chain_template(cfg: ModelConfig, opt_cfg: OptimizerConfig) -> Any:
    """The port's chain state for ``opt_cfg`` as ``meta`` tensors."""
    return abstract_chain_state(build_optimizer(opt_cfg),
                                _meta_params(model_zoo.model_defs(cfg)))


def _opt_from_numpy(tmpl: Any, tree: Any, path: Tuple[str, ...],
                    cfg: ModelConfig, device: torch.device) -> Any:
    where = "/".join(("", "opt") + path)
    if path in _PARAM_SHAPED:
        return params_from_numpy(tree, cfg, device)
    if isinstance(tmpl, dict):
        if not isinstance(tree, dict) or sorted(tree) != sorted(tmpl):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{where}: keys {got} != port's {sorted(tmpl)}")
        return {k: _opt_from_numpy(tmpl[k], tree[k], path + (k,), cfg,
                                   device) for k in sorted(tmpl)}
    if isinstance(tmpl, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(tmpl):
            raise ValueError(f"{where}: want {len(tmpl)} entries")
        return tuple(_opt_from_numpy(t, x, path + (str(i),), cfg, device)
                     for i, (t, x) in enumerate(zip(tmpl, tree)))
    if tmpl is None:
        if tree is not None:
            raise ValueError(f"{where}: want None")
        return None
    arr = np.asarray(tree)
    if tuple(arr.shape) != tuple(tmpl.shape):
        raise ValueError(f"{where}: shape {arr.shape} != port's "
                         f"{tuple(tmpl.shape)}")
    return torch.as_tensor(np.array(arr, dtype=_NP[tmpl.dtype]),
                           device=device)



def train_state_from_numpy(tree: Any, cfg: ModelConfig,
                           opt_cfg: OptimizerConfig,
                           device: torch.device) -> Any:
    """The port's train state from the reference's, on the host
    (``jax.tree_util.tree_map(np.asarray, state)``): params as
    :func:`params_from_numpy`; the chain's state leaf for leaf, the
    subtrees shaped like the params (Adam's ``m`` and ``v``, SM3's
    momentum) unstacked as the params, the rest (counts, SM3's
    accumulators, Shampoo's statistics, ``None`` for an ineligible leaf)
    as they are; ``step`` int32."""
    opt = _opt_from_numpy(_chain_template(cfg, opt_cfg), tree["opt"],
                          (), cfg, device)
    step = np.asarray(tree["step"])
    if step.shape != ():
        raise ValueError(f"/step: shape {step.shape} != ()")
    return {"params": params_from_numpy(tree["params"], cfg, device),
            "opt": opt,
            "step": torch.tensor(int(step), dtype=torch.int32,
                                 device=device)}


# ---------------------------------------------------------------------------
# the way back: the port's tensors -> the JAX layout on the host
# ---------------------------------------------------------------------------

class LeafSpec(NamedTuple):
    """Shape and dtype of one leaf (the counterpart of
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: np.dtype


def _host(t: torch.Tensor) -> Any:
    """A tensor on the host as numpy, or a ``meta`` tensor as its
    :class:`LeafSpec`."""
    if t.device.type == "meta":
        return LeafSpec(tuple(t.shape),
                        np.dtype(str(t.dtype).replace("torch.", "")))
    return t.detach().cpu().numpy()


def _to_numpy(defs: Any, tree: Any, path: str) -> Any:
    if isinstance(defs, ParamDef):
        arr = _host(tree)
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
    if isinstance(layers[0], LeafSpec):
        return LeafSpec((len(layers),) + layers[0].shape, layers[0].dtype)
    return np.stack(layers)


def params_to_numpy(params: Any, cfg: ModelConfig) -> Any:
    """The JAX tree of the port's parameters: numpy arrays on the host
    (:class:`LeafSpec` s for ``meta`` tensors), ``layers`` /
    ``mamba_layers`` stacked along axis 0 (the inverse of
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


def _opt_to_numpy(tree: Any, path: Tuple[str, ...], cfg: ModelConfig) -> Any:
    if path in _PARAM_SHAPED:
        return params_to_numpy(tree, cfg)
    if isinstance(tree, dict):
        return {k: _opt_to_numpy(tree[k], path + (k,), cfg)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return tuple(_opt_to_numpy(t, path + (str(i),), cfg)
                     for i, t in enumerate(tree))
    return None if tree is None else _host(tree)


def train_state_to_numpy(state: Any, cfg: ModelConfig) -> Any:
    """The JAX tree of the port's train state (the inverse of
    :func:`train_state_from_numpy`): params and the chain's params-shaped
    subtrees as :func:`params_to_numpy`, the rest of the chain state as it
    is, ``step`` 0-dim int32.  A state of ``meta`` tensors gives the tree
    of :class:`LeafSpec` s."""
    return {"params": params_to_numpy(state["params"], cfg),
            "opt": _opt_to_numpy(state["opt"], (), cfg),
            "step": _host(state["step"])}


def abstract_train_state(cfg: ModelConfig,
                         opt_cfg: OptimizerConfig) -> Any:
    """The JAX tree of the train state's :class:`LeafSpec` s
    (``repro/launch/steps.py:174``), the ``like`` of a checkpoint
    restore."""
    params = _meta_params(model_zoo.model_defs(cfg))
    return train_state_to_numpy(
        {"params": params, "opt": _chain_template(cfg, opt_cfg),
         "step": torch.empty((), dtype=torch.int32, device="meta")}, cfg)
