"""Parameters of the JAX package -> parameters of the port.

The JAX model's parameters, taken to the host as a nested dict of numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``), become the port's
tree: the same keys, ``layers/*`` unstacked along axis 0 into a list of
per-layer dicts, every shape checked against the port's ``ParamDef``s.
Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_zoo
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
    top = {k: v for k, v in defs.items() if k != "layers"}
    out = _convert(top, {k: v for k, v in tree.items() if k != "layers"}, "",
                   device)
    stacked = tree["layers"]
    out["layers"] = [_convert(layer_defs, _unstack(stacked, i), f"/layers/{i}",
                              device)
                     for i, layer_defs in enumerate(defs["layers"])]
    return out
