"""Uniform model API (``repro/models/model_zoo.py:18-109``): build, init,
count, and the slot-cache specs of continuous batching, for the dense,
rwkv and hybrid (Zamba-2) families."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.rwkv6 import RWKV6LM, rwkv6_defs
from repro_torch.models.transformer import DenseLM, dense_defs
from repro_torch.models.zamba2 import Zamba2LM, zamba2_defs

FAMILIES = {"dense": (DenseLM, dense_defs), "rwkv": (RWKV6LM, rwkv6_defs),
            "hybrid": (Zamba2LM, zamba2_defs)}


def _family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"the port has only the {sorted(FAMILIES)} "
                         f"families, not {cfg.family!r}")
    return FAMILIES[cfg.family]


def model_defs(cfg: ModelConfig):
    return _family(cfg)[1](cfg)


def build_model(cfg: ModelConfig, remat: str = "full", **options):
    """The model of ``cfg``; ``remat`` ("none" | "full") is the activation
    checkpointing of its ``loss``; ``options`` go to the family's class
    (``block_kv``, the blockwise-attention block of the dense and hybrid
    families)."""
    return _family(cfg)[0](cfg=cfg, remat=remat, **options)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Any:
    """fp32 parameters drawn from ``generator`` (same distributions as the
    reference, not the same numbers: ``jax.random`` is not reproduced)."""
    return L.init_params(model_defs(cfg), generator, device)


def param_count(cfg: ModelConfig) -> int:
    return L.param_count(model_defs(cfg))


def decode_cache_axes(model) -> Dict[str, tuple]:
    """Axes of the slot cache: bookkeeping leaves without a "batch" axis
    (``pos``) promoted to per-slot vectors, plus the per-slot ``active``
    occupancy leaf."""
    axes = {k: ax if "batch" in ax else ("batch",) + ax
            for k, ax in model.cache_axes().items()}
    axes["active"] = ("batch",)
    return axes


def decode_cache_specs(model, n_slots: int, cache_len: int
                       ) -> Dict[str, Tuple[tuple, str]]:
    """(shape, kind) per slot-cache leaf, from the model's ``cache_shapes``
    and ``cache_axes``; kind is "float" (the model's dtype), "fp32", "int"
    or "bool"."""
    axes = model.cache_axes()
    specs = {name: (shape if "batch" in axes[name] else (n_slots,) + shape,
                    kind)
             for name, (shape, kind) in
             model.cache_shapes(n_slots, cache_len).items()}
    specs["active"] = ((n_slots,), "bool")
    return specs


def init_decode_cache(model, n_slots: int, cache_len: int,
                      dtype: torch.dtype, device: torch.device
                      ) -> Dict[str, torch.Tensor]:
    """Zeroed slot cache (see ``decode_cache_specs``)."""
    kinds = L.cache_dtypes(dtype)
    return {name: torch.zeros(shape, dtype=kinds[kind], device=device)
            for name, (shape, kind) in
            decode_cache_specs(model, n_slots, cache_len).items()}
