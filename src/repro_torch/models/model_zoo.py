"""Uniform model API for the dense family (``repro/models/model_zoo.py:18-109``):
build, init, count, and the slot-cache specs of continuous batching."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import DenseLM, dense_defs


def model_defs(cfg: ModelConfig):
    if cfg.family != "dense":
        raise ValueError(f"the port has only the dense family, not "
                         f"{cfg.family!r}")
    return dense_defs(cfg)


def build_model(cfg: ModelConfig, block_kv: int = 512,
                remat: str = "full") -> DenseLM:
    """The model of ``cfg``; ``remat`` ("none" | "full") is the activation
    checkpointing of ``DenseLM.loss``."""
    model_defs(cfg)  # validates the family
    return DenseLM(cfg=cfg, block_kv=block_kv, remat=remat)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Any:
    """fp32 parameters drawn from ``generator`` (same distributions as the
    reference, not the same numbers: ``jax.random`` is not reproduced)."""
    return L.init_params(model_defs(cfg), generator, device)


def param_count(cfg: ModelConfig) -> int:
    return L.param_count(model_defs(cfg))


def decode_cache_axes(model: DenseLM) -> Dict[str, tuple]:
    """Axes of the slot cache: ``pos`` promoted to a per-slot vector, plus
    the per-slot ``active`` occupancy leaf."""
    axes = {k: ax if "batch" in ax else ("batch",) + ax
            for k, ax in model.cache_axes().items()}
    axes["active"] = ("batch",)
    return axes


def decode_cache_specs(model: DenseLM, n_slots: int, cache_len: int
                       ) -> Dict[str, Tuple[tuple, str]]:
    """(shape, kind) per slot-cache leaf; kind is "float", "int" or "bool"."""
    shapes = model.cache_shapes(n_slots, cache_len)
    return {"k": (shapes["k"], "float"), "v": (shapes["v"], "float"),
            "pos": ((n_slots,), "int"), "active": ((n_slots,), "bool")}


def init_decode_cache(model: DenseLM, n_slots: int, cache_len: int,
                      dtype: torch.dtype, device: torch.device
                      ) -> Dict[str, torch.Tensor]:
    """Zeroed slot cache (see ``decode_cache_specs``)."""
    kinds = {"float": dtype, "int": torch.int64, "bool": torch.bool}
    return {name: torch.zeros(shape, dtype=kinds[kind], device=device)
            for name, (shape, kind) in
            decode_cache_specs(model, n_slots, cache_len).items()}
