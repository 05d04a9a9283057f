"""Uniform model API (``repro/models/model_zoo.py:18-173``): build, init,
count, the params' logical axes and meta-device shapes, the slot-cache
specs of continuous batching, and the batch layouts and their logical axes
(the dry run's contract), for the dense, moe, rwkv and hybrid (Zamba-2)
families."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import MoELM, moe_defs
from repro_torch.models.rwkv6 import RWKV6LM, rwkv6_defs
from repro_torch.models.transformer import DenseLM, dense_defs
from repro_torch.models.zamba2 import Zamba2LM, zamba2_defs

FAMILIES = {"dense": (DenseLM, dense_defs), "moe": (MoELM, moe_defs),
            "rwkv": (RWKV6LM, rwkv6_defs), "hybrid": (Zamba2LM, zamba2_defs)}


def _family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"the port has only the {sorted(FAMILIES)} "
                         f"families, not {cfg.family!r}")
    return FAMILIES[cfg.family]


def model_defs(cfg: ModelConfig):
    return _family(cfg)[1](cfg)


def build_model(cfg: ModelConfig, remat: str = "full", **options):
    """The model of ``cfg``; ``remat`` ("none" | "full" | "dots") is the
    activation checkpointing of its ``loss``; ``options`` go to the
    family's class (``block_kv``, the blockwise-attention block of the
    dense and hybrid families)."""
    return _family(cfg)[0](cfg=cfg, remat=remat, **options)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Any:
    """fp32 parameters drawn from ``generator`` (same distributions as the
    reference, not the same numbers: ``jax.random`` is not reproduced)."""
    return L.init_params(model_defs(cfg), generator, device)


def abstract_params(cfg: ModelConfig) -> Any:
    """fp32 ``meta`` tensors of the params' shapes (``model_zoo.py:45``)."""
    return L.abstract_params(model_defs(cfg))


def param_axes(cfg: ModelConfig) -> Any:
    """The params' logical axes (``model_zoo.py:49``), per-layer lists where
    the reference stacks."""
    return L.logical_axes(model_defs(cfg))


def param_count(cfg: ModelConfig) -> int:
    return L.param_count(model_defs(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """Per-token active parameters (``model_zoo.py:53-60``): a MoE's routed
    experts count ``top_k / n_experts`` of theirs."""
    total = param_count(cfg)
    if cfg.family != "moe":
        return total
    e, k = cfg.n_experts, cfg.top_k
    routed = 3 * cfg.n_layers * cfg.d_model * cfg.d_ff * e
    return total - routed + routed * k // e


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


def train_batch_specs(cfg: ModelConfig, batch: int, seq_len: int
                      ) -> Dict[str, Tuple[tuple, str]]:
    """(shape, kind) of each training batch leaf (``model_zoo.py:116-137``);
    kind "int" (token ids) or "float" (frontend embeddings, the model's
    dtype).  ``audio_frames``: frames (B, S, d) and labels;
    ``vision_patches``: a (B, P, d) patch prefix and S - P text tokens."""
    if cfg.frontend == "audio_frames":
        return {"frames": ((batch, seq_len, cfg.d_model), "float"),
                "labels": ((batch, seq_len), "int")}
    if cfg.frontend == "vision_patches":
        p = cfg.prefix_tokens
        return {"patch_embeds": ((batch, p, cfg.d_model), "float"),
                "tokens": ((batch, seq_len - p), "int"),
                "labels": ((batch, seq_len - p), "int")}
    return {"tokens": ((batch, seq_len), "int"),
            "labels": ((batch, seq_len), "int")}


def batch_logical_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical axes of the batch leaves (``model_zoo.py:138-146``);
    ``tokens`` is there for the audio decode path too."""
    if cfg.frontend == "audio_frames":
        return {"frames": ("batch", "seq", "embed"),
                "tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.frontend == "vision_patches":
        return {"patch_embeds": ("batch", None, "embed"),
                "tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    return {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}


def prefill_batch_specs(cfg: ModelConfig, batch: int, seq_len: int
                        ) -> Dict[str, Tuple[tuple, str]]:
    """:func:`train_batch_specs` without the labels (``model_zoo.py:149``)."""
    specs = train_batch_specs(cfg, batch, seq_len)
    specs.pop("labels")
    return specs


def decode_token_specs(batch: int) -> Tuple[tuple, str]:
    """One decode step's tokens (``model_zoo.py:156``)."""
    return ((batch, 1), "int")


def make_train_batch(seed: int, cfg: ModelConfig, batch: int, seq_len: int
                     ) -> Dict[str, np.ndarray]:
    """A random host batch of :func:`train_batch_specs`' layout
    (``model_zoo.py:160-173``, drawn from a numpy seed instead of a jax
    key): token ids uniform in the vocab (int32), embeddings 0.02 x a
    standard normal (float32)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, kind) in train_batch_specs(cfg, batch, seq_len).items():
        if kind == "int":
            out[name] = rng.integers(0, cfg.vocab_size, shape,
                                     dtype=np.int32)
        else:
            out[name] = (0.02 * rng.standard_normal(shape)).astype(np.float32)
    return out
