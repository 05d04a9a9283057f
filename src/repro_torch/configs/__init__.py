"""Architecture registry of the port (``repro/configs/__init__.py``).

Only the presets the port runs so far are registered: the dense GPT-2
117M and GPT-3 125M replicas, rwkv6-7b and the hybrid zamba2-2.7b.
``reduced`` is ``configs/__init__.py:68-90`` for the dense, rwkv and
hybrid families.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import gpt2, rwkv6_7b, zamba2_2p7b
from repro_torch.configs.base import (BatchWarmupConfig, GNSConfig,
                                     ModelConfig, OptimizerConfig,
                                     RegulatorSpec, SLWConfig, TrainConfig)

ARCHS: Dict[str, ModelConfig] = {
    "gpt2-117m": gpt2.GPT2_117M,
    "gpt3-125m": gpt2.GPT3_125M,
    "rwkv6-7b": rwkv6_7b.RWKV6_7B,
    "zamba2-2.7b": zamba2_2p7b.ZAMBA2_2P7B,
}
FAMILIES = ("dense", "rwkv", "hybrid")


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port runs "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]


def reduced(model: ModelConfig) -> ModelConfig:
    """Small same-family config for CPU tests (2 layers, d 64, vocab 512;
    rwkv: 4 heads of 16, LoRA rank 8, chunk 16; hybrid: 4 layers with the
    shared block after every 2, SSD state 16, heads of 16, chunk 32)."""
    if model.family not in FAMILIES:
        raise ValueError(f"the port has only the {', '.join(FAMILIES)} "
                         f"families, not {model.family!r}")
    kw = dict(
        name=model.name + "-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, 4 * model.n_kv_heads // max(model.n_heads, 1)),
        head_dim=16, d_ff=96, vocab_size=512, max_seq_len=256)
    if model.family == "hybrid":
        kw.update(n_layers=4, attn_every=2, ssm_state=16, ssm_head_dim=16,
                  ssm_chunk=32)
    if model.family == "rwkv":
        kw.update(n_heads=4, n_kv_heads=4, rwkv_head_dim=16,
                  rwkv_lora_rank=8, rwkv_chunk=16)
    return model.replace(**kw)


__all__ = ["ARCHS", "BatchWarmupConfig", "GNSConfig", "ModelConfig",
           "OptimizerConfig", "RegulatorSpec", "SLWConfig", "TrainConfig",
           "get_arch", "reduced"]
