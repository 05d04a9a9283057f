"""Architecture registry of the port (``repro/configs/__init__.py``).

Every preset of the reference: the ten assigned architectures and the
paper's GPT-2 117M and 1.5B and GPT-3 125M replicas
(``configs/__init__.py:38-58``).  ``reduced`` is
``configs/__init__.py:68-91``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_moe_16b, gpt2,
                                 llava_next_mistral_7b, moonshot_v1_16b_a3b,
                                 musicgen_large, phi3_mini_3p8b, qwen2_1p5b,
                                 qwen3_32b, rwkv6_7b, smollm_360m,
                                 zamba2_2p7b)
from repro_torch.configs.base import (LM_SHAPES, ArchSpec,
                                     BatchWarmupConfig, GNSConfig,
                                     ModelConfig, OptimizerConfig,
                                     RegulatorSpec, ShapeConfig, SLWConfig,
                                     TrainConfig)

# the ten assigned architectures (the dry run's targets)
ASSIGNED: Dict[str, ArchSpec] = {
    "zamba2-2.7b": zamba2_2p7b.SPEC,
    "smollm-360m": smollm_360m.SPEC,
    "phi3-mini-3.8b": phi3_mini_3p8b.SPEC,
    "qwen3-32b": qwen3_32b.SPEC,
    "qwen2-1.5b": qwen2_1p5b.SPEC,
    "rwkv6-7b": rwkv6_7b.SPEC,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.SPEC,
    "deepseek-moe-16b": deepseek_moe_16b.SPEC,
    "musicgen-large": musicgen_large.SPEC,
    "llava-next-mistral-7b": llava_next_mistral_7b.SPEC,
}
# the paper's own models
PAPER: Dict[str, ArchSpec] = {
    "gpt2-117m": gpt2.SPEC_GPT2_117M,
    "gpt2-1.5b": gpt2.SPEC_GPT2_1P5B,
    "gpt3-125m": gpt2.SPEC_GPT3_125M,
}
SPECS: Dict[str, ArchSpec] = {**ASSIGNED, **PAPER}
ARCHS: Dict[str, ModelConfig] = {k: s.model for k, s in SPECS.items()}
FAMILIES = ("dense", "moe", "rwkv", "hybrid")


def get_arch_spec(name: str) -> ArchSpec:
    """The preset's model with its shape cells, source and notes."""
    if name not in SPECS:
        raise KeyError(f"unknown arch {name!r}; the port runs "
                       f"{sorted(SPECS)}")
    return SPECS[name]


def get_arch(name: str) -> ModelConfig:
    return get_arch_spec(name).model


def reduced(model: ModelConfig) -> ModelConfig:
    """Small same-family config for CPU tests (2 layers, d 64, vocab 512,
    a patch prefix of 8 for vision; moe: 4 experts, at most 1 shared,
    top-2; rwkv: 4 heads of 16, LoRA rank 8, chunk 16; hybrid: 4 layers
    with the shared block after every 2, SSD state 16, heads of 16, chunk
    32)."""
    if model.family not in FAMILIES:
        raise ValueError(f"the port has only the {', '.join(FAMILIES)} "
                         f"families, not {model.family!r}")
    kw = dict(
        name=model.name + "-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, 4 * model.n_kv_heads // max(model.n_heads, 1)),
        head_dim=16, d_ff=96, vocab_size=512, max_seq_len=256,
        prefix_tokens=8 if model.frontend == "vision_patches" else 0)
    if model.family == "moe":
        kw.update(n_experts=4, n_shared_experts=min(model.n_shared_experts, 1),
                  top_k=2)
    if model.family == "hybrid":
        kw.update(n_layers=4, attn_every=2, ssm_state=16, ssm_head_dim=16,
                  ssm_chunk=32)
    if model.family == "rwkv":
        kw.update(n_heads=4, n_kv_heads=4, rwkv_head_dim=16,
                  rwkv_lora_rank=8, rwkv_chunk=16)
    return model.replace(**kw)


__all__ = ["ARCHS", "ASSIGNED", "ArchSpec", "BatchWarmupConfig", "GNSConfig",
           "LM_SHAPES", "ModelConfig", "OptimizerConfig", "PAPER",
           "RegulatorSpec", "SLWConfig", "SPECS", "ShapeConfig",
           "TrainConfig", "get_arch", "get_arch_spec", "reduced"]
