"""Architecture registry of the port (``repro/configs/__init__.py``).

Only the presets the port serves so far are registered: the dense GPT-2
117M and GPT-3 125M replicas.  ``reduced`` is ``configs/__init__.py:68-89``
for the dense family.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import gpt2
from repro_torch.configs.base import ModelConfig, SLWConfig

ARCHS: Dict[str, ModelConfig] = {
    "gpt2-117m": gpt2.GPT2_117M,
    "gpt3-125m": gpt2.GPT3_125M,
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]


def reduced(model: ModelConfig) -> ModelConfig:
    """Small same-family config for CPU tests (2 layers, d 64, vocab 512)."""
    if model.family != "dense":
        raise ValueError(f"the port has only the dense family, not "
                         f"{model.family!r}")
    return model.replace(
        name=model.name + "-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, 4 * model.n_kv_heads // max(model.n_heads, 1)),
        head_dim=16, d_ff=96, vocab_size=512, max_seq_len=256)


__all__ = ["ARCHS", "ModelConfig", "SLWConfig", "get_arch", "reduced"]
