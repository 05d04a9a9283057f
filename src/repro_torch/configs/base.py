"""Config dataclasses of the serving slice.

Answers to ``repro/configs/base.py``: ``ModelConfig`` (lines 15-113) and
the ``SLWConfig`` fields the bucket ladder reads (line 133).  The fields
are copied, not imported, so this package never imports ``repro``.  Only
the fields the dense family reads are kept; the other families' fields
come with their slices.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture definition (``repro/configs/base.py:15``)."""

    name: str
    family: str  # dense | moe | rwkv | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    # prefill attention: "blockwise" (plain torch) | "flash" (the CUDA
    # kernel on CUDA tensors, its plain version on CPU tensors)
    attn_backend: str = "blockwise"
    # single-token decode attention: "reference" (plain torch) | "kernel"
    # (the CUDA split-KV kernel on CUDA tensors, plain on CPU tensors)
    decode_backend: str = "reference"
    pos_emb: str = "rope"  # rope | learned | none
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp: str = "swiglu"  # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 532480

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SLWConfig:
    """The fields of ``repro/configs/base.py:133`` that
    ``core.pacing.bucket_ladder`` reads."""

    enabled: bool = True
    start_seq_len: int = 8
    end_seq_len: int = 0  # 0 -> full length
    round_multiple: int = 8
    max_buckets: int = 32
