"""Config dataclasses of the port.

Answers to ``repro/configs/base.py``: ``ModelConfig`` (lines 15-113), and
``SLWConfig``, ``BatchWarmupConfig``, ``RegulatorSpec``,
``OptimizerConfig`` and ``TrainConfig`` (lines 133-331).  The fields are
copied, not imported, so this package never imports ``repro``.
``ModelConfig`` keeps the fields the dense, rwkv and hybrid families
read; ``TrainConfig`` leaves out ``gns`` and the fields only GNS,
sharding and checkpoint cadence read, which come with their slices.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


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
    rope_theta: float = 10000.0
    # SSM, Mamba-2 / SSD (``base.py:63-73``); SSD train/prefill backend:
    # "reference" (plain torch) | "kernel" (the CUDA kernels on CUDA
    # tensors, their plain versions on CPU tensors)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    conv_kernel: int = 4
    ssm_backend: str = "reference"
    # hybrid (zamba2, ``base.py:74-76``): one shared attention + MLP block
    # applied after every ``attn_every`` SSM layers
    attn_every: int = 0
    # rwkv6 (``base.py:79-85``); WKV train/prefill backend: "reference"
    # (plain torch) | "kernel" (the CUDA kernels on CUDA tensors, their
    # plain versions on CPU tensors)
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 64
    rwkv_chunk: int = 64
    rwkv_backend: str = "reference"
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
    """Sequence Length Warmup, the paper's contribution (``base.py:133``)."""

    enabled: bool = True
    # linear (paper default) | root | two_stage | variance_gated | constant
    pacing: str = "linear"
    start_seq_len: int = 8  # seqlen_s
    end_seq_len: int = 0  # seqlen_e; 0 -> full shape seq_len
    duration_steps: int = 0  # T; 0 -> 2x LR warmup steps
    root_degree: float = 2.0
    round_multiple: int = 8
    max_buckets: int = 32
    # truncate: paper-faithful; repack: (B, S) -> (B*S//s_t, s_t)
    mode: str = "truncate"
    two_stage_short_len: int = 128
    two_stage_switch_step: int = 0  # 0 -> duration_steps
    # variance_gated: advance only while var_max < gate * trailing
    variance_gate: float = 2.0


@dataclass(frozen=True)
class BatchWarmupConfig:
    """GPT-3 style batch-size warmup (``base.py:168``)."""

    enabled: bool = False
    start_batch: int = 16
    warmup_tokens: int = 4_000_000_000


@dataclass(frozen=True)
class RegulatorSpec:
    """One entry of ``TrainConfig.regulators`` (``base.py:177``).  The port
    builds the kinds ``seqlen``, ``batch_warmup`` and ``lr``, which read
    their parameters from the configs above; the other kinds, and the
    fields that parametrize them, come with their slices
    (``core.regulators.build_stack`` refuses them)."""

    kind: str


@dataclass(frozen=True)
class OptimizerConfig:
    """``base.py:265``.  The port's ``optim.transforms.build_optimizer``
    builds the default chain and refuses the options not ported yet
    (``optimizer``, ``agc_clip``, ``lr_scales``, ``telemetry_level``).  The
    tuning fields of SM3, Shampoo and AGC come with those transforms; the
    reference's ``grad_compression`` fields, which nothing reads, are left
    out."""

    lr: float = 6e-4
    min_lr: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    optimizer: str = "adamw"  # adamw | sm3 | shampoo
    decay_mask: str = "all"  # all | std
    agc_clip: float = 0.0
    lr_scales: Tuple[Tuple[str, float], ...] = ()
    telemetry_level: str = "scalar"  # scalar | per_leaf
    schedule: str = "token_cosine"  # token_cosine | step_cosine | constant
    warmup_steps: int = 0
    warmup_tokens: int = 0
    total_steps: int = 0
    total_tokens: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """``base.py:313``, without ``gns``, ``sharding_rules``,
    ``cast_params_before_use``, ``checkpoint_interval``,
    ``keep_checkpoints`` and the unread ``log_interval``.
    ``checkpoint_dir`` stays so that a non-empty one is refused rather
    than ignored."""

    model: ModelConfig
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    slw: SLWConfig = field(default_factory=SLWConfig)
    batch_warmup: BatchWarmupConfig = field(default_factory=BatchWarmupConfig)
    # empty = derive from the legacy configs (core.regulators.auto_specs)
    regulators: Tuple[RegulatorSpec, ...] = ()
    seq_len: int = 1024
    global_batch: int = 512
    seed: int = 1234
    remat: str = "full"  # none | full | dots
    eval_interval: int = 100
    checkpoint_dir: str = ""
