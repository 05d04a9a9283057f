"""Config dataclasses of the port.

Answers to ``repro/configs/base.py``: ``ModelConfig`` (lines 15-113), and
``SLWConfig``, ``BatchWarmupConfig``, ``RegulatorSpec``,
``OptimizerConfig`` and ``TrainConfig`` (lines 133-331).  The fields are
copied, not imported, so this package never imports ``repro``.
``GNSConfig`` is lines 209-253; ``ShapeConfig``, ``LM_SHAPES`` and
``ArchSpec`` (the dry run's cells) are lines 113-129 and 334-356.
``ModelConfig`` and ``OptimizerConfig`` have every field of the
reference's; ``TrainConfig`` leaves out ``sharding_rules`` and
``cast_params_before_use`` (the sharded step takes its rules as an
argument, and the port runs fp32).
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
    # MoE (``base.py:52-62``): shared + routed experts, top-k token choice
    # into a capacity buffer; dispatch "global" (one buffer over all
    # tokens) | "row_local" (ranking and capacity per batch row)
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "row_local"
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
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
    # modality frontend stubs (``base.py:86-91``): "none" (token LM) |
    # "audio_frames" (precomputed frame embeddings (B, S, d) replace the
    # token embedding) | "vision_patches" (precomputed patch embeddings
    # (B, P, d) prepended to it; ``prefix_tokens`` = P)
    frontend: str = "none"
    prefix_tokens: int = 0
    max_seq_len: int = 532480
    logits_softcap: float = 0.0  # read by no model, as in the reference

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        """``base.py:100-102``."""
        return self.family == "rwkv"

    @property
    def sub_quadratic(self) -> bool:
        """Whether the arch decodes at 500K context (SSM, hybrid, linear)."""
        return self.family in ("rwkv", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the dry run; ``kind`` selects the step."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


# the assigned LM shape set, the same for the ten architectures
LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)


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
    """One entry of ``TrainConfig.regulators`` (``base.py:177``).  The
    kinds ``seqlen``, ``batch_warmup`` and ``lr`` read their parameters
    from the configs above, ``critical_batch`` from ``TrainConfig.gns``;
    ``grad_noise_batch`` and ``var_lr_throttle`` are parametrized here
    (``base.py:198-206``)."""

    kind: str
    # grad_noise_batch
    min_batch: int = 0  # 0 -> full_batch // 8
    noise_window: int = 16  # EMA horizon (steps) for grad-norm stats
    noise_target: float = 0.25  # grow batch while rel. grad-norm std exceeds
    growth: float = 1.5  # multiplicative batch growth per trigger
    # var_lr_throttle
    gate: float = 2.0  # throttle when var_max > gate * trailing mean
    floor: float = 0.1  # never scale LR below floor * scheduled
    backoff: float = 0.5  # scale *= backoff on a spike
    recovery: float = 1.2  # scale *= recovery per calm step (capped at 1)


@dataclass(frozen=True)
class GNSConfig:
    """Gradient-noise-scale measurement and the pre-spike precursor
    (``base.py:210``).  ``enabled`` views the batch as ``shards`` emulated
    data-parallel replicas inside the train step; their per-shard and
    full-batch gradient norms feed the unbiased ``B_noise`` estimate.  The
    precursor fields parametrize the random-sign direction sketches and
    their lagged autocorrelation; the critical-batch fields drive the
    ``critical_batch`` regulator kind."""

    enabled: bool = False
    # realized shard count: the largest divisor of the step's rows <= this
    shards: int = 4
    ema_window: int = 32  # EMA horizon (steps) of |G|^2 and tr(Sigma)
    warmup_obs: int = 8  # observations before B_noise counts as warmed up
    # critical_batch regulator
    min_batch: int = 0  # 0 -> full_batch // 8
    headroom: float = 2.0  # grow the batch while B_noise > headroom * batch
    growth: float = 1.5  # multiplicative batch growth per trigger
    # pre-spike precursor
    precursor_window: int = 12  # sketch ring length (0 disables sketches)
    precursor_dim: int = 16  # sketch dimension
    precursor_lags: int = 3  # autocorrelation lags averaged per leaf
    precursor_gate: float = 0.8  # absolute per-leaf correlation gate
    precursor_rise: float = 0.25  # ... and score - trailing > rise
    precursor_grace: int = 6  # score observations before firing is legal
    precursor_cooldown_steps: int = 8  # LR cool-down window on an event
    precursor_cooldown_factor: float = 0.5  # LR multiplier in the cool-down
    sketch_seed: int = 17  # seed of the per-leaf signs


@dataclass(frozen=True)
class OptimizerConfig:
    """``base.py:256``."""

    lr: float = 6e-4
    min_lr: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    optimizer: str = "adamw"  # adamw | sm3 | shampoo
    decay_mask: str = "all"  # all | std
    # adaptive gradient clipping: per-leaf grad/param-norm ratio clip
    agc_clip: float = 0.0
    agc_eps: float = 1e-3
    # ((label substring, factor), ...): factors multiply the update of
    # every leaf whose reference label matches
    lr_scales: Tuple[Tuple[str, float], ...] = ()
    telemetry_level: str = "scalar"  # scalar | per_leaf
    sm3_momentum: float = 0.9  # heavy-ball momentum of SM3 (0 disables)
    # shampoo: largest block side preconditioned, eigh refresh cadence,
    # and the statistics' ridge
    shampoo_block_size: int = 128
    shampoo_interval: int = 10
    shampoo_eps: float = 1e-6
    schedule: str = "token_cosine"  # token_cosine | step_cosine | constant
    warmup_steps: int = 0
    warmup_tokens: int = 0
    total_steps: int = 0
    total_tokens: int = 0
    # 1-bit-Adam style compressed gradient all-reduce: the reference's
    # fields, which no train step of either package reads; the port's
    # ``make_train_step`` refuses ``grad_compression=True`` rather than
    # run the exact sync under it (``optim.compression`` has the sync)
    grad_compression: bool = False
    compression_warmup_steps: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """``base.py:303``, without ``sharding_rules``,
    ``cast_params_before_use`` and the unread ``log_interval``."""

    model: ModelConfig
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    slw: SLWConfig = field(default_factory=SLWConfig)
    batch_warmup: BatchWarmupConfig = field(default_factory=BatchWarmupConfig)
    # empty = derive from the legacy configs (core.regulators.auto_specs)
    regulators: Tuple[RegulatorSpec, ...] = ()
    gns: GNSConfig = field(default_factory=GNSConfig)
    seq_len: int = 1024
    global_batch: int = 512
    seed: int = 1234
    remat: str = "full"  # none | full | dots
    eval_interval: int = 100
    checkpoint_interval: int = 500
    checkpoint_dir: str = ""
    keep_checkpoints: int = 3


@dataclass(frozen=True)
class ArchSpec:
    """An architecture with its shape cells and dry-run notes
    (``base.py:334-356``)."""

    model: ModelConfig
    shapes: Tuple[ShapeConfig, ...] = LM_SHAPES
    source: str = ""
    notes: str = ""

    def shape(self, name: str) -> ShapeConfig:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.model.name} has no shape {name!r}")

    def runnable_shapes(self) -> Tuple[ShapeConfig, ...]:
        """The cells a dry run lowers: long_500k only for sub-quadratic
        archs."""
        return tuple(s for s in self.shapes
                     if s.name != "long_500k" or self.model.sub_quadratic)
