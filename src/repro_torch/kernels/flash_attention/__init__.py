"""Causal flash attention, forward and backward: CUDA kernels, their plain
versions and the differentiable model-layout wrapper."""
from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    flash_attention_bwd, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_bwd_plain, flash_attention_bwd_preprocess,
    flash_attention_fwd, flash_attention_fwd_plain)
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    FlashAttention, flash_attention)
