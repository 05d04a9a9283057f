"""Causal prefill attention: CUDA kernel and its plain version."""
from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    flash_attention_fwd, flash_attention_fwd_plain)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
