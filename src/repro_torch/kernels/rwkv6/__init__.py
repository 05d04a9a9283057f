"""Chunked WKV-6, forward and reverse chunk scan: CUDA kernels, their plain
versions and the differentiable wrapper."""
from repro_torch.kernels.rwkv6.kernel import (  # noqa: F401
    wkv6_bwd, wkv6_bwd_plain, wkv6_fwd, wkv6_fwd_plain)
from repro_torch.kernels.rwkv6.ops import WKV6, wkv6  # noqa: F401
