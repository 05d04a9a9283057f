"""Mamba-2 chunked SSD scan, forward and reverse chunk scan: CUDA kernels,
their plain versions and the differentiable wrapper."""
from repro_torch.kernels.ssd.kernel import (  # noqa: F401
    ssd_bwd, ssd_bwd_plain, ssd_fwd, ssd_fwd_plain)
from repro_torch.kernels.ssd.ops import SSD, ssd  # noqa: F401
