"""Data-sheet peaks of one NVIDIA H100 SXM5 80 GB, the denominators of every
share the benchmark reports.  A frozen copy of
``src/repro_torch/roofline/hw.py:11-15``: dense rates, no sparsity, at the
card's full 700 W power limit (a card set lower runs slower under load).

The shares use the TF32 tensor-core rate: it is the fastest unit on which a
product accurate to fp32 runs (as three TF32 products), so no fp32 kernel
can pass it.
"""
PEAK_FLOPS_TF32 = 495e12  # FLOP/s, dense TF32 on the tensor cores
HBM_BW = 3.35e12          # bytes/s, HBM3


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the TF32 rate and the bytes at the HBM rate."""
    return max(flops / PEAK_FLOPS_TF32, nbytes / HBM_BW)
