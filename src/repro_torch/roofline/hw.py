"""NVIDIA H100 SXM5 constants, the port's roofline targets (the
reference's ``repro/roofline/hw.py`` holds a TPU's).

Every figure is NVIDIA's data-sheet peak for the H100 SXM5 80 GB, not a
measurement: dense (no sparsity) tensor-core rates for bf16 and TF32, the
CUDA cores' fp32 rate, the HBM3 rate and size, and NVLink 4's rate each
way.  A card set below its 700 W limit runs slower under load.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores
PEAK_FLOPS_TF32 = 495e12  # FLOP/s, dense TF32 on the tensor cores
PEAK_FLOPS_FP32 = 67e12   # FLOP/s, fp32 on the CUDA cores
HBM_BW = 3.35e12          # bytes/s, HBM3
HBM_BYTES = 80e9          # bytes of HBM3
NVLINK_BW = 450e9         # bytes/s each way per GPU, NVLink 4 (18 links)


def peak_flops(dtype: str = "bf16") -> float:
    """The peak rate of one input type: "bf16", "tf32" or "fp32"."""
    return {"bf16": PEAK_FLOPS_BF16, "tf32": PEAK_FLOPS_TF32,
            "fp32": PEAK_FLOPS_FP32}[dtype]


# bytes on the wire per device by collective kind for a ring of size n
# (``hw.py:11-24``):
#   all-gather         : out_bytes * (n-1)/n
#   reduce-scatter     : in_bytes  * (n-1)/n
#   all-reduce         : 2 * bytes * (n-1)/n   (RS + AG)
#   all-to-all         : bytes * (n-1)/n
#   collective-permute : bytes
def wire_bytes(kind: str, result_bytes: int, group: int) -> float:
    if group <= 1:
        return 0.0
    f = (group - 1) / group
    if kind == "all-reduce":
        return 2.0 * result_bytes * f
    if kind == "collective-permute":
        return float(result_bytes)
    return result_bytes * f
