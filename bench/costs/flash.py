"""Operations and bytes of one launch of each flash-attention kernel, from
its shape: q, k, v (BH, S, D) in the element size ``es``, lse and delta (BH,
S) fp32.  Each input byte is read once and each output byte written once.

Operations are those the algorithm needs, 2 FLOPs a multiply-add over the
causal pairs S (S + 1) / 2 of each head: the forward's two products, the
dQ kernel's three (S, dP, dQ), the dK/dV kernel's four (S, dP, dV, dK), the
preprocess's row dot.  A frozen copy of the counts in
``src/repro_torch/kernels/flash_attention/kernel.py:116, 208, 230, 254``.
"""
from __future__ import annotations

from typing import Tuple

# substrings of the kernels' names in the device trace
KERNELS = {"flash_fwd_kernel": "fwd", "bwd_preprocess_kernel": "preprocess",
           "bwd_dq_kernel": "dq", "bwd_dkv_kernel": "dkv"}


def kind_of(kernel_name: str) -> str:
    """"fwd" | "preprocess" | "dq" | "dkv", or "" for another kernel."""
    for key, kind in KERNELS.items():
        if key in kernel_name:
            return kind
    return ""


def cost(kind: str, bh: int, s: int, d: int, es: int = 4
         ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one causal launch."""
    pairs = s * (s + 1) / 2
    t = bh * s * d * es  # one (BH, S, D) tensor
    row = bh * s * 4     # one (BH, S) fp32 vector
    if kind == "fwd":
        return 4.0 * bh * pairs * d, 3 * t + t + row
    if kind == "preprocess":
        return 2.0 * bh * s * d, 2 * t + row
    if kind == "dq":
        return 6.0 * bh * pairs * d, 4 * t + 2 * row + t
    if kind == "dkv":
        return 8.0 * bh * pairs * d, 4 * t + 2 * row + 2 * t
    raise ValueError(f"unknown flash kernel kind {kind!r}")
