"""Bucket ladder and round-down quantization (``repro/core/pacing.py:52-91``).

The serving scheduler quantizes prompt lengths onto the same ladder the
SLW curriculum uses, so the set of prefill shapes stays bounded.  Copied
arithmetic, no ``repro`` import.
"""
from __future__ import annotations

import bisect
import math
from typing import List, Sequence, Tuple

from repro_torch.configs.base import SLWConfig


def bucket_ladder(cfg: SLWConfig, full_len: int) -> Tuple[int, ...]:
    """Monotone ladder of allowed sequence lengths, |ladder| <= max_buckets."""
    s0 = cfg.start_seq_len
    s1 = cfg.end_seq_len or full_len
    m = cfg.round_multiple
    if not cfg.enabled:
        return (s1,)
    ladder: List[int] = []
    v = s0  # geometric sub-multiple region
    while v < min(m, s1):
        ladder.append(v)
        v *= 2
    lo = max(m, s0 - s0 % m or m)  # arithmetic multiples of m
    n_arith = max(1, (s1 - lo) // m + 1)
    budget = max(1, cfg.max_buckets - len(ladder))
    stride = max(1, math.ceil(n_arith / budget))
    v = lo
    while v < s1:
        ladder.append(v)
        v += stride * m
    ladder.append(s1)
    # smallest admissible bucket: s0 below the multiple, else s0 rounded
    # down to it (the arithmetic anchor)
    floor = s0 if s0 < m else s0 - s0 % m
    return tuple(sorted(set(x for x in ladder if floor <= x <= s1)))


def quantize(raw: float, ladder: Sequence[int]) -> int:
    """Largest ladder value <= raw; clamps to the smallest bucket."""
    i = bisect.bisect_right(ladder, raw) - 1
    return ladder[max(i, 0)]
