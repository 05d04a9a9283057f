"""SLW pacing functions and the bucket ladder (``repro/core/pacing.py:29-97``).

The paper's pacing is step-wise linear,
``seqlen_t = seqlen_s + (seqlen_e - seqlen_s) * min(t / T, 1)``; also the
root variant, the Shortformer two-stage schedule and a constant one.  The
raw value is quantized down onto a bounded bucket ladder, so a run sees at
most ``max_buckets`` distinct lengths.  The serving scheduler quantizes
prompt lengths onto the same ladder.  Copied arithmetic, no ``repro``
import.
"""
from __future__ import annotations

import bisect
import math
from typing import List, Sequence, Tuple

from repro_torch.configs.base import SLWConfig


def raw_seqlen(cfg: SLWConfig, step: int, full_len: int,
               warmup_steps_hint: int = 0) -> float:
    """Un-quantized pacing value at ``step`` (``pacing.py:29-50``)."""
    s0 = cfg.start_seq_len
    s1 = cfg.end_seq_len or full_len
    t = cfg.duration_steps or max(2 * warmup_steps_hint, 1)
    if not cfg.enabled or cfg.pacing == "constant":
        return float(s1)
    if cfg.pacing in ("linear", "variance_gated"):
        # variance_gated: the curriculum owns the gate; this is its linear
        # upper envelope
        return s0 + (s1 - s0) * min(step / t, 1.0)
    if cfg.pacing == "root":
        return s0 + (s1 - s0) * min((step / t) ** (1.0 / cfg.root_degree), 1.0)
    if cfg.pacing == "two_stage":
        switch = cfg.two_stage_switch_step or t
        return float(cfg.two_stage_short_len if step < switch else s1)
    raise ValueError(f"unknown pacing {cfg.pacing!r}")


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


def seqlen_at(cfg: SLWConfig, step: int, full_len: int,
              warmup_steps_hint: int = 0,
              ladder: Sequence[int] = None) -> int:
    """The bucket the pacing function gives ``step``."""
    if ladder is None:
        ladder = bucket_ladder(cfg, full_len)
    return quantize(raw_seqlen(cfg, step, full_len, warmup_steps_hint), ladder)
