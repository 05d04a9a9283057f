"""The control plane's plan of a step, worked out again: the sequence length
of the linear sequence-length warmup (quantised onto its bucket ladder) and
the token-wise cosine learning rate with linear warmup.

A frozen copy of the program's arithmetic at the time the benchmark was
written, so that a later change to the program cannot move it:
``src/repro_torch/core/pacing.py:23-79`` (``raw_seqlen``, linear pacing
only; ``bucket_ladder``; ``quantize``) and
``src/repro_torch/optim/schedule.py:12-32`` (``lr_at``, ``token_cosine``
and ``constant``).  Pure Python.
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, List, Tuple


def bucket_ladder(slw: Dict, full_len: int) -> Tuple[int, ...]:
    """The allowed lengths: below the round multiple a doubling run from
    the start, then multiples of it at a stride that keeps the ladder to
    ``max_buckets`` entries, then the full length."""
    s0 = slw["start_seq_len"]
    s1 = slw.get("end_seq_len") or full_len
    mult = slw.get("round_multiple", 8)
    if not slw.get("enabled", True):
        return (s1,)
    ladder: List[int] = []
    v = s0
    while v < min(mult, s1):
        ladder.append(v)
        v *= 2
    lo = max(mult, s0 - s0 % mult or mult)
    n_arith = max(1, (s1 - lo) // mult + 1)
    budget = max(1, slw.get("max_buckets", 32) - len(ladder))
    stride = max(1, math.ceil(n_arith / budget))
    v = lo
    while v < s1:
        ladder.append(v)
        v += stride * mult
    ladder.append(s1)
    floor = s0 if s0 < mult else s0 - s0 % mult
    return tuple(sorted(set(x for x in ladder if floor <= x <= s1)))


def seq_len_at(slw: Dict, step: int, full_len: int) -> int:
    """Linear pacing ``s0 + (s1 - s0) * min(step / T, 1)``, rounded down
    onto the ladder (the smallest bucket below it)."""
    if not slw.get("enabled", True):
        return full_len
    if slw.get("pacing", "linear") != "linear":
        raise ValueError("the reference plans linear pacing only")
    s0 = slw["start_seq_len"]
    s1 = slw.get("end_seq_len") or full_len
    t = slw["duration_steps"]
    raw = s0 + (s1 - s0) * min(step / t, 1.0)
    ladder = bucket_ladder(slw, full_len)
    i = bisect.bisect_right(ladder, raw) - 1
    return ladder[max(i, 0)]


def lr_at(opt: Dict, tokens_seen: int) -> float:
    """Token-wise cosine from ``lr`` to ``min_lr`` over ``total_tokens``
    after a linear warmup over ``warmup_tokens``; or a constant."""
    if opt.get("schedule", "token_cosine") == "constant":
        return opt["lr"]
    if opt["schedule"] != "token_cosine":
        raise ValueError(f"no reference for schedule {opt['schedule']!r}")
    lr, min_lr = opt["lr"], opt["min_lr"]
    warm = max(opt["warmup_tokens"], 1)
    if tokens_seen < warm:
        return lr * min((tokens_seen + 1) / warm, 1.0)
    total = max(opt["total_tokens"] - warm, 1)
    frac = min(max((tokens_seen - warm) / total, 0.0), 1.0)
    return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(math.pi * frac))


def plan(traffic: Dict, n_steps: int) -> List[Dict]:
    """The first ``n_steps`` plans of a training traffic mix: ``seq_len``,
    ``batch`` and ``lr``.  Truncation keeps ``batch * seq_len`` tokens a
    step."""
    out, tokens = [], 0
    full, rows = traffic["seq_len"], traffic["batch"]
    for step in range(n_steps):
        s = seq_len_at(traffic["slw"], step, full)
        lr = lr_at(traffic["optimizer"], tokens)
        out.append({"seq_len": s, "batch": rows, "lr": lr})
        tokens += rows * s
    return out
