"""The paper's low-cost hyperparameter tuning strategy (Section 4; copy of
``repro/core/tuning.py:1-90``).

    (1) start with seqlen_s = 8 and T = a few multiples of the LR warmup;
    (2) increase seqlen_s until validation perplexity no longer has
        significant fluctuation at the very beginning;
    (3) binary-search the largest T with no significant fluctuation during
        the first few multiples of LR warmup steps,

where "significant fluctuation" = validation perplexity > 1.3x the previous
best (the paper's heuristic).  Only the probe window is trained.  The probe
is injected as a callable, so the same tuner drives tiny CPU runs and
full-width runs on the card (``repro_torch.launch.paper.tuner_probe``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

from repro_torch.configs.base import SLWConfig

# probe(slw_cfg) -> the validation perplexities sampled during the probe
# window (e.g. every eval_interval steps of the first N steps)
ProbeFn = Callable[[SLWConfig], List[float]]


def significant_fluctuation(ppls: Sequence[float],
                            threshold: float = 1.3) -> bool:
    """Paper §4: a perplexity above ``threshold`` x the previous best."""
    best = float("inf")
    for p in ppls:
        if p > threshold * best:
            return True
        best = min(best, p)
    return False


@dataclass
class TuneResult:
    seqlen_s: int
    duration: int
    trials: List[Tuple[int, int, bool]]  # (seqlen_s, T, fluctuated)

    @property
    def probe_runs(self) -> int:
        return len(self.trials)


def tune_slw(probe: ProbeFn, base: SLWConfig, warmup_steps: int,
             seqlen_s_grid: Sequence[int] = (8, 16, 32, 64),
             t_multiple_range: Tuple[int, int] = (1, 16),
             fluctuation_threshold: float = 1.3) -> TuneResult:
    """The 3-step recipe in O(len(grid) + log(range)) probe runs, each only
    ``probe``'s window long."""
    trials: List[Tuple[int, int, bool]] = []

    def fluctuates(s0: int, t: int) -> bool:
        cfg = dataclasses.replace(base, start_seq_len=s0, duration_steps=t,
                                  enabled=True)
        bad = significant_fluctuation(probe(cfg), fluctuation_threshold)
        trials.append((s0, t, bad))
        return bad

    # steps 1 + 2: the smallest seqlen_s with a calm start, at the shortest T
    t0 = max(t_multiple_range[0] * warmup_steps, 1)
    seqlen_s = seqlen_s_grid[-1]
    for s0 in seqlen_s_grid:
        if not fluctuates(s0, t0):
            seqlen_s = s0
            break

    # step 3: binary search the largest calm T in [lo, hi] x warmup_steps
    lo, hi = t_multiple_range
    best = lo
    while lo <= hi:
        mid = (lo + hi) // 2
        if fluctuates(seqlen_s, mid * warmup_steps):
            hi = mid - 1
        else:
            best = mid
            lo = mid + 1
    return TuneResult(seqlen_s=seqlen_s, duration=best * warmup_steps,
                      trials=trials)
