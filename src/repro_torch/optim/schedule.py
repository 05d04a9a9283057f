"""LR schedules (copy of ``repro/optim/schedule.py:17-38``): step-wise
cosine (baseline GPT-2) and token-wise cosine (paper A.2), pure functions of
exact host counters."""
from __future__ import annotations

import math

from repro_torch.configs.base import OptimizerConfig


def _cosine(frac: float, lr: float, min_lr: float) -> float:
    frac = min(max(frac, 0.0), 1.0)
    return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(math.pi * frac))


def lr_at(cfg: OptimizerConfig, step: int, tokens_seen: int) -> float:
    """LR for the step about to run."""
    if cfg.schedule == "constant":
        return cfg.lr
    if cfg.schedule == "step_cosine":
        warm = max(cfg.warmup_steps, 1)
        if step < warm:
            return cfg.lr * (step + 1) / warm
        total = max(cfg.total_steps - warm, 1)
        return _cosine((step - warm) / total, cfg.lr, cfg.min_lr)
    if cfg.schedule == "token_cosine":
        warm = max(cfg.warmup_tokens, 1)
        if tokens_seen < warm:
            return cfg.lr * min((tokens_seen + 1) / warm, 1.0)
        total = max(cfg.total_tokens - warm, 1)
        return _cosine((tokens_seen - warm) / total, cfg.lr, cfg.min_lr)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")
