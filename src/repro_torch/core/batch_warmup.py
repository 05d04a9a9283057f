"""GPT-3-style batch-size warmup (copy of ``repro/core/batch_warmup.py:20-50``).

Start at ``start_batch`` and grow linearly in tokens to the full batch over
``warmup_tokens``, rounded down to a multiple of the data-parallel size.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import BatchWarmupConfig


def quantize_batch(raw: float, dp_size: int, min_batch: int,
                   full_batch: int) -> int:
    """Round down to a multiple of ``dp_size`` and clip to
    [max(min_batch, dp_size), full_batch]."""
    b = int(raw) - int(raw) % dp_size
    return int(np.clip(b, max(min_batch, dp_size), full_batch))


@dataclass
class BatchWarmup:
    cfg: BatchWarmupConfig
    full_batch: int
    dp_size: int = 1

    def batch_for_tokens(self, tokens_seen: int) -> int:
        if not self.cfg.enabled:
            return self.full_batch
        frac = min(tokens_seen / max(self.cfg.warmup_tokens, 1), 1.0)
        raw = self.cfg.start_batch + frac * (self.full_batch
                                             - self.cfg.start_batch)
        return quantize_batch(raw, self.dp_size, self.cfg.start_batch,
                              self.full_batch)
