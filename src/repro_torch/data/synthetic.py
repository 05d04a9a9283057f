"""Deterministic synthetic corpus (copy of ``repro/data/synthetic.py:24-53``).

Each document is an affine-recurrence token stream
``x_{t+1} = (a * x_t + b) mod V`` with a random fraction of steps replaced
by noise; document ``i`` comes from ``Philox(seed + 7919 * i)``, so both
packages draw the same prompts from the same seed.  numpy only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class SyntheticCorpus:
    vocab_size: int
    seq_len: int
    seed: int = 1234
    noise: float = 0.15
    n_param_families: int = 8

    def sequence(self, index: int) -> np.ndarray:
        """Token sequence ``index``, length seq_len + 1 (next-token shift)."""
        rng = np.random.Generator(np.random.Philox(key=self.seed + 7919 * index))
        v = self.vocab_size
        fam = rng.integers(0, self.n_param_families)
        frng = np.random.Generator(np.random.Philox(key=self.seed * 31 + fam))
        a = int(frng.integers(1, v - 1)) | 1
        b = int(frng.integers(0, v))
        n = self.seq_len + 1
        noise_mask = rng.random(n) < self.noise
        noise_vals = rng.integers(0, v, size=n)
        x = np.empty(n, dtype=np.int64)
        x[0] = rng.integers(0, v)
        for t in range(1, n):
            x[t] = (a * x[t - 1] + b) % v
            if noise_mask[t]:
                x[t] = noise_vals[t]
        return x.astype(np.int32)

    def batch(self, start_index: int, batch_size: int) -> Dict[str, np.ndarray]:
        seqs = np.stack([self.sequence(start_index + i)
                         for i in range(batch_size)])
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
