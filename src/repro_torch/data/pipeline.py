"""Resumable data pipeline, text only (copy of ``repro/data/pipeline.py:27-58``).

Batches are always full length ``(B, S)`` numpy arrays; the SLW curriculum
truncates or repacks them on the host.  Batch ``step`` is sequence indices
``[step * B_global + r]`` for the rank's slice, pure arithmetic over
(step, dp_rank, dp_size).  The validation stream reads a disjoint index
space.  numpy only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.data.synthetic import SyntheticCorpus


@dataclass
class DataPipeline:
    corpus: SyntheticCorpus
    global_batch: int
    dp_rank: int = 0
    dp_size: int = 1

    def __post_init__(self):
        if self.global_batch % self.dp_size:
            raise ValueError(f"global batch {self.global_batch} is not a "
                             f"multiple of dp_size {self.dp_size}")
        self.local_batch = self.global_batch // self.dp_size

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        base = step * self.global_batch + self.dp_rank * self.local_batch
        return self.corpus.batch(base, self.local_batch)

    def eval_batch(self, step: int, batch_size: int) -> Dict[str, np.ndarray]:
        base = 1_000_000_000 + step * batch_size
        return self.corpus.batch(base, batch_size)
