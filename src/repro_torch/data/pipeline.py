"""Resumable data pipeline (copy of ``repro/data/pipeline.py:27-58``).

Batches are always full length ``(B, S)`` numpy arrays; the SLW curriculum
truncates or repacks them on the host.  Batch ``step`` is sequence indices
``[step * B_global + r]`` for the rank's slice, pure arithmetic over
(step, dp_rank, dp_size).  The validation stream reads a disjoint index
space.  With a ``model_cfg`` whose frontend is a stub, a batch also
carries its embeddings: ``patch_embeds`` (B, P, d) for ``vision_patches``,
``frames`` (B, S, d) for ``audio_frames``, 0.02 x standard normals from
the reference's ``Philox`` keys of the step, so both packages see the
same arrays.  numpy only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import SyntheticCorpus


@dataclass
class DataPipeline:
    corpus: SyntheticCorpus
    global_batch: int
    dp_rank: int = 0
    dp_size: int = 1
    model_cfg: Optional[ModelConfig] = None

    def __post_init__(self):
        if self.global_batch % self.dp_size:
            raise ValueError(f"global batch {self.global_batch} is not a "
                             f"multiple of dp_size {self.dp_size}")
        self.local_batch = self.global_batch // self.dp_size

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        base = step * self.global_batch + self.dp_rank * self.local_batch
        batch = self.corpus.batch(base, self.local_batch)
        cfg = self.model_cfg
        if cfg is not None and cfg.frontend == "vision_patches":
            rng = np.random.Generator(np.random.Philox(key=10_000_019 + step))
            batch["patch_embeds"] = rng.standard_normal(
                (self.local_batch, cfg.prefix_tokens, cfg.d_model),
                dtype=np.float32) * 0.02
        if cfg is not None and cfg.frontend == "audio_frames":
            rng = np.random.Generator(np.random.Philox(key=20_000_003 + step))
            batch["frames"] = rng.standard_normal(
                (self.local_batch, self.corpus.seq_len, cfg.d_model),
                dtype=np.float32) * 0.02
        return batch

    def eval_batch(self, step: int, batch_size: int) -> Dict[str, np.ndarray]:
        base = 1_000_000_000 + step * batch_size
        return self.corpus.batch(base, batch_size)
