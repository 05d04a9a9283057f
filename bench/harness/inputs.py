"""What the benchmark makes from ``--seed`` and hands to both sides: the
weights and the token batches.

Weights are drawn on the device by one ``torch.Generator`` seeded with the
seed, one call per parameter group (a layered group is drawn for all layers
at once), in the order the reference declares the groups, so a second
draw gives the same numbers.  Token batches are Zipf-distributed ids (a few
ids common, a long tail, as in text), drawn by numpy's Philox keyed on the
seed and the batch's first sequence index, so every batch row differs and
any batch can be drawn again alone.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from bench.reference.transformer import Group


def draw(groups: List[Group], n_layers: int, seed: int,
         device: torch.device) -> Iterator[Tuple[Group, torch.Tensor]]:
    """(group, fp32 tensor) in group order; a layered group's tensor has
    the ``n_layers`` layers on a leading axis."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    for g in groups:
        shape = ((n_layers,) if g.layered else ()) + g.shape
        if g.init == "normal":
            t = torch.randn(shape, generator=gen, device=device)
            t.mul_(g.scale)
        elif g.init == "ones":
            t = torch.ones(shape, device=device)
        elif g.init == "zeros":
            t = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown init {g.init!r} of {g.name}")
        yield g, t


class Corpus:
    """Token batches of a cell: ``batch(start, rows)`` gives sequences
    ``start .. start + rows - 1`` as ``tokens`` and next-token ``labels``
    (rows, seq_len) int32.  The interface of the program's corpus, so its
    data pipeline runs unchanged on these batches."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int,
                 zipf_a: float):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed % 2 ** 63
        self.zipf_a = zipf_a

    def batch(self, start_index: int, batch_size: int
              ) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(
            key=(self.seed << 64) | start_index))
        ranks = rng.zipf(self.zipf_a, (batch_size, self.seq_len + 1))
        ids = ((ranks - 1) % self.vocab_size).astype(np.int32)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
