"""Slot-addressable decode cache (``repro/serve/state.py:55-200``, dense).

The slot cache is a dict: ``k``/``v`` (L, n_slots, S, KV, D), ``pos``
(n_slots,) int64 and ``active`` (n_slots,) bool.  The reference jits its
slot surgery with the buffer donated; here it happens in place on the
device, and each method returns the same dict.  Model-format caches (what
``DenseLM.prefill`` returns) carry a 0-dim ``pos`` shared by their rows.
Cross-replica gather and ``fit_row`` come with the migration slice.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.models import model_zoo
from repro_torch.models.transformer import DenseLM

Cache = Dict[str, torch.Tensor]


class SlotDecodeState:
    """``DecodeState`` over the dense model's KV cache."""

    def __init__(self, model: DenseLM):
        self.model = model

    def init_slots(self, n_slots: int, cache_len: int, dtype: torch.dtype,
                   device: torch.device) -> Cache:
        return model_zoo.init_decode_cache(self.model, n_slots, cache_len,
                                           dtype, device)

    def insert_many(self, cache: Cache, slots: torch.Tensor,
                    rows: Cache) -> Cache:
        """Scatter a batch=k model-format cache into ``slots`` ((k,), all
        distinct).  ``rows["pos"]`` is 0-dim (one fresh bucket) or (k,)
        (rows that ended a ragged replay at different depths)."""
        slots = slots.to(cache["pos"].device)
        cache["k"][:, slots] = rows["k"].to(cache["k"].dtype)
        cache["v"][:, slots] = rows["v"].to(cache["v"].dtype)
        cache["pos"][slots] = rows["pos"].to(cache["pos"].dtype)
        cache["active"][slots] = True
        return cache

    def insert(self, cache: Cache, slot: int, prefill_cache: Cache) -> Cache:
        """Scatter one request's batch=1 prefill cache into ``slot``."""
        return self.insert_many(cache, torch.tensor([slot]), prefill_cache)

    def evict(self, cache: Cache, slot: int) -> Cache:
        """Retire ``slot``: its position and occupancy reset; its rows are
        overwritten wholesale by the next insert."""
        cache["pos"][slot] = 0
        cache["active"][slot] = False
        return cache

    def decode(self, params, cache: Cache, tokens: torch.Tensor):
        return self.model.decode(params, cache, tokens)

    def row(self, prefill_cache: Cache, i: int) -> Cache:
        """Row ``i`` of a batch=k prefill cache as a batch=1 cache for the
        per-request replay of a ragged remainder.  The k/v leaves are views:
        replaying row i writes into row i of the batch cache."""
        return {"k": prefill_cache["k"][:, i:i + 1],
                "v": prefill_cache["v"][:, i:i + 1],
                "pos": prefill_cache["pos"]}

    def stack_rows(self, rows: List[Cache]) -> Cache:
        """Concatenate batch=1 caches into a batch=k cache; the 0-dim ``pos``
        of each becomes one entry of a (k,) vector."""
        return {"k": torch.cat([r["k"] for r in rows], dim=1),
                "v": torch.cat([r["v"] for r in rows], dim=1),
                "pos": torch.stack([r["pos"] for r in rows])}
