"""Slot-addressable decode cache (``repro/serve/state.py:22-201``, dense).

The slot cache is a dict: ``k``/``v`` (L, n_slots, S, KV, D), ``pos``
(n_slots,) int64 and ``active`` (n_slots,) bool.  The reference jits its
slot surgery with the buffer donated; here it happens in place on the
device, and each method returns the same dict.  Model-format caches (what
``DenseLM.prefill`` returns, and what ``gather`` hands to a migration)
carry a 0-dim ``pos`` shared by their rows.  The paged state
(serve/paging.py) keeps the same protocol.
"""
from __future__ import annotations

from typing import Any, Dict, List, Protocol, Tuple

import torch

from repro_torch.models import model_zoo
from repro_torch.models.transformer import DenseLM

Cache = Dict[str, torch.Tensor]
SEQ_AXIS = 2  # of the model-format k/v leaves (L, B, S, KV, D)


class DecodeState(Protocol):
    """Slot-addressable decode cache for continuous batching."""

    def init_slots(self, n_slots: int, cache_len: int, dtype: torch.dtype,
                   device: torch.device) -> Cache:
        """Allocate a zeroed ``n_slots``-wide cache."""

    def insert(self, cache: Cache, slot: int, prefill_cache: Cache) -> Cache:
        """Scatter one request's batch=1 prefill cache into ``slot``."""

    def insert_many(self, cache: Cache, slots: torch.Tensor,
                    prefill_cache: Cache) -> Cache:
        """Scatter a batch=k prefill cache into the ``k`` ``slots``."""

    def evict(self, cache: Cache, slot: int) -> Cache:
        """Retire ``slot`` (resets its position bookkeeping)."""

    def gather(self, cache: Cache, slot: int) -> Cache:
        """Extract ``slot``'s state as a batch=1 cache (slot migration)."""

    def decode(self, params: Any, cache: Cache, tokens: torch.Tensor
               ) -> Tuple[torch.Tensor, Cache]:
        """One fused decode step for all slots; per-slot positions."""

    def fit_row(self, row: Cache, cache_len: int) -> Cache:
        """Pad/trim a model-format row's seq capacity to ``cache_len``."""


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

    def gather(self, cache: Cache, slot: int) -> Cache:
        """A copy of ``slot``'s rows as a model-format batch=1 cache
        (``state.py:114-119``): no ``active`` leaf, a 0-dim ``pos``."""
        return {"k": cache["k"][:, slot:slot + 1].clone(),
                "v": cache["v"][:, slot:slot + 1].clone(),
                "pos": cache["pos"][slot].clone()}

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

    def fit_row(self, row: Cache, cache_len: int) -> Cache:
        """Pad (with zeros) or trim a model-format row's k/v to ``cache_len``
        entries (``state.py:175-201``).  Migration between mismatched cache
        geometries: the valid prefix (up to ``pos``) is the same, and
        nothing past it is ever read, so trimming is lossless as long as
        the destination's capacity admits the request."""
        out = dict(row)
        for name in ("k", "v"):
            c = row[name]
            cur = c.shape[SEQ_AXIS]
            if cur > cache_len:
                out[name] = c[:, :, :cache_len]
            elif cur < cache_len:
                out[name] = torch.nn.functional.pad(
                    c, (0, 0, 0, 0, 0, cache_len - cur))
        return out
