"""Slot-addressable decode cache (``repro/serve/state.py:22-201``).

The slot cache is a dict of leaves, each with the logical axes the model's
``cache_axes`` gives it: the dense model's ``k``/``v`` (L, n_slots, S, KV,
D), RWKV-6's ``wkv`` (L, n_slots, H, D, D) and token-shift rows,
Zamba-2's Mamba-2 states (L, n_slots, ...) and shared-block
``attn_k``/``attn_v`` (G, n_slots, S, KV, D), plus ``pos`` (n_slots,)
int64 and ``active`` (n_slots,) bool.  Every method goes leaf by leaf over
the "batch" (slot) axis of each leaf, wherever it stands, with no
per-family branch.  The reference jits its slot surgery with the buffer donated; here
it happens in place on the device, and each method returns the same dict.
Model-format caches (what ``prefill`` returns, and what ``gather`` hands to
a migration) carry a 0-dim ``pos`` shared by their rows.  The paged state
(serve/paging.py) keeps the same protocol.
"""
from __future__ import annotations

from typing import Any, Dict, List, Protocol, Tuple

import torch

from repro_torch.models import model_zoo

Cache = Dict[str, torch.Tensor]


def batch_index(ax: tuple, idx) -> tuple:
    """Index selecting ``idx`` along the "batch" axis of a leaf with axes
    ``ax``."""
    return (slice(None),) * ax.index("batch") + (idx,)


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
    """``DecodeState`` over any model with ``cache_shapes``/``cache_axes``."""

    def __init__(self, model):
        self.model = model
        self.axes = model.cache_axes()  # model format: "pos" has axes ()

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
        for name, ax in self.axes.items():
            if "batch" in ax:
                cache[name][batch_index(ax, slots)] = rows[name].to(
                    cache[name].dtype)
            else:  # promoted bookkeeping leaf: shared or per row
                cache[name][slots] = rows[name].to(cache[name].dtype)
        cache["active"][slots] = True
        return cache

    def insert(self, cache: Cache, slot: int, prefill_cache: Cache) -> Cache:
        """Scatter one request's batch=1 prefill cache into ``slot``."""
        return self.insert_many(cache, torch.tensor([slot]), prefill_cache)

    def evict(self, cache: Cache, slot: int) -> Cache:
        """Retire ``slot``: its bookkeeping (position, occupancy) resets;
        its state rows are overwritten wholesale by the next insert."""
        for name, ax in self.axes.items():
            if "batch" not in ax:
                cache[name][slot] = 0
        cache["active"][slot] = False
        return cache

    def gather(self, cache: Cache, slot: int) -> Cache:
        """A copy of ``slot``'s rows as a model-format batch=1 cache
        (``state.py:114-119``): no ``active`` leaf, a 0-dim ``pos``."""
        return {name: (cache[name][batch_index(ax, slice(slot, slot + 1))]
                       if "batch" in ax else cache[name][slot]).clone()
                for name, ax in self.axes.items()}

    def decode(self, params, cache: Cache, tokens: torch.Tensor):
        return self.model.decode(params, cache, tokens)

    def row(self, prefill_cache: Cache, i: int) -> Cache:
        """Row ``i`` of a batch=k prefill cache as a batch=1 cache for the
        per-request replay of a ragged remainder.  The state leaves are
        views: replaying row i writes into row i of the batch cache."""
        return {name: (prefill_cache[name][batch_index(ax, slice(i, i + 1))]
                       if "batch" in ax else prefill_cache[name])
                for name, ax in self.axes.items()}

    def stack_rows(self, rows: List[Cache]) -> Cache:
        """Concatenate batch=1 caches into a batch=k cache; the 0-dim
        bookkeeping leaves (``pos``) of each become one entry of a (k,)
        vector."""
        return {name: (torch.cat([r[name] for r in rows],
                                 dim=ax.index("batch"))
                       if "batch" in ax
                       else torch.stack([r[name] for r in rows]))
                for name, ax in self.axes.items()}

    def fit_row(self, row: Cache, cache_len: int) -> Cache:
        """Pad (with zeros) or trim a model-format row's "seq" leaves to
        ``cache_len`` entries (``state.py:175-201``).  Migration between
        mismatched cache geometries: the valid prefix (up to ``pos``) is
        the same, and nothing past it is ever read, so trimming is lossless
        as long as the destination's capacity admits the request.  Leaves
        without a "seq" axis (recurrent state) pass through."""
        out = dict(row)
        for name, ax in self.axes.items():
            if "seq" not in ax:
                continue
            c, si = row[name], ax.index("seq")
            cur = c.shape[si]
            if cur > cache_len:
                out[name] = c.narrow(si, 0, cache_len)
            elif cur < cache_len:
                pad = [0, 0] * (c.dim() - si - 1) + [0, cache_len - cur]
                out[name] = torch.nn.functional.pad(c, pad)
        return out
