"""Paged slot caches: a shared KV page pool behind per-slot page tables
(``repro/serve/paging.py``).

Dense ``SlotDecodeState`` rows reserve ``cache_len`` tokens of KV for every
slot, whatever each request needs.  Here the leaves whose axes hold "seq"
(the attention k/v) become one pool of fixed-size pages plus a per-slot
page table:

* pool leaves: dense ``(L, n_slots, cache_len, KV, D)`` becomes
  ``(L, n_pages, page_size, KV, D)``, sized to ``n_pages * page_size``
  tokens instead of ``n_slots * cache_len``;
* ``page_table`` (n_slots, pages_per_slot) int32 on the device, ``-1`` =
  unowned.  Pages are allocated on insert (the prompt's), one at a time on
  decode when a slot's position crosses into a page it does not own, and
  freed on evict;
* admission: a request reserves ``ceil((prompt_len + max_tokens) /
  page_size)`` pages before it takes a slot (``try_reserve``, the
  scheduler's ``reserve`` hook), so growth on decode never fails: page
  exhaustion is a wait at admission, not a fault mid-decode.

Recurrent state leaves (RWKV-6's ``wkv`` and token-shift rows, Zamba-2's
SSM and conv states) have no "seq" axis and stay dense, one row per slot,
in the same dict; for RWKV-6 the paged state is a structural no-op
(``paging.py:22-26``), for Zamba-2 only the shared block's ``attn_k`` /
``attn_v`` (groups, n_pages, page_size, KV, D) are paged.

The allocator lives on the host.  The device table is uploaded only when
the host table changed (``decode``), not every step.  Prefill and replay
still run on dense batch=1 caches (``row``/``stack_rows``/replay ``decode``
are the dense state's); paging starts at ``insert``.  ``shardings`` keeps
the pools' head axes on the activation rules and replicates their page
axes and the page table (``paging.py:419-438``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.models import model_zoo
from repro_torch.models.layers import cache_dtypes
from repro_torch.serve.state import Cache, SlotDecodeState, batch_index


class PageExhausted(RuntimeError):
    """No free page satisfies an allocation.

    Under reservation-gated admission this is a caller bug (allocating for
    a slot that never reserved, or past its reservation), never a mid-decode
    overload."""


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache entries."""
    return -(-max(int(n_tokens), 0) // page_size)


class PageAllocator:
    """Host-side free-list page allocator with per-slot page tables
    (``paging.py:62-166``).

    Invariants (``check``): every page is on the free list or owned by
    exactly one slot; ``table[slot, :owned[slot]]`` are the slot's pages in
    position order and the rest of the row is -1; ``sum(max(owned,
    reserved)) <= n_pages``, so a reserved slot's growth always finds a
    free page.
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 pages_per_slot: int):
        if n_pages < 1 or page_size < 1 or pages_per_slot < 1:
            raise ValueError(f"need n_pages, page_size, pages_per_slot >= 1, "
                             f"got {n_pages}, {page_size}, {pages_per_slot}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_slots = n_slots
        self.pages_per_slot = pages_per_slot
        self.free_pages: List[int] = list(range(n_pages))[::-1]  # pop -> 0
        self.table = np.full((n_slots, pages_per_slot), -1, np.int32)
        self.owned = np.zeros(n_slots, np.int64)
        self.reserved = np.zeros(n_slots, np.int64)

    # -- accounting ---------------------------------------------------------
    @property
    def committed(self) -> int:
        """Pages promised: per slot the max of owned and reserved."""
        return int(np.maximum(self.owned, self.reserved).sum())

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self.free_pages)

    @property
    def free_page_count(self) -> int:
        """Unowned pages (router telemetry; reservations are not
        subtracted: ``committed`` is the admission-side truth)."""
        return len(self.free_pages)

    def occupancy(self) -> float:
        """Share of the pool's pages owned (``paging.py:105-106``)."""
        return self.pages_in_use / self.n_pages

    # -- reservation (admission control) ------------------------------------
    def can_reserve(self, slot: int, n_pages: int) -> bool:
        if n_pages > self.pages_per_slot:
            return False
        cur = int(max(self.owned[slot], self.reserved[slot]))
        new = int(max(self.owned[slot], n_pages))
        return self.committed - cur + new <= self.n_pages

    def reserve(self, slot: int, n_pages: int) -> bool:
        """Reserve ``n_pages`` for ``slot``; False if the pool cannot honor
        it (the request waits)."""
        if not self.can_reserve(slot, n_pages):
            return False
        self.reserved[slot] = n_pages
        return True

    # -- allocation ----------------------------------------------------------
    def _grow_one(self, slot: int) -> None:
        if self.owned[slot] >= self.pages_per_slot:
            raise PageExhausted(f"slot {slot}: page table full "
                                f"({self.pages_per_slot} pages)")
        if self.owned[slot] >= self.reserved[slot] \
                and self.committed >= self.n_pages:
            raise PageExhausted(
                f"slot {slot}: pool committed ({self.committed}/"
                f"{self.n_pages} pages) and slot has no reservation left")
        assert self.free_pages, "free list empty with headroom: invariant bug"
        page = self.free_pages.pop()
        self.table[slot, self.owned[slot]] = page
        self.owned[slot] += 1

    def allocate(self, slot: int, n_tokens: int) -> None:
        """Ensure ``slot`` owns pages covering token indices
        ``[0, n_tokens)`` (idempotent; allocates only the deficit)."""
        need = pages_for(n_tokens, self.page_size)
        while self.owned[slot] < need:
            self._grow_one(slot)

    def free_slot(self, slot: int) -> None:
        """Return all of ``slot``'s pages and drop its reservation."""
        for i in range(int(self.owned[slot])):
            self.free_pages.append(int(self.table[slot, i]))
        self.table[slot, :] = -1
        self.owned[slot] = 0
        self.reserved[slot] = 0

    def check(self) -> None:
        """Assert the ownership invariants."""
        owned = [int(p) for row, n in zip(self.table, self.owned)
                 for p in row[:int(n)]]
        assert len(set(owned)) == len(owned), "page double-owned"
        assert not set(owned) & set(self.free_pages), "owned page on free list"
        assert sorted(owned + self.free_pages) == list(range(self.n_pages)), \
            "pages leaked"
        assert all((row[int(n):] == -1).all()
                   for row, n in zip(self.table, self.owned))
        assert self.committed <= self.n_pages


def paged_cache_specs(model, n_slots: int, cache_len: int, page_size: int,
                      n_pages: int) -> Dict[str, Tuple[tuple, str]]:
    """(shape, kind) per paged slot-cache leaf: leaves with a "seq" axis
    swap their (batch, seq) dims for (n_pages, page_size); the rest are
    ``model_zoo.decode_cache_specs``'s.  ``init_slots`` adds the
    ``page_table`` leaf."""
    axes = model_zoo.decode_cache_axes(model)
    out = {}
    for name, (shape, kind) in model_zoo.decode_cache_specs(
            model, n_slots, cache_len).items():
        ax = axes[name]
        if "seq" in ax:
            bi, si = ax.index("batch"), ax.index("seq")
            assert si == bi + 1, f"paging assumes seq right after batch: {ax}"
            shape = shape[:bi] + (n_pages, page_size) + shape[si + 1:]
        out[name] = (shape, kind)
    return out


class PagedDecodeState(SlotDecodeState):
    """``DecodeState`` over a paged KV pool and per-slot page tables.

    Besides the protocol: ``try_reserve`` (the admission page budget) and
    the :class:`PageAllocator` at ``self.alloc``.  ``insert`` (one slot,
    inherited) goes through :meth:`insert_many`, as the reference's
    (``paging.py:356-365``) writes one slot through the paged scatter.
    Counters:
    ``table_uploads`` (host-to-device copies of the page table) and
    ``refusals`` (reservations refused, each an admission that waited).
    """

    def __init__(self, model, page_size: int, n_pages: int):
        super().__init__(model)
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.table_uploads = 0
        self.refusals = 0

    def shardings(self, rules, n_slots: int, cache_len: int):
        """Pools keep their head and state axes on the activation rules;
        page axes and the page table are replicated."""
        return _paged_shardings(self, rules, n_slots, cache_len)

    # -- protocol ------------------------------------------------------------
    def init_slots(self, n_slots: int, cache_len: int, dtype: torch.dtype,
                   device: torch.device) -> Cache:
        self.cache_len = cache_len
        self.alloc = PageAllocator(self.n_pages, self.page_size, n_slots,
                                   pages_for(cache_len, self.page_size))
        self._host_pos = np.zeros(n_slots, np.int64)
        self._host_active = np.zeros(n_slots, bool)
        self._dirty = False
        kinds = cache_dtypes(dtype)
        cache = {name: torch.zeros(shape, dtype=kinds[kind], device=device)
                 for name, (shape, kind) in paged_cache_specs(
                     self.model, n_slots, cache_len, self.page_size,
                     self.n_pages).items()}
        cache["page_table"] = torch.from_numpy(self.alloc.table).to(device)
        return cache

    def try_reserve(self, slot: int, request) -> bool:
        """Admission page budget: reserve the request's worst case
        (``ceil((prompt_len + max_tokens) / page_size)`` pages) so growth on
        decode never fails; False = the request waits."""
        ok = self.alloc.reserve(slot, pages_for(
            request.prompt_len + request.max_tokens, self.page_size))
        self.refusals += not ok
        return ok

    def insert_many(self, cache: Cache, slots: torch.Tensor,
                    rows: Cache) -> Cache:
        """Allocate each row's prompt pages and copy the rows' "seq" leaves
        into them; the other state leaves go to the slots' rows as in the
        dense state.  ``rows["pos"]`` is 0-dim (shared) or (k,) per row."""
        slot_list = [int(s) for s in torch.as_tensor(slots).tolist()]
        counts = torch.broadcast_to(rows["pos"].cpu(),
                                    (len(slot_list),)).tolist()
        ps = self.page_size
        src_row, src_page, dst_page = [], [], []
        for i, (slot, n_tok) in enumerate(zip(slot_list, counts)):
            self.alloc.allocate(slot, n_tok)
            self._host_pos[slot] = n_tok
            self._host_active[slot] = True
            for j in range(pages_for(n_tok, ps)):
                src_row.append(i)
                src_page.append(j)
                dst_page.append(int(self.alloc.table[slot, j]))
        self._dirty = True
        dev = cache["pos"].device
        idx = torch.tensor(slot_list, dtype=torch.long, device=dev)
        dst = torch.tensor(dst_page, dtype=torch.long, device=dev)
        src = (torch.tensor(src_row, dtype=torch.long, device=dev),
               torch.tensor(src_page, dtype=torch.long, device=dev))
        for name, ax in self.axes.items():
            if "seq" in ax:
                # (.., k, S, ..) -> (.., k, S / ps, ps, ..) -> the pages
                r, si = rows[name], ax.index("seq")
                pad = (-r.shape[si]) % ps
                if pad:
                    r = torch.nn.functional.pad(
                        r, [0, 0] * (r.dim() - si - 1) + [0, pad])
                pages = r.unflatten(si, (r.shape[si] // ps, ps))
                cache[name][batch_index(ax, dst)] = pages[
                    batch_index(ax, src[0]) + (src[1],)].to(cache[name].dtype)
            elif "batch" in ax:
                cache[name][batch_index(ax, idx)] = rows[name].to(
                    cache[name].dtype)
        cache["pos"][idx] = torch.tensor(counts, dtype=cache["pos"].dtype,
                                         device=dev)
        cache["active"][idx] = True
        return cache

    def evict(self, cache: Cache, slot: int) -> Cache:
        """Free the slot's pages and reservation; its position and
        occupancy reset."""
        slot = int(slot)
        self.alloc.free_slot(slot)
        self._host_pos[slot] = 0
        self._host_active[slot] = False
        self._dirty = True
        return super().evict(cache, slot)

    def gather(self, cache: Cache, slot: int) -> Cache:
        """The slot's state as a model-format batch=1 cache: its pages of
        each "seq" leaf as ``pages_per_slot * page_size`` entries, unowned
        pages zeroed, and its rows of the other leaves."""
        slot = int(slot)
        row = torch.from_numpy(self.alloc.table[slot].copy()).to(
            cache["pos"].device).long()
        out = {}
        for name, ax in self.axes.items():
            if "seq" in ax:
                bi = ax.index("batch")
                pages = cache[name][batch_index(ax, row.clamp_min(0))]
                owned = (row >= 0).reshape((1,) * bi + (-1,) + (1,) * (
                    pages.dim() - bi - 1))
                pages = torch.where(owned, pages, torch.zeros(
                    (), dtype=pages.dtype, device=pages.device))
                out[name] = pages.flatten(bi, bi + 1).unsqueeze(bi)
            elif "batch" in ax:
                out[name] = cache[name][batch_index(
                    ax, slice(slot, slot + 1))].clone()
            else:
                out[name] = cache[name][slot].clone()
        return out

    def decode(self, params, cache: Cache, tokens: torch.Tensor):
        """Fused decode with growth on decode (``paging.py:391-417``).

        Every active slot whose next write crosses into a page it does not
        own gets one page (its reservation guarantees it); the device page
        table is refreshed only when the host table changed.  Dense
        batch=1 replay caches (no ``page_table`` leaf) pass straight
        through to the model.
        """
        if "page_table" not in cache:
            return self.model.decode(params, cache, tokens)
        for slot in np.nonzero(self._host_active)[0]:
            p = int(self._host_pos[slot])
            if p < self.cache_len \
                    and int(self.alloc.owned[slot]) * self.page_size <= p:
                self.alloc.allocate(int(slot), p + 1)
                self._dirty = True
        if self._dirty:
            cache["page_table"].copy_(torch.from_numpy(self.alloc.table))
            self.table_uploads += 1
            self._dirty = False
        logits, cache = self.model.decode(params, cache, tokens)
        cap = self.alloc.pages_per_slot * self.page_size
        act = self._host_active
        self._host_pos[act] = np.minimum(self._host_pos[act] + 1, cap)
        return logits, cache


def _paged_shardings(state: "PagedDecodeState", rules, n_slots: int,
                     cache_len: int):
    from repro_torch.distributed.sharding import tree_act_shardings
    specs = paged_cache_specs(state.model, n_slots, cache_len,
                              state.page_size, state.n_pages)
    # a page is not slot-owned: a pool's (page, in-page) axes take no
    # "batch" or "seq" rule
    axes = {name: (tuple(None if a in ("batch", "seq") else a for a in ax)
                   if "seq" in ax else ax)
            for name, ax in model_zoo.decode_cache_axes(state.model).items()}
    out = tree_act_shardings(rules, axes, specs)
    table = ((n_slots, pages_for(cache_len, state.page_size)), "int")
    out["page_table"] = tree_act_shardings(rules, (None, None), table)
    return out


def cache_nbytes(cache: Cache) -> int:
    """Resident bytes of a decode cache (dense vs paged: ``n_slots *
    cache_len`` vs ``n_pages * page_size`` tokens of KV)."""
    return sum(t.numel() * t.element_size() for t in cache.values())
