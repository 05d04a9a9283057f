"""Slot migration between decode states (``repro/distributed/collectives.py:93-119``).

Only ``migrate_row`` is ported.  The reference's ``placement`` hook, a
``jax.device_put`` of the row onto another host's mesh, waits for the
distributed slice (ROADMAP A14): here every replica lives on one device,
so the row moves by plain tensor copies.
"""
from __future__ import annotations


def migrate_row(src_state, src_cache, src_slot: int, dst_state, dst_cache,
                dst_slot: int, cache_len=None):
    """Move one slot's cache row from ``src_state`` to ``dst_state``.

    The row travels in model format: ``gather`` on the source, ``fit_row``
    to the destination's capacity when ``cache_len`` is given (a paged
    gather returns ``pages_per_slot * page_size`` entries; everything past
    ``pos`` is never read, so trimming is lossless), ``insert`` on the
    destination, ``evict`` on the source.  So it works across dense and
    paged states in either direction.  Returns ``(src_cache, dst_cache)``;
    host bookkeeping (scheduler slots, page reservations) is the caller's
    (``Replica.migrate_slot_to``).
    """
    row = src_state.gather(src_cache, src_slot)
    if cache_len is not None:
        row = dst_state.fit_row(row, cache_len)
    dst_cache = dst_state.insert(dst_cache, dst_slot, row)
    src_cache = src_state.evict(src_cache, src_slot)
    return src_cache, dst_cache
