"""Model-layout wrappers of flash-decode (``repro/kernels/flash_decode/ops.py:27-103``).

q (B, H, D), one token per slot; dense caches (B, S, KV, D), or paged pools
(n_pages, page_size, KV, D) with a (B, max_pages) int32 page table;
lengths (B,) int32 counts of valid entries.  GQA folds to the kernels'
(B, KV, G, D) query grouping without expanding heads.  The JAX wrapper
zero-padded S to a block multiple; the CUDA kernels bound their last split
themselves.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.kernel import (flash_decode_fwd,
                                                     flash_decode_paged_fwd)


def _grouped(q: torch.Tensor, kvh: int) -> torch.Tensor:
    b, h, d = q.shape
    return q.reshape(b, kvh, h // kvh, d).contiguous()


def _normalize(partials, q: torch.Tensor) -> torch.Tensor:
    o, _, l = partials
    return (o / l[..., None].clamp_min(1e-30)).reshape(q.shape).to(q.dtype)


def flash_decode_partials(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, lengths: torch.Tensor):
    """fp32 partials ``(o (B, KV, G, D), m (B, KV, G), l (B, KV, G))``.

    Merge rule across shards: ``gm = max(m); out = sum(o * exp(m - gm)) /
    sum(l * exp(m - gm))``.
    """
    return flash_decode_fwd(_grouped(q, k_cache.shape[2]), k_cache, v_cache,
                            lengths)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Normalized decode attention: context (B, H, D) like q."""
    return _normalize(flash_decode_partials(q, k_cache, v_cache, lengths), q)


def flash_decode_paged_partials(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                page_table: torch.Tensor,
                                lengths: torch.Tensor):
    """Paged variant of ``flash_decode_partials`` (same merge algebra)."""
    return flash_decode_paged_fwd(_grouped(q, k_pool.shape[2]), k_pool,
                                  v_pool, page_table, lengths)


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Normalized paged decode attention: context (B, H, D) like q."""
    return _normalize(flash_decode_paged_partials(q, k_pool, v_pool,
                                                  page_table, lengths), q)
