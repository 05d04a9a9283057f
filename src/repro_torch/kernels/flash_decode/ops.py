"""Model-layout wrappers of flash-decode (``repro/kernels/flash_decode/ops.py:27-64``,
dense cache only).

q (B, H, D), one token per slot; caches (B, S, KV, D); lengths (B,) int32
counts of valid entries.  GQA folds to the kernel's (B, KV, G, D) query
grouping without expanding heads.  The JAX wrapper zero-padded S to a
block multiple; the CUDA kernel bounds its last split itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_decode.kernel import flash_decode_fwd


def flash_decode_partials(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, lengths: torch.Tensor):
    """fp32 partials ``(o (B, KV, G, D), m (B, KV, G), l (B, KV, G))``.

    Merge rule across shards: ``gm = max(m); out = sum(o * exp(m - gm)) /
    sum(l * exp(m - gm))``.
    """
    b, h, d = q.shape
    kvh = k_cache.shape[2]
    return flash_decode_fwd(q.reshape(b, kvh, h // kvh, d).contiguous(),
                            k_cache, v_cache, lengths)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Normalized decode attention: context (B, H, D) like q."""
    o, _, l = flash_decode_partials(q, k_cache, v_cache, lengths)
    return (o / l[..., None].clamp_min(1e-30)).reshape(q.shape).to(q.dtype)
