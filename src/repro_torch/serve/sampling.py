"""Sampling as pure functions of (logits, uniforms): greedy / temperature /
top-k / top-p with per-row parameters (``repro/serve/sampling.py``).

The reference draws from ``jax.random`` keys folded per request and step;
torch has no matching generator.  Here each request owns a
``torch.Generator`` seeded from ``(seed, uid)`` and draws one uniform per
sampled token, in order; the token is the inverse-CDF pick of that
uniform.  A request's stream therefore never depends on batch
composition, but it is not the reference's stream: sampled decoding is
held by its properties, greedy decoding token for token.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def mask_vocab(logits: torch.Tensor, vocab_size: Optional[int]) -> torch.Tensor:
    """fp32 logits with the padded vocab columns (>= vocab_size) masked."""
    logits = logits.float()
    if vocab_size is not None and logits.shape[-1] != vocab_size:
        logits = logits.clone()
        logits[:, vocab_size:] = NEG_INF
    return logits


def greedy(logits: torch.Tensor, vocab_size: Optional[int]) -> torch.Tensor:
    return mask_vocab(logits, vocab_size).argmax(dim=-1)


def apply_top_k(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Keep the k largest logits per row; k <= 0 disables.  top_k (B,)."""
    v = logits.shape[-1]
    k = torch.where(top_k <= 0, v, top_k.clamp(1, v)).long()
    sorted_desc = logits.sort(dim=-1, descending=True).values
    kth = sorted_desc.gather(-1, (k - 1)[:, None])
    return logits.masked_fill(logits < kth, NEG_INF)


def apply_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus truncation: keep the smallest prefix of descending-probability
    tokens whose exclusive cumulative mass is < top_p; the argmax always
    stays.  top_p (B,)."""
    sorted_desc = logits.sort(dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = probs.cumsum(dim=-1)
    keep = (cum - probs) < top_p[:, None]
    keep[:, 0] = True
    thresh = torch.where(keep, sorted_desc, torch.inf).amin(dim=-1,
                                                            keepdim=True)
    return logits.masked_fill(logits < thresh, NEG_INF)


def sample_tokens(logits: torch.Tensor, uniforms: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor,
                  vocab_size: Optional[int] = None) -> torch.Tensor:
    """One next token per row.  logits (B, V); uniforms (B,) in [0, 1);
    temperature / top_p (B,) float, top_k (B,) int.  Returns (B,) int64.

    Temperature first, then top-k, then top-p (the nucleus is taken on the
    sharpened distribution); rows with temperature <= 0 take the argmax.
    """
    logits = mask_vocab(logits, vocab_size)
    greedy_tok = logits.argmax(dim=-1)
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    masked = apply_top_p(apply_top_k(scaled, top_k), top_p)
    cdf = torch.softmax(masked, dim=-1).cumsum(dim=-1)
    # first index whose cdf exceeds u * total: a token of nonzero mass
    target = (uniforms.to(cdf.device) * cdf[:, -1])[:, None]
    sampled = torch.searchsorted(cdf, target, right=True).squeeze(1)
    sampled = sampled.clamp_max(logits.shape[-1] - 1)
    return torch.where(temperature <= 0.0, greedy_tok, sampled)


def request_generator(seed: int, uid: int) -> torch.Generator:
    """The sampling stream of one request, seeded from ``(seed, uid)``."""
    state = np.random.SeedSequence([seed, uid]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & ((1 << 63) - 1))


def draw_uniform(generator: torch.Generator) -> float:
    """The next uniform of a request's stream (one per sampled token)."""
    return float(torch.rand((), generator=generator))
