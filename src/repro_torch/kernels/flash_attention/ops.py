"""Model-layout wrapper of flash attention (``repro/kernels/flash_attention/ops.py``,
forward only).

q (B, S, H, D); k, v (B, S, KV, D) with H = KV * G.  KV heads are expanded
to Q heads (GQA, ``ops.py:34-42``) and heads flattened to (B*H, S, D).  The
JAX wrapper padded S to the lcm of its blocks and masked with
``valid_len``; the CUDA kernel masks its own ragged tail, so there is no
padded copy here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd


def _flatten(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, Hx, D) -> (B*Hx*g, S, D) contiguous, head-major."""
    b, s, h, d = x.shape
    if g > 1:
        x = x.repeat_interleave(g, dim=2)
    return x.permute(0, 2, 1, 3).reshape(b * h * g, s, d).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Causal GQA attention; returns (B, S, H, D) like q."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    o, _ = flash_attention_fwd(_flatten(q, 1), _flatten(k, g), _flatten(v, g),
                               causal=causal, valid_len=s)
    return o.reshape(b, h, s, d).permute(0, 2, 1, 3)
