"""Differentiable model-layout wrapper of flash attention
(``repro/kernels/flash_attention/ops.py``).

q (B, S, H, D); k, v (B, S, KV, D) with H = KV * G.  ``flash_attention`` is
a ``torch.autograd.Function``, the counterpart of the reference's
``jax.custom_vjp`` (``ops.py:68-104``), used on both devices:

* forward: KV heads expanded to Q heads (GQA, ``ops.py:34-42``), heads
  flattened to (B*H, S, D), ``flash_attention_fwd``; saves ``(q, k, v, o,
  lse)`` with k/v unexpanded, as the reference does.
* backward: re-expands and flattens (dO arrives strided from the permute
  and is made contiguous), runs ``flash_attention_bwd``, then sums dK/dV
  over each KV head's group of G query heads in fp32 (``ops.py:95-100``).

On CUDA tensors both directions launch the kernels; on CPU tensors both run
the kernels' plain versions, so the CPU tests exercise the same wiring the
card runs.  The JAX wrapper padded S to the lcm of its blocks and masked
with ``valid_len``; the CUDA kernels mask their own ragged tails, so there
is no padded copy here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                        flash_attention_fwd)


def _flatten(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, Hx, D) -> (B*Hx*g, S, D) contiguous, head-major."""
    b, s, h, d = x.shape
    if g > 1:
        x = x.repeat_interleave(g, dim=2)
    return x.permute(0, 2, 1, 3).reshape(b * h * g, s, d).contiguous()


def _unflatten(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B*H, S, D) -> (B, S, H, D), a strided view."""
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).permute(0, 2, 1, 3)


class FlashAttention(torch.autograd.Function):
    """Causal GQA flash attention with the hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        b, s = q.shape[:2]
        g = q.shape[2] // k.shape[2]
        o, lse = flash_attention_fwd(_flatten(q, 1), _flatten(k, g),
                                     _flatten(v, g), causal=causal,
                                     valid_len=s)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return _unflatten(o, b)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        b, s, h, d = q.shape
        kvh = k.shape[2]
        g = h // kvh
        dqf, dkf, dvf = flash_attention_bwd(
            _flatten(q, 1), _flatten(k, g), _flatten(v, g), o, lse,
            _flatten(dout, 1), causal=ctx.causal, valid_len=s)
        dk = (_unflatten(dkf, b).float().reshape(b, s, kvh, g, d).sum(dim=3))
        dv = (_unflatten(dvf, b).float().reshape(b, s, kvh, g, d).sum(dim=3))
        return (_unflatten(dqf, b), dk.to(k.dtype), dv.to(v.dtype), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Causal GQA attention; returns (B, S, H, D) like q.  Differentiable:
    ``torch.autograd`` routes through the backward kernels."""
    return FlashAttention.apply(q, k, v, causal)
