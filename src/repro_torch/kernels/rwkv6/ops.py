"""Differentiable wrapper of the WKV-6 kernels (``repro/kernels/rwkv6/ops.py``).

``wkv6`` pads the sequence to a chunk multiple outside the autograd
Function (log_w = 0 and k = 0 pad rows decay by exp(0) = 1 and inject
nothing, so the final state is unchanged) and slices the padded rows off
y.  ``WKV6`` is the counterpart of the reference's ``jax.custom_vjp``
(``ops.py:35-57``), used on both devices:

* forward: ``wkv6_fwd`` with the per-chunk entry states; saves ``(r, k, v,
  log_w, u, carries)``;
* backward: ``wkv6_bwd`` on fp32 cotangents of y and of the final state,
  then the batch sum of ``du_part`` and the casts to the inputs' dtypes.

On CUDA tensors both directions launch the kernels; on CPU tensors both
run their plain versions.  Where nothing needs a gradient (prefill), the
forward runs without carries, as the reference's primal does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import chunk_padding
from repro_torch.kernels.rwkv6.kernel import wkv6_bwd, wkv6_fwd


class WKV6(torch.autograd.Function):
    """Chunked WKV-6 with the hand-written reverse chunk scan."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, chunk: int):
        y, state, carries = wkv6_fwd(r, k, v, log_w, u, chunk=chunk,
                                     return_carries=True)
        ctx.save_for_backward(r, k, v, log_w, u, carries)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, log_w, u, carries = ctx.saved_tensors
        dr, dk, dv, dlw, du_part = wkv6_bwd(
            r, k, v, log_w, u, carries, dy.float().contiguous(),
            dstate.float().contiguous(), chunk=ctx.chunk)
        return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
                dlw.to(log_w.dtype), du_part.sum(dim=0).to(u.dtype), None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         log_w: torch.Tensor, u: torch.Tensor, *, chunk: int = 32):
    """r/k/v/log_w (B, H, S, D), u (H, D) -> (y (B, H, S, D), final state
    (B, H, D, D) fp32).  Differentiable: ``torch.autograd`` routes through
    the backward kernel."""
    s = r.shape[2]
    chunk, pad = chunk_padding(s, chunk)
    r, k, v, log_w = (F.pad(t, (0, 0, 0, pad)) if pad else t.contiguous()
                      for t in (r, k, v, log_w))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, log_w, u)):
        y, state = WKV6.apply(r, k, v, log_w, u, chunk)
    else:
        y, state = wkv6_fwd(r, k, v, log_w, u, chunk=chunk)
    return (y[:, :, :s] if pad else y), state
