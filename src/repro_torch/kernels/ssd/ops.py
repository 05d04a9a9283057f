"""Differentiable wrapper of the SSD kernels (``repro/kernels/ssd/ops.py``).

``ssd`` pads the sequence to a chunk multiple outside the autograd
Function (dt = 0 pad steps decay by exp(0) = 1 and inject nothing, so the
final state is unchanged) and slices the padded rows off y.  ``SSD`` is
the counterpart of the reference's ``jax.custom_vjp`` (``ops.py:38-63``),
used on both devices:

* forward: ``ssd_fwd`` with the per-chunk entry states; saves ``(x, dt,
  a_coef, b_in, c_in, carries)``;
* backward: ``ssd_bwd`` on fp32 cotangents of y and of the final state,
  then, outside the kernel as in the reference (``ops.py:57-60``), dA =
  sum_{b,s} dt * dlog per head and the sums of the per-head dB and dC over
  H, and the casts to the inputs' dtypes.

On CUDA tensors both directions launch the kernels; on CPU tensors both
run their plain versions.  Where nothing needs a gradient (prefill), the
forward runs without carries, as the reference's primal does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import chunk_padding
from repro_torch.kernels.ssd.kernel import ssd_bwd, ssd_fwd


class SSD(torch.autograd.Function):
    """Chunked SSD with the hand-written reverse chunk scan."""

    @staticmethod
    def forward(ctx, x, dt, a_coef, b_in, c_in, chunk: int):
        y, state, carries = ssd_fwd(x, dt, a_coef, b_in, c_in, chunk=chunk,
                                    return_carries=True)
        ctx.save_for_backward(x, dt, a_coef, b_in, c_in, carries)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a_coef, b_in, c_in, carries = ctx.saved_tensors
        dx, ddt, dlog, db_h, dc_h = ssd_bwd(
            x, dt, a_coef, b_in, c_in, carries, dy.float().contiguous(),
            dstate.float().contiguous(), chunk=ctx.chunk)
        da = torch.einsum("bhs,bhs->h", dt.float(), dlog)
        return (dx.to(x.dtype), ddt.to(dt.dtype), da.to(a_coef.dtype),
                db_h.sum(dim=1).to(b_in.dtype), dc_h.sum(dim=1).to(c_in.dtype),
                None)


def ssd(x: torch.Tensor, dt: torch.Tensor, a_coef: torch.Tensor,
        b_in: torch.Tensor, c_in: torch.Tensor, *, chunk: int = 128):
    """x (B, H, S, P), dt (B, H, S), a_coef (H,), b_in/c_in (B, S, N) ->
    (y (B, H, S, P), final state (B, H, N, P) fp32).  Differentiable:
    ``torch.autograd`` routes through the backward kernel."""
    s = x.shape[2]
    chunk, pad = chunk_padding(s, chunk)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        dt = F.pad(dt, (0, pad))
        b_in, c_in = (F.pad(t, (0, 0, 0, pad)) for t in (b_in, c_in))
    x, dt, b_in, c_in = (t.contiguous() for t in (x, dt, b_in, c_in))
    a_coef = a_coef.contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a_coef, b_in, c_in)):
        y, state = SSD.apply(x, dt, a_coef, b_in, c_in, chunk)
    else:
        y, state = ssd_fwd(x, dt, a_coef, b_in, c_in, chunk=chunk)
    return (y[:, :, :s] if pad else y), state
