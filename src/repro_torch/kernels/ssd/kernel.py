"""ctypes wrappers of ``csrc/ssd.cu`` and their plain versions.

Replace ``ssd_fwd`` (lines 35-111) and ``ssd_bwd`` (lines 138-274) of
``repro/kernels/ssd/kernel.py``.  Same contracts, in the (B, H, S, P)
layout with S a multiple of ``chunk``:

* forward: x (B, H, S, P) fp32 or bf16, dt (B, H, S) fp32, a_coef (H,)
  fp32 (negative), b_in, c_in (B, S, N) in x's dtype, shared by the heads
  -> y (B, H, S, P) in x's dtype and the final state (B, H, N, P) fp32;
  with ``return_carries`` also the states entering each chunk,
  (B, H, nc, N, P) fp32 (the backward's residual);
* backward: those inputs plus the carries and the fp32 cotangents dy
  (B, H, S, P) and dstate (B, H, N, P) -> fp32 dx (B, H, S, P), ddt and
  dlog (B, H, S), and the per-head db_h, dc_h (B, H, S, N), which the
  caller sums over H (and dA = sum_{b,s} dt * dlog).

Every exponent is of a difference of cumulative log-decays, <= 0, never
factored, so nothing overflows however fast the decay.  A CPU tensor takes
the plain version; a CUDA tensor launches the kernels or raises.

On the card each direction is three CUDA launches (``csrc/ssd.cu``):
chunk-local states, the state passing across chunks, and the chunk-parallel
outputs.  The wrappers allocate their scratch: the chunk-local states,
which the passing turns into the states entering each chunk in place (the
carries themselves where the caller asked for them) or into the cotangents
leaving each chunk, (B, H, nc, N, P) fp32, and exp(cum_Q) per chunk.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import check_f32, on_card, stream_of
from repro_torch.kernels._build import check, library

NEG_INF = -1e30
STATE_DIMS = (64,)  # N and P the kernels take
MAX_CHUNK = 128
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _chunked(x, dt, b_in, c_in, chunk: int):
    """fp32 views: x (B, H, nc, Q, P), dt (B, H, nc, Q), B/C (B, nc, Q, N)."""
    b, h, s, p = x.shape
    nc, n = s // chunk, b_in.shape[-1]
    return (x.float().reshape(b, h, nc, chunk, p),
            dt.float().reshape(b, h, nc, chunk),
            b_in.float().reshape(b, nc, chunk, n),
            c_in.float().reshape(b, nc, chunk, n))


def _geometry(dtq: torch.Tensor, a: torch.Tensor):
    """Decay geometry of one chunk of steps dt (B, H, Q): the inclusive
    cumulative log-decay cum, exp(cum), exp(cum_last - cum) and the causal
    pairwise decay exp(cum_i - cum_j), j <= i, else 0 (B, H, Q, Q)."""
    q = dtq.shape[-1]
    cum = (dtq * a).cumsum(dim=-1)
    causal = torch.ones(q, q, dtype=torch.bool, device=dtq.device).tril()
    gap = cum[..., :, None] - cum[..., None, :]
    decay = torch.exp(gap.masked_fill(~causal, NEG_INF))
    return cum, torch.exp(cum), torch.exp(cum[..., -1:] - cum), decay


def ssd_fwd_plain(x: torch.Tensor, dt: torch.Tensor, a_coef: torch.Tensor,
                  b_in: torch.Tensor, c_in: torch.Tensor, *, chunk: int = 128,
                  return_carries: bool = False):
    """The forward kernel's function in plain PyTorch (fp32 inside), chunk
    by chunk as ``_ssd_kernel`` (``kernel.py:35-86``).  Differentiable by
    autograd: the model's "reference" backend is this function."""
    b, h, s, p = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk {chunk}")
    xc, dtc, bc, cc = _chunked(x, dt, b_in, c_in, chunk)
    a = a_coef.float()[None, :, None]
    state = torch.zeros(b, h, b_in.shape[-1], p, dtype=torch.float32,
                        device=x.device)
    ys, carries = [], []
    for c in range(s // chunk):
        dtq, bq, cq = dtc[:, :, c], bc[:, c, None], cc[:, c, None]
        _, e, f, decay = _geometry(dtq, a)
        xdt = xc[:, :, c] * dtq[..., None]
        y = ((cq @ bq.transpose(-1, -2)) * decay) @ xdt
        carries.append(state)
        y = y + e[..., None] * (cq @ state)
        state = (e[..., -1:, None] * state
                 + (bq * f[..., None]).transpose(-1, -2) @ xdt)
        ys.append(y)
    y = torch.cat(ys, dim=2).to(x.dtype)
    if return_carries:
        return y, state, torch.stack(carries, dim=2)
    return y, state


def ssd_bwd_plain(x, dt, a_coef, b_in, c_in, carries, dy, dstate, *,
                  chunk: int):
    """The backward kernel's function in plain PyTorch: the reverse chunk
    scan of ``_ssd_bwd_kernel`` (``kernel.py:138-206``), the (N, P) state
    cotangent seeded from ``dstate``.  Returns fp32 (dx, ddt, dlog, db_h,
    dc_h)."""
    b, h, s, p = x.shape
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk {chunk}")
    xc, dtc, bc, cc = _chunked(x, dt, b_in, c_in, chunk)
    dyc = dy.float().reshape(xc.shape)
    a = a_coef.float()[None, :, None]
    g = dstate.float()
    outs = []
    for c in reversed(range(s // chunk)):
        dtq, bq, cq, dyq = dtc[:, :, c], bc[:, c, None], cc[:, c, None], \
            dyc[:, :, c]
        xq = xc[:, :, c]
        state = carries[:, :, c].float()
        _, e, f, decay = _geometry(dtq, a)
        alpha = e[..., -1]
        xdt = xq * dtq[..., None]
        scores = cq @ bq.transpose(-1, -2)                  # (B, 1, Q, Q)
        m = scores * decay
        dxdt = m.transpose(-1, -2) @ dyq + (f[..., None] * bq) @ g
        w = decay * (dyq @ xdt.transpose(-1, -2))
        dc = w @ bq + e[..., None] * (dyq @ state.transpose(-1, -2))
        db = w.transpose(-1, -2) @ cq + f[..., None] * (
            xdt @ g.transpose(-1, -2))
        # the cotangent of the inclusive cumulative log-decay: the pairwise
        # factors (t), the carried-state decay (t2), the decay to the
        # chunk's end (u) and, on the last row, the state's own decay
        t = scores * w
        u = f * ((bq @ g) * xdt).sum(dim=-1)
        t2 = e * ((cq @ state) * dyq).sum(dim=-1)
        dcum = t.sum(dim=-1) - t.sum(dim=-2) + t2 - u
        dcum[..., -1] += u.sum(dim=-1) + alpha * (state * g).sum(dim=(-1, -2))
        dlog = dcum.flip(-1).cumsum(dim=-1).flip(-1)        # suffix sums
        outs.append((dxdt * dtq[..., None],
                     a * dlog + (dxdt * xq).sum(dim=-1), dlog, db, dc))
        g = alpha[..., None, None] * g + (e[..., None] * cq).transpose(
            -1, -2) @ dyq
    return tuple(torch.cat([o[i] for o in reversed(outs)], dim=2)
                 for i in range(5))


@functools.cache
def _entries():
    lib = library("ssd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_fwd.argtypes = [ptr] * 9 + [i32] * 7 + [ptr]
    lib.ssd_bwd.argtypes = [ptr] * 15 + [i32] * 7 + [ptr]
    lib.ssd_fwd.restype = lib.ssd_bwd.restype = ctypes.c_int
    return lib


def _check(x, dt, a_coef, b_in, c_in, chunk):
    if x.dim() != 4:
        raise ValueError(f"want x (B, H, S, P), got {tuple(x.shape)}")
    b, h, s, p = x.shape
    if dt.shape != (b, h, s) or a_coef.shape != (h,):
        raise ValueError(f"want dt ({b}, {h}, {s}) and a_coef ({h},), got "
                         f"{tuple(dt.shape)}, {tuple(a_coef.shape)}")
    if b_in.dim() != 3 or b_in.shape[:2] != (b, s) or c_in.shape != b_in.shape:
        raise ValueError(f"want b_in, c_in ({b}, {s}, N), got "
                         f"{tuple(b_in.shape)}, {tuple(c_in.shape)}")
    if x.dtype not in DTYPE_CODES or b_in.dtype != x.dtype \
            or c_in.dtype != x.dtype:
        raise ValueError(f"want float32 or bfloat16 x, b_in, c_in of one "
                         f"dtype, got {x.dtype}, {b_in.dtype}, {c_in.dtype}")
    if dt.dtype != torch.float32 or a_coef.dtype != torch.float32:
        raise ValueError(f"want float32 dt and a_coef, got {dt.dtype}, "
                         f"{a_coef.dtype}")
    if p not in STATE_DIMS or b_in.shape[-1] not in STATE_DIMS:
        raise ValueError(f"head dim {p} and state {b_in.shape[-1]} must be "
                         f"in {STATE_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"want 1 <= chunk <= {MAX_CHUNK} dividing S={s}, "
                         f"got {chunk}")
    if any(t.device != x.device for t in (dt, a_coef, b_in, c_in)):
        raise ValueError("x, dt, a_coef, b_in, c_in on different devices")
    if not all(t.is_contiguous() for t in (x, dt, a_coef, b_in, c_in)):
        raise ValueError("x, dt, a_coef, b_in, c_in must be contiguous")
    if b * h >= 2 ** 31 or b * h * s * p >= 2 ** 62:
        raise ValueError(f"shape {tuple(x.shape)} too large")


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, a_coef: torch.Tensor,
            b_in: torch.Tensor, c_in: torch.Tensor, *, chunk: int = 128,
            return_carries: bool = False):
    """(y, final state[, carries]).  ``chunk`` is clamped to S, which must
    be a multiple of it.  ``launches`` counts the calls that went to the
    card, one a call (each makes three CUDA launches)."""
    if not on_card(x):
        return ssd_fwd_plain(x, dt, a_coef, b_in, c_in, chunk=chunk,
                             return_carries=return_carries)
    b, h, s, p = x.shape
    chunk = min(chunk, s)
    _check(x, dt, a_coef, b_in, c_in, chunk)
    n, nc = b_in.shape[-1], s // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    state = torch.empty((b, h, n, p), **f32)
    # the chunk-local states, turned in place into the carries
    states = torch.empty((b, h, nc, n, p), **f32)
    decay = torch.empty((b, h, nc), **f32)
    check(_entries().ssd_fwd(
        x.data_ptr(), dt.data_ptr(), a_coef.data_ptr(), b_in.data_ptr(),
        c_in.data_ptr(), y.data_ptr(), state.data_ptr(), states.data_ptr(),
        decay.data_ptr(), b, h, s, chunk, n, p, DTYPE_CODES[x.dtype],
        stream_of(x)), "ssd_fwd")
    ssd_fwd.launches += 1
    return (y, state, states) if return_carries else (y, state)


ssd_fwd.launches = 0


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, a_coef: torch.Tensor,
            b_in: torch.Tensor, c_in: torch.Tensor, carries: torch.Tensor,
            dy: torch.Tensor, dstate: torch.Tensor, *, chunk: int):
    """fp32 (dx, ddt, dlog, db_h, dc_h).  ``launches`` counts the calls
    that went to the card, one a call (each makes three CUDA launches)."""
    if not on_card(x):
        return ssd_bwd_plain(x, dt, a_coef, b_in, c_in, carries, dy, dstate,
                             chunk=chunk)
    _check(x, dt, a_coef, b_in, c_in, chunk)
    b, h, s, p = x.shape
    n = b_in.shape[-1]
    dev = x.device
    check_f32("carries", carries, (b, h, s // chunk, n, p), dev)
    check_f32("dy", dy, (b, h, s, p), dev)
    check_f32("dstate", dstate, (b, h, n, p), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, h, s, p), **f32)
    ddt, dlog = (torch.empty((b, h, s), **f32) for _ in range(2))
    db_h, dc_h = (torch.empty((b, h, s, n), **f32) for _ in range(2))
    # the chunk-local cotangents, turned in place into those of the states
    # leaving each chunk
    gbuf = torch.empty((b, h, s // chunk, n, p), **f32)
    decay = torch.empty((b, h, s // chunk), **f32)
    check(_entries().ssd_bwd(
        x.data_ptr(), dt.data_ptr(), a_coef.data_ptr(), b_in.data_ptr(),
        c_in.data_ptr(), carries.data_ptr(), dy.data_ptr(),
        dstate.data_ptr(), gbuf.data_ptr(), decay.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dlog.data_ptr(),
        db_h.data_ptr(), dc_h.data_ptr(), b, h, s, chunk, n, p,
        DTYPE_CODES[x.dtype], stream_of(x)), "ssd_bwd")
    ssd_bwd.launches += 1
    return dx, ddt, dlog, db_h, dc_h


ssd_bwd.launches = 0
