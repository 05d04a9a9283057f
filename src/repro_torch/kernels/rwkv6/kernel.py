"""ctypes wrappers of ``csrc/wkv6.cu`` and their plain versions.

Replace ``wkv6_fwd`` (lines 31-123) and ``wkv6_bwd`` (lines 130-259) of
``repro/kernels/rwkv6/kernel.py``.  Same contracts, in the (B, H, S, D)
layout with S a multiple of ``chunk``:

* forward: r, k, v, log_w (B, H, S, D) fp32 or bf16 (log_w may be fp32
  beside bf16 r/k/v), u (H, D) -> y (B, H, S, D) in r's dtype and the
  final state (B, H, D, D) fp32; with ``return_carries`` also the states
  entering each chunk, (B, H, nc, D, D) fp32 (the backward's residual);
* backward: those inputs plus the carries and the fp32 cotangents dy
  (B, H, S, D) and dstate (B, H, D, D) -> fp32 dr, dk, dv, d_log_w
  (B, H, S, D) and du_part (B, H, D), which the caller sums over B.

Within a chunk the pairwise decay ``exp(cum_in[i] - cum[j])`` (j < i) is
taken from the difference of the cumulative log-decays, never factored:
the exponent is <= 0, so nothing overflows however fast the decay.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import check_f32, on_card, stream_of
from repro_torch.kernels._build import check, library

NEG_INF = -1e30
HEAD_DIMS = (64,)
MAX_CHUNK = 64
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _chunks(chunk: int, *xs: torch.Tensor):
    """fp32 (B, H, nc, Q, D) views of (B, H, S, D) tensors."""
    b, h, s, d = xs[0].shape
    return [x.float().reshape(b, h, s // chunk, chunk, d) for x in xs]


def _geometry(lq: torch.Tensor):
    """Decay geometry of one chunk of log-decays (B, H, Q, D): the
    inclusive and exclusive cumulative sums and the strictly causal
    pairwise decay w[i, j, d] = exp(cum_in[i, d] - cum[j, d]), j < i, else 0
    (B, H, Q, Q, D)."""
    q = lq.shape[2]
    cum = lq.cumsum(dim=2)
    cum_in = cum - lq
    strict = torch.ones(q, q, dtype=torch.bool, device=lq.device).tril(-1)
    gap = cum_in[:, :, :, None, :] - cum[:, :, None, :, :]
    w = torch.exp(gap.masked_fill(~strict[:, :, None], NEG_INF))
    return cum, cum_in, w


def wkv6_fwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_w: torch.Tensor, u: torch.Tensor, *, chunk: int = 32,
                   return_carries: bool = False):
    """The forward kernel's function in plain PyTorch (fp32 inside), chunk
    by chunk as ``_wkv6_kernel`` (``kernel.py:31-84``).  Differentiable by
    autograd: the model's "reference" backend is this function."""
    b, h, s, d = r.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk {chunk}")
    rc, kc, vc, lc = _chunks(chunk, r, k, v, log_w)
    uf = u.float()[None, :, None, :]
    state = torch.zeros(b, h, d, d, dtype=torch.float32, device=r.device)
    ys, carries = [], []
    for c in range(s // chunk):
        rq, kq, vq, lq = rc[:, :, c], kc[:, :, c], vc[:, :, c], lc[:, :, c]
        cum, cum_in, w = _geometry(lq)
        att = (rq[:, :, :, None, :] * w * kq[:, :, None, :, :]).sum(dim=-1)
        y = att @ vq + (rq * uf * kq).sum(dim=-1, keepdim=True) * vq
        carries.append(state)
        y = y + (rq * torch.exp(cum_in)) @ state
        k_end = kq * torch.exp(cum[:, :, -1:] - cum)
        state = (torch.exp(cum[:, :, -1])[..., None] * state
                 + k_end.transpose(-1, -2) @ vq)
        ys.append(y)
    y = torch.cat(ys, dim=2).to(r.dtype)
    if return_carries:
        return y, state, torch.stack(carries, dim=2)
    return y, state


def wkv6_bwd_plain(r, k, v, log_w, u, carries, dy, dstate, *, chunk: int):
    """The backward kernel's function in plain PyTorch: the reverse chunk
    scan of ``_wkv6_bwd_kernel`` (``kernel.py:130-214``), the (D, D) state
    cotangent seeded from ``dstate``.  Returns fp32 (dr, dk, dv, d_log_w,
    du_part)."""
    b, h, s, d = r.shape
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk {chunk}")
    rc, kc, vc, lc, dyc = _chunks(chunk, r, k, v, log_w, dy)
    uf = u.float()[None, :, None, :]
    g = dstate.float()
    du = torch.zeros(b, h, d, dtype=torch.float32, device=r.device)
    outs = []
    for c in reversed(range(s // chunk)):
        rq, kq, vq, lq, dyq = (t[:, :, c] for t in (rc, kc, vc, lc, dyc))
        state = carries[:, :, c].float()
        cum, cum_in, w = _geometry(lq)
        e_in = torch.exp(cum_in)
        alpha = torch.exp(cum[:, :, -1])                    # (B, H, D)
        f = torch.exp(cum[:, :, -1:] - cum)                 # (B, H, Q, D)
        p = dyq @ vq.transpose(-1, -2)                      # p[i, j] = dy_i.v_j
        diag_p = (dyq * vq).sum(dim=-1, keepdim=True)       # (B, H, Q, 1)
        att = (rq[:, :, :, None, :] * w * kq[:, :, None, :, :]).sum(dim=-1)
        bonus = (rq * uf * kq).sum(dim=-1, keepdim=True)
        dv = (att.transpose(-1, -2) @ dyq + bonus * dyq
              + (kq * f) @ g)
        dr_intra = (w * kq[:, :, None, :, :] * p[..., None]).sum(dim=3)
        dr_state = e_in * (dyq @ state.transpose(-1, -2))
        dk_intra = (w * rq[:, :, :, None, :] * p[..., None]).sum(dim=2)
        dk_state = f * (vq @ g.transpose(-1, -2))
        dr = dr_intra + dr_state + uf * kq * diag_p
        dk = dk_intra + dk_state + uf * rq * diag_p
        du = du + (rq * kq * diag_p).sum(dim=2)
        # the log-decay cotangent, through cum_in (pairwise rows, carried
        # state) and cum (pairwise columns, decay to the chunk's end, and on
        # the last row the state's own decay)
        dcum_in = rq * (dr_intra + dr_state)
        dcum = -(kq * (dk_intra + dk_state))
        last = ((kq * dk_state).sum(dim=2)
                + alpha * (state * g).sum(dim=-1))          # (B, H, D)
        dcum[:, :, -1] = dcum[:, :, -1] + last
        total = dcum + dcum_in
        rev = total.flip(2).cumsum(dim=2).flip(2)           # suffix sums
        outs.append((dr, dk, dv, rev - dcum_in))
        g = alpha[..., None] * g + (rq * e_in).transpose(-1, -2) @ dyq
    dr, dk, dv, dlw = (torch.cat([o[i] for o in reversed(outs)], dim=2)
                       for i in range(4))
    return dr, dk, dv, dlw, du


@functools.cache
def _entries():
    lib = library("wkv6")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_fwd.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    lib.wkv6_bwd.argtypes = [ptr] * 13 + [i32] * 6 + [ptr]
    lib.wkv6_fwd.restype = lib.wkv6_bwd.restype = ctypes.c_int
    return lib


def _check(r, k, v, log_w, u, chunk):
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, log_w)):
        raise ValueError(f"want r, k, v, log_w of one (B, H, S, D) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, log_w)]}")
    b, h, s, d = r.shape
    if r.dtype not in DTYPE_CODES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"want float32 or bfloat16 r, k, v of one dtype, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    if log_w.dtype not in (torch.float32, r.dtype):
        raise ValueError(f"want log_w float32 or {r.dtype}, got {log_w.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if u.shape != (h, d):
        raise ValueError(f"want u ({h}, {d}), got {tuple(u.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"want 1 <= chunk <= {MAX_CHUNK} dividing S={s}, got "
                         f"{chunk}")
    if any(t.device != r.device for t in (k, v, log_w, u)):
        raise ValueError("r, k, v, log_w, u on different devices")
    if not all(t.is_contiguous() for t in (r, k, v, log_w)):
        raise ValueError("r, k, v, log_w must be contiguous")
    if b * h >= 2 ** 31 or b * h * s * d >= 2 ** 62:
        raise ValueError(f"shape {tuple(r.shape)} too large")


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_w: torch.Tensor, u: torch.Tensor, *, chunk: int = 32,
             return_carries: bool = False):
    """(y, final state[, carries]).  ``chunk`` is clamped to S, which must
    be a multiple of it.  ``launches`` counts the CUDA launches this
    wrapper made."""
    if not on_card(r):
        return wkv6_fwd_plain(r, k, v, log_w, u, chunk=chunk,
                              return_carries=return_carries)
    b, h, s, d = r.shape
    chunk = min(chunk, s)
    _check(r, k, v, log_w, u, chunk)
    uf = u.float().contiguous()
    y = torch.empty_like(r)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    carries = (torch.empty((b, h, s // chunk, d, d), dtype=torch.float32,
                           device=r.device) if return_carries else None)
    check(_entries().wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        uf.data_ptr(), y.data_ptr(), state.data_ptr(),
        carries.data_ptr() if return_carries else None, b, h, s, chunk,
        DTYPE_CODES[r.dtype], DTYPE_CODES[log_w.dtype], stream_of(r)),
        "wkv6_fwd")
    wkv6_fwd.launches += 1
    return (y, state, carries) if return_carries else (y, state)


wkv6_fwd.launches = 0


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_w: torch.Tensor, u: torch.Tensor, carries: torch.Tensor,
             dy: torch.Tensor, dstate: torch.Tensor, *, chunk: int):
    """fp32 (dr, dk, dv, d_log_w, du_part).  ``launches`` counts the CUDA
    launches this wrapper made."""
    if not on_card(r):
        return wkv6_bwd_plain(r, k, v, log_w, u, carries, dy, dstate,
                              chunk=chunk)
    _check(r, k, v, log_w, u, chunk)
    b, h, s, d = r.shape
    dev = r.device
    check_f32("carries", carries, (b, h, s // chunk, d, d), dev)
    check_f32("dy", dy, (b, h, s, d), dev)
    check_f32("dstate", dstate, (b, h, d, d), dev)
    uf = u.float().contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dr, dk, dv, dlw = (torch.empty((b, h, s, d), **f32) for _ in range(4))
    du = torch.empty((b, h, d), **f32)
    check(_entries().wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        uf.data_ptr(), carries.data_ptr(), dy.data_ptr(), dstate.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(),
        du.data_ptr(), b, h, s, chunk, DTYPE_CODES[r.dtype],
        DTYPE_CODES[log_w.dtype], stream_of(r)), "wkv6_bwd")
    wkv6_bwd.launches += 1
    return dr, dk, dv, dlw, du


wkv6_bwd.launches = 0
