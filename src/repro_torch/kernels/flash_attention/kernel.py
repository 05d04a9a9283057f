"""ctypes wrapper of ``csrc/flash_attention_fwd.cu`` and its plain version.

Replaces ``flash_attention_fwd`` of ``repro/kernels/flash_attention/kernel.py``
(lines 96-190).  Same contract: q, k, v (BH, S, D) -> o (BH, S, D) in the
input dtype and lse (BH, S) fp32, causal, keys at or past ``valid_len``
masked (0 = none).  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels._build import check, library

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              valid_len: int = 0):
    """The kernel's function in plain PyTorch: fp32 scores over the whole
    (S, S) square, invalid columns contributing p = 0, lse = m + log(l)."""
    bh, s, d = q.shape
    valid_len = valid_len or s
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    col = torch.arange(s, device=q.device)
    valid = (col < valid_len)[None, :].expand(s, s)
    if causal:
        valid = valid & (col[None, :] <= col[:, None])
    scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


@functools.cache
def _entry():
    fn = library("flash_attention_fwd").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, valid_len):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"want q, k, v of one (BH, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"want float32 or bfloat16 q, k, v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[2]} not in {HEAD_DIMS}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if q.shape[0] > 65535 or q.shape[1] < 1:
        raise ValueError(f"BH must be <= 65535 and S >= 1, got {tuple(q.shape)}")
    if not 0 <= valid_len <= q.shape[1]:
        raise ValueError(f"valid_len {valid_len} outside [0, {q.shape[1]}]")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, valid_len: int = 0):
    """(o (BH, S, D) like q, lse (BH, S) fp32).  ``launches`` counts the
    CUDA launches this wrapper made."""
    if not on_card(q):
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         valid_len=valid_len)
    _check(q, k, v, valid_len)
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    check(_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse.data_ptr(), bh, s, d, int(causal), valid_len,
                   DTYPE_CODES[q.dtype], stream), "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
