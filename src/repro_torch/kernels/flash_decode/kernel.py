"""ctypes wrapper of ``csrc/flash_decode.cu`` and its plain version.

Replaces ``flash_decode_fwd`` of ``repro/kernels/flash_decode/kernel.py``
(lines 41-134).  Same contract: q (B, KV, G, D), caches (B, S, KV, D),
lengths (B,) int32 counts of valid entries -> fp32 partials
``(o (B, KV, G, D) unnormalized, m (B, KV, G), l (B, KV, G))``.  The caches
may be strided views (the model passes one layer of its stacked cache);
only their last dim must be contiguous.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
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
GROUP_SIZES = (1, 2, 4, 8)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_decode_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor):
    """The kernel's function in plain PyTorch: fp32 scores over the whole
    cache, columns at or past ``lengths[b]`` contributing p = 0."""
    b, kvh, g, d = q.shape
    s = k.shape[1]
    scores = torch.einsum("bkgd,bjkd->bkgj", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.long()[:, None])[:, None, None, :]
    scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    o = torch.einsum("bkgj,bjkd->bkgd", p, v.float())
    return o, m, p.sum(dim=-1)


@functools.cache
def _lib():
    lib = library("flash_decode")
    fn = lib.flash_decode_fwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_decode_chunk.argtypes = []
    lib.flash_decode_chunk.restype = ctypes.c_int
    return fn, lib.flash_decode_chunk()


def _check(q, k, v, lengths):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, KV, G, D) and caches (B, S, KV, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, kvh, g, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, kvh, d):
        raise ValueError(f"cache {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"want float32 or bfloat16 q and caches of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS or g not in GROUP_SIZES:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS} or group {g} not in "
                         f"{GROUP_SIZES}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError(f"want lengths (B,) int32, got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    if any(t.device != q.device for t in (k, v, lengths)):
        raise ValueError("q, caches and lengths on different devices")
    if not (q.is_contiguous() and lengths.is_contiguous()
            and k.stride(3) == 1 and v.stride(3) == 1):
        raise ValueError("q and lengths must be contiguous and the caches "
                         "contiguous along D")
    if b > 65535 or kvh > 65535 or k.shape[1] < 1:
        raise ValueError(f"B and KV must be <= 65535 and S >= 1, got "
                         f"{tuple(k.shape)}")


def flash_decode_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor):
    """fp32 partials ``(o, m, l)``.  ``launches`` counts the CUDA launches
    this wrapper made (one per call: split pass plus merge)."""
    if not on_card(q):
        return flash_decode_fwd_plain(q, k, v, lengths)
    _check(q, k, v, lengths)
    fn, chunk = _lib()
    b, kvh, g, d = q.shape
    s = k.shape[1]
    n_splits = -(-s // chunk)
    f32 = dict(dtype=torch.float32, device=q.device)
    po = torch.empty((b, kvh, n_splits, g, d), **f32)
    pm = torch.empty((b, kvh, n_splits, g), **f32)
    pl = torch.empty((b, kvh, n_splits, g), **f32)
    o = torch.empty((b, kvh, g, d), **f32)
    m = torch.empty((b, kvh, g), **f32)
    l = torch.empty((b, kvh, g), **f32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             po.data_ptr(), pm.data_ptr(), pl.data_ptr(), o.data_ptr(),
             m.data_ptr(), l.data_ptr(), b, s, kvh, g, d,
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             DTYPE_CODES[q.dtype], stream), "flash_decode_fwd")
    flash_decode_fwd.launches += 1
    return o, m, l


flash_decode_fwd.launches = 0
