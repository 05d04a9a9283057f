"""ctypes wrappers of ``csrc/flash_decode.cu`` and their plain versions.

Replace ``flash_decode_fwd`` (lines 41-134) and ``flash_decode_paged_fwd``
(lines 142-257) of ``repro/kernels/flash_decode/kernel.py``.  Same
contracts: q (B, KV, G, D); dense caches (B, S, KV, D), or paged pools
(n_pages, page_size, KV, D) with a (B, max_pages) int32 page table
(-1 = unowned); lengths (B,) int32 counts of valid entries -> fp32
partials ``(o (B, KV, G, D) unnormalized, m (B, KV, G), l (B, KV, G))``.
Caches and pools may be strided views (the model passes one layer of its
stacked cache); their last dim must be contiguous, and on the card they
start 16-byte aligned with strides of 16-byte multiples (the kernels load
16 bytes at a time).  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel (one launch a call: a thread-block cluster a (slot,
kv head) merges its blocks' partials itself) or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels._build import check, library

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 128)
GROUP_SIZES = (1, 2, 3, 4, 6, 8)
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
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    paged = lib.flash_decode_paged_fwd
    paged.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                      + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_void_p])
    paged.restype = ctypes.c_int
    return fn, paged


def _check(q, k, v, lengths):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, KV, G, D) and caches (B, S, KV, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, kvh, g, d = q.shape
    if (k.shape[2], k.shape[3]) != (kvh, d):
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
    elt = q.element_size()
    if (any(t.data_ptr() % 16 for t in (q, k, v))
            or any(t.stride(i) * elt % 16 for t in (k, v) for i in range(3))):
        raise ValueError("q and the caches must start 16-byte aligned and the "
                         "caches' strides be multiples of 16 bytes (the "
                         "kernels load 16 bytes at a time)")


def _outputs(q: torch.Tensor):
    """fp32 outputs (o, m, l)."""
    b, kvh, g, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty((b, kvh, g, d), **f32),
            torch.empty((b, kvh, g), **f32),
            torch.empty((b, kvh, g), **f32))


def flash_decode_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor):
    """fp32 partials ``(o, m, l)``.  ``launches`` counts the CUDA launches
    this wrapper made (one per call)."""
    if not on_card(q):
        return flash_decode_fwd_plain(q, k, v, lengths)
    _check(q, k, v, lengths)
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    fn, _ = _lib()
    b, kvh, g, d = q.shape
    o, m, l = _outputs(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             o.data_ptr(), m.data_ptr(), l.data_ptr(), b, k.shape[1], kvh, g,
             d, k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             DTYPE_CODES[q.dtype], stream), "flash_decode_fwd")
    flash_decode_fwd.launches += 1
    return o, m, l


flash_decode_fwd.launches = 0


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Densify a paged cache (``repro/kernels/flash_decode/ref.py:56-70``):
    pool (n_pages, page_size, ...) and table (B, max_pages) -> per-slot rows
    (B, max_pages * page_size, ...), unowned (-1) pages zeroed."""
    b, max_pages = page_table.shape
    pages = pool[page_table.long().clamp_min(0)]  # (B, max_pages, ps, ...)
    owned = (page_table >= 0).reshape((b, max_pages) + (1,) * (pool.dim() - 1))
    pages = torch.where(owned, pages, torch.zeros((), dtype=pool.dtype,
                                                  device=pool.device))
    return pages.reshape((b, max_pages * pool.shape[1]) + pool.shape[2:])


def flash_decode_paged_fwd_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 page_table: torch.Tensor,
                                 lengths: torch.Tensor):
    """The paged kernel's function in plain PyTorch: gather the pages
    (unowned ones zeroed), then the dense plain version.  An unowned page
    inside ``lengths[b]`` thus holds zero keys and values, here and in the
    CUDA kernel; the TPU kernel skips it instead, which differs only on
    such rows (the engine's inactive slots, whose output nobody reads)."""
    return flash_decode_fwd_plain(q, gather_pages(k_pool, page_table),
                                  gather_pages(v_pool, page_table), lengths)


def flash_decode_paged_fwd(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor):
    """fp32 partials ``(o, m, l)`` over the pools through ``page_table``.
    Page ids must lie below n_pages (the kernel trusts them, as the
    reference's index map does).  ``launches`` counts the CUDA launches
    this wrapper made (one per call)."""
    if not on_card(q):
        return flash_decode_paged_fwd_plain(q, k_pool, v_pool, page_table,
                                            lengths)
    _check(q, k_pool, v_pool, lengths)
    b = q.shape[0]
    page_size = k_pool.shape[1]
    if (page_table.dim() != 2 or page_table.shape[0] != b
            or page_table.shape[1] < 1 or page_table.dtype != torch.int32
            or not page_table.is_contiguous()
            or page_table.device != q.device):
        raise ValueError(f"want a contiguous (B, max_pages) int32 page table "
                         f"on {q.device}, got {page_table.dtype} "
                         f"{tuple(page_table.shape)} on {page_table.device}")
    max_pages = page_table.shape[1]
    if max_pages * page_size >= 2 ** 31:
        raise ValueError(f"max_pages {max_pages} x page_size {page_size} "
                         f"overflows int32")
    _, fn = _lib()
    kvh, g, d = q.shape[1:]
    o, m, l = _outputs(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    check(fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), o.data_ptr(),
             m.data_ptr(), l.data_ptr(), b, max_pages, page_size, kvh, g, d,
             k_pool.stride(0), k_pool.stride(1), k_pool.stride(2),
             v_pool.stride(0), v_pool.stride(1), v_pool.stride(2),
             DTYPE_CODES[q.dtype], stream), "flash_decode_paged_fwd")
    flash_decode_paged_fwd.launches += 1
    return o, m, l


flash_decode_paged_fwd.launches = 0
