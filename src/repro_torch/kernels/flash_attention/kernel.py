"""ctypes wrappers of ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``, with their plain versions.

Replaces ``flash_attention_fwd`` (lines 96-190) and ``flash_attention_bwd``
(lines 197-375) of ``repro/kernels/flash_attention/kernel.py``.  Same
contract: q, k, v (BH, S, D) -> o (BH, S, D) in the input dtype and lse
(BH, S) fp32, causal, keys at or past ``valid_len`` masked (0 = none); the
backward takes (q, k, v, o, lse, dO) and returns (dq, dk, dv) in the input
dtypes.  The backward is three kernels, one per TPU ``pallas_call``, each
with its own wrapper and ``launches`` count.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import note_cost, on_card
from repro_torch.kernels._build import check, library

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _pairs(s: int, causal: bool) -> int:
    """(query, key) pairs one head computes: the lower triangle if
    causal."""
    return s * (s + 1) // 2 if causal else s * s


def _bytes(*ts: torch.Tensor) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   valid_len: int):
    """fp32 scores q k^T / sqrt(D) over the whole (S, S) square, NEG_INF
    where masked, and the (S, S) mask of valid (query, key) pairs."""
    s, d = q.shape[1], q.shape[2]
    valid_len = valid_len or s
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    col = torch.arange(s, device=q.device)
    valid = (col < valid_len)[None, :].expand(s, s)
    if causal:
        valid = valid & (col[None, :] <= col[:, None])
    return scores.masked_fill(~valid, NEG_INF), valid


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              valid_len: int = 0):
    """The kernel's function in plain PyTorch: fp32 scores over the whole
    (S, S) square, invalid columns contributing p = 0, lse = m + log(l)."""
    scores, valid = _masked_scores(q, k, causal, valid_len)
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
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start 16-byte aligned (the kernels "
                         "copy tiles 16 bytes at a time)")
    if q.shape[0] > 65535 or q.shape[1] < 1:
        raise ValueError(f"BH must be <= 65535 and S >= 1, got {tuple(q.shape)}")
    if not 0 <= valid_len <= q.shape[1]:
        raise ValueError(f"valid_len {valid_len} outside [0, {q.shape[1]}]")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


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
    check(_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse.data_ptr(), bh, s, d, int(causal), valid_len,
                   DTYPE_CODES[q.dtype], _stream(q)), "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    note_cost("flash_attention_fwd", 4.0 * bh * _pairs(s, causal) * d,
              _bytes(q, k, v, o, lse))
    return o, lse


flash_attention_fwd.launches = 0


# ---------------------------------------------------------------------------
# backward: three kernels (``kernel.py:197-375`` of the reference)
# ---------------------------------------------------------------------------

def flash_attention_bwd_preprocess_plain(o: torch.Tensor,
                                         do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O), fp32 (BH, S)."""
    return (o.float() * do.float()).sum(dim=-1)


def _probs_plain(q, k, lse, causal, valid_len):
    """P = exp(S / sqrt(D) - lse) over the (S, S) square, 0 where masked."""
    scores, valid = _masked_scores(q, k, causal, valid_len)
    return torch.where(valid, torch.exp(scores - lse[..., None]), 0.0)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, *,
                                 causal: bool = True, valid_len: int = 0):
    """dQ = (P * (dO V^T - delta)) K / sqrt(D), in q's dtype."""
    p = _probs_plain(q, k, lse, causal, valid_len)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float()) / math.sqrt(q.shape[2])
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, *,
                                  causal: bool = True, valid_len: int = 0):
    """(dK = (P * (dO V^T - delta))^T Q / sqrt(D), dV = P^T dO)."""
    p = _probs_plain(q, k, lse, causal, valid_len)
    dof = do.float()
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    ds = p * (torch.einsum("bqd,bkd->bqk", dof, v.float()) - delta[..., None])
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) / math.sqrt(q.shape[2])
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              valid_len: int = 0):
    """The backward's function in plain PyTorch, fp32 inside: (dq, dk, dv)."""
    delta = flash_attention_bwd_preprocess_plain(o, do)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal,
                                      valid_len=valid_len)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                           causal=causal, valid_len=valid_len)
    return dq, dk, dv


@functools.cache
def _bwd_entries():
    lib = library("flash_attention_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_preprocess.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.flash_attention_bwd_dq.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
    lib.flash_attention_bwd_dkv.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    for fn in (lib.flash_attention_bwd_preprocess, lib.flash_attention_bwd_dq,
               lib.flash_attention_bwd_dkv):
        fn.restype = ctypes.c_int
    return lib


def _check_rows(ref: torch.Tensor, **rows: torch.Tensor) -> None:
    """lse / delta: (BH, S) fp32, contiguous, on ref's device."""
    for name, t in rows.items():
        if (t.shape != ref.shape[:2] or t.dtype != torch.float32
                or t.device != ref.device or not t.is_contiguous()):
            raise ValueError(f"want {name} ({ref.shape[0]}, {ref.shape[1]}) "
                             f"float32 contiguous on {ref.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def flash_attention_bwd_preprocess(o: torch.Tensor,
                                   do: torch.Tensor) -> torch.Tensor:
    """delta (BH, S) fp32 (kernel 1 of the backward, ``pallas_call`` at
    ``kernel.py:310``)."""
    if not on_card(o):
        return flash_attention_bwd_preprocess_plain(o, do)
    _check(o, do, do, 0)
    bh, s, d = o.shape
    delta = torch.empty((bh, s), dtype=torch.float32, device=o.device)
    check(_bwd_entries().flash_attention_bwd_preprocess(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), bh, s, d,
        DTYPE_CODES[o.dtype], _stream(o)), "flash_attention_bwd_preprocess")
    flash_attention_bwd_preprocess.launches += 1
    note_cost("flash_attention_bwd_preprocess", 2.0 * bh * s * d,
              _bytes(o, do, delta))
    return delta


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           valid_len: int = 0) -> torch.Tensor:
    """dq like q (kernel 2, ``pallas_call`` at ``kernel.py:326``)."""
    if not on_card(q):
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                            causal=causal, valid_len=valid_len)
    _check(q, k, v, valid_len)
    _check(q, do, do, valid_len)
    _check_rows(q, lse=lse, delta=delta)
    bh, s, d = q.shape
    dq = torch.empty_like(q)
    check(_bwd_entries().flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, d,
        int(causal), valid_len, DTYPE_CODES[q.dtype], _stream(q)),
        "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    note_cost("flash_attention_bwd_dq", 6.0 * bh * _pairs(s, causal) * d,
              _bytes(q, k, v, do, lse, delta, dq))
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            valid_len: int = 0):
    """(dk like k, dv like v) (kernel 3, ``pallas_call`` at
    ``kernel.py:348``)."""
    if not on_card(q):
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                             causal=causal,
                                             valid_len=valid_len)
    _check(q, k, v, valid_len)
    _check(q, do, do, valid_len)
    _check_rows(q, lse=lse, delta=delta)
    bh, s, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    check(_bwd_entries().flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, s,
        d, int(causal), valid_len, DTYPE_CODES[q.dtype], _stream(q)),
        "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    note_cost("flash_attention_bwd_dkv", 8.0 * bh * _pairs(s, causal) * d,
              _bytes(q, k, v, do, lse, delta, dk, dv))
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, valid_len: int = 0):
    """(dq, dk, dv) in the input dtypes, from the forward's o and lse and the
    output cotangent do, all (BH, S, D) but lse (BH, S) fp32.  Runs the three
    kernels in turn (each counts its own launches); on CPU tensors each runs
    its plain version."""
    delta = flash_attention_bwd_preprocess(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                valid_len=valid_len)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                                     valid_len=valid_len)
    return dq, dk, dv


flash_attention_bwd_preprocess.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
