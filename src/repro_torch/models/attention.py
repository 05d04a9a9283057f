"""GQA attention: prefill through flash or blockwise, cached decode
(``repro/models/attention.py:33-312``, dense and per-slot paths).

Backends (see ``repro_torch.kernels``): ``attn_backend`` "flash" runs the
CUDA flash-attention kernel on CUDA tensors, "blockwise" the plain online
softmax scan; ``decode_backend`` "kernel" runs the CUDA split-KV decode
kernel for single-token steps, "reference" the plain masked softmax over
the whole cache.  On CPU tensors the kernel backends run the kernels'
plain versions.  Rotary positions are not ported yet: the served presets
use learned positions.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ATTN_BACKENDS, DECODE_BACKENDS, wants_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.models.layers import ParamDef, rms_norm

NEG_INF = -1e30


def attention_def(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """Weights in the reference layout: wq/wk/wv (d, heads, hd), wo (h, hd, d)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = 1.0 / math.sqrt(d)
    defs = {"wq": ParamDef((d, h, hd), "normal", s),
            "wk": ParamDef((d, kv, hd), "normal", s),
            "wv": ParamDef((d, kv, hd), "normal", s),
            "wo": ParamDef((h, hd, d), "normal", 1.0 / math.sqrt(h * hd))}
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, hd), "zeros")
        defs["bk"] = ParamDef((kv, hd), "zeros")
        defs["bv"] = ParamDef((kv, hd), "zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), "ones")
        defs["k_norm"] = ParamDef((hd,), "ones")
    return defs


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig):
    if cfg.pos_emb == "rope":
        raise NotImplementedError("rotary positions are not ported yet")
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, block_kv: int = 512,
                        q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV blocks (``attention.py:62-131``).

    q (B, Sq, H, D); k, v (B, Sk, KV, D) with H = KV * G.  Block size: the
    largest divisor of Sk in (block_kv/2, block_kv], else block_kv with the
    tail padded and masked.
    """
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    block_kv = min(block_kv, sk)
    block_kv = next((c for c in range(block_kv, block_kv // 2, -1)
                     if sk % c == 0), block_kv)
    pad = (-sk) % block_kv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    n_blocks = (sk + pad) // block_kv
    qg = q.reshape(b, sq, kvh, g, d) * (1.0 / math.sqrt(d))
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, sq, d), dtype=torch.float32, device=q.device)
    for blk in range(n_blocks):
        kc = k[:, blk * block_kv:(blk + 1) * block_kv]
        vc = v[:, blk * block_kv:(blk + 1) * block_kv]
        s = torch.einsum("bqkgd,bjkd->bkgqj", qg, kc).float()
        k_pos = blk * block_kv + torch.arange(block_kv, device=q.device)
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
            if pad:
                mask = mask & (k_pos < sk)[None, :]
            s = s.masked_fill(~mask, NEG_INF)
        elif pad:
            s = s.masked_fill(~(k_pos < sk), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqj,bjkd->bkgqd", p.to(vc.dtype), vc).float()
        m = m_new
    out = acc / l[..., None].clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def _context(q, k, v, cfg: ModelConfig, block_kv: int) -> torch.Tensor:
    if wants_kernel(cfg.attn_backend, "attn_backend", ATTN_BACKENDS):
        return flash_attention(q, k, v, causal=True)
    return blockwise_attention(q, k, v, causal=True, block_kv=block_kv)


def full_attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig, block_kv: int = 512
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention over the whole sequence -> (out, (k, v))."""
    q, k, v = _project_qkv(params, x, cfg)
    ctx = _context(q, k, v, cfg, block_kv)
    return torch.einsum("bshk,hkd->bsd", ctx, params["wo"]), (k, v)


def _write_cache(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 active: Optional[torch.Tensor]) -> None:
    """Write ``new`` (B, s_q, KV, D) into ``cache`` (B, S_max, KV, D) in place.

    Per-slot single token (``attention.py:248-259``): rows that are inactive
    or at/past capacity keep their old contents (the reference drops them
    with an out-of-bounds scatter; torch has no drop mode, so the row is
    masked).  Per-slot multi-token replay (``:260-269``) writes row b at
    pos[b]..; scalar pos (``:270-274``) writes every row at pos..  Start
    indices clamp so the update fits, as ``dynamic_update_slice`` does.
    """
    b, s_q = new.shape[:2]
    s_max = cache.shape[1]
    rows = torch.arange(b, device=cache.device)
    if pos.dim() == 1 and s_q == 1:
        ok = pos < s_max
        if active is not None:
            ok = ok & active
        idx = pos.clamp_max(s_max - 1)
        keep = cache[rows, idx]
        cache[rows, idx] = torch.where(ok[:, None, None],
                                       new[:, 0].to(cache.dtype), keep)
        return
    start = pos.clamp(0, s_max - s_q)
    idx = start.reshape(-1, 1) + torch.arange(s_q, device=cache.device)
    if pos.dim() == 1:
        cache[rows[:, None], idx] = new.to(cache.dtype)
    else:
        cache[:, idx[0]] = new.to(cache.dtype)


def decode_attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
                     cfg: ModelConfig, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     active: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode ``x`` (B, s_q, d) against a dense (B, S_max, KV, D) cache.

    ``pos`` is a 0-dim tensor (every row at one position) or a (B,) vector
    (each slot at its own depth).  The new k/v are written into the cache
    tensors in place (the reference donates the buffer) and the same
    tensors are returned.  Mask convention: after the write a row at
    position p has p + 1 valid entries, and cache row j attends iff
    j < p + 1 (``attention.py:283-284``).
    """
    b, s_q = x.shape[0], x.shape[1]
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kvh
    per_slot = pos.dim() == 1
    q, k, v = _project_qkv(params, x, cfg)
    _write_cache(cache_k, k, pos, active)
    _write_cache(cache_v, v, pos, active)

    use_kernel = wants_kernel(cfg.decode_backend, "decode_backend",
                              DECODE_BACKENDS)
    if use_kernel and s_q == 1:
        lengths = (pos + 1 if per_slot else (pos + 1).expand(b))
        ctx = flash_decode(q[:, 0], cache_k, cache_v,
                           lengths.to(torch.int32).contiguous())[:, None]
    else:
        s_max = cache_k.shape[1]
        qg = q.reshape(b, s_q, kvh, g, d) * (1.0 / math.sqrt(d))
        s = torch.einsum("bqkgd,bjkd->bkgqj", qg, cache_k).float()
        offs = torch.arange(s_q, device=x.device)
        counts = (pos[:, None] + offs[None, :] if per_slot
                  else (pos + offs)[None, :]) + 1  # valid-entry counts
        valid = (torch.arange(s_max, device=x.device)[None, None, :]
                 < counts[:, :, None])  # (B or 1, s_q, S_max)
        s = s.masked_fill(~valid[:, None, None], NEG_INF)
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bkgqj,bjkd->bkgqd", p.to(cache_v.dtype), cache_v)
        ctx = ctx.permute(0, 3, 1, 2, 4).reshape(b, s_q, h, d)
    out = torch.einsum("bshk,hkd->bsd", ctx, params["wo"])
    return out, cache_k, cache_v
