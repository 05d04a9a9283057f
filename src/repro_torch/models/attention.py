"""GQA attention: training and prefill through flash or blockwise, cached decode
(``repro/models/attention.py:33-312``: dense, per-slot and paged paths).

Backends (see ``repro_torch.kernels``): ``attn_backend`` "flash" runs the
CUDA flash-attention kernels on CUDA tensors, forward and backward, through
the ``torch.autograd.Function`` of ``kernels.flash_attention.ops``;
"blockwise" runs the plain online-softmax scan, which torch autograd
differentiates; ``decode_backend`` "kernel" runs the CUDA split-KV decode
kernel for single-token steps, "reference" the plain masked softmax over
the whole cache (a paged cache is gathered through its page table first;
the kernel walks the table itself).  On CPU tensors the kernel backends
run the kernels' plain versions.  With ``pos_emb="rope"`` q and k are
rotated at their positions (``attention.py:53-67``): (S,) in training and
prefill, per slot (B, s_q) in decode.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (grad_as_value, local_call,
                                              unflatten_last)
from repro_torch.kernels import ATTN_BACKENDS, DECODE_BACKENDS, wants_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.kernel import gather_pages
from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                  flash_decode_paged)
from repro_torch.models.layers import (ParamDef, apply_rope, rms_norm,
                                       rope_tables)

NEG_INF = -1e30


def attention_def(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """Weights in the reference layout: wq/wk/wv (d, heads, hd), wo (h, hd, d)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = 1.0 / math.sqrt(d)
    defs = {"wq": ParamDef((d, h, hd), "normal", s,
                           ("embed", "heads", "head_dim")),
            "wk": ParamDef((d, kv, hd), "normal", s,
                           ("embed", "kv_heads", "head_dim")),
            "wv": ParamDef((d, kv, hd), "normal", s,
                           ("embed", "kv_heads", "head_dim")),
            "wo": ParamDef((h, hd, d), "normal", 1.0 / math.sqrt(h * hd),
                           ("heads", "head_dim", "embed"))}
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, hd), "zeros", axes=("heads", "head_dim"))
        defs["bk"] = ParamDef((kv, hd), "zeros",
                              axes=("kv_heads", "head_dim"))
        defs["bv"] = ParamDef((kv, hd), "zeros",
                              axes=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), "ones", axes=("head_dim",))
        defs["k_norm"] = ParamDef((hd,), "ones", axes=("head_dim",))
    return defs


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor] = None):
    """q, k, v (B, S, heads, D); ``positions`` (S,) or (B, S) rotate q and
    k where ``cfg.pos_emb`` is "rope" (which needs them) and are unused
    otherwise."""
    # (B, S, d) @ (d, heads x D): one matmul each, as the reference's
    # einsum contracts d
    q, k, v = (unflatten_last(x @ grad_as_value(params[w].flatten(1)),
                              params[w].shape[1:],
                              ("batch", "seq", heads, None))
               for w, heads in (("wq", "heads"), ("wk", "kv_heads"),
                                ("wv", "kv_heads")))
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if cfg.pos_emb == "rope":
        if positions is None:
            raise ValueError('pos_emb="rope" needs the positions')
        tables = rope_tables(positions, q.shape[-1], cfg.rope_theta)
        q = apply_rope(q, positions, cfg.rope_theta, tables)
        k = apply_rope(k, positions, cfg.rope_theta, tables)
    return q, k, v


def _out_proj(ctx: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """ctx (B, S, H, D) through wo (H, D, d), one matmul."""
    return ctx.flatten(-2) @ grad_as_value(wo.flatten(0, 1))


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


def _flash(q, k, v):
    return flash_attention(q, k, v, causal=True)


def _context(q, k, v, cfg: ModelConfig, block_kv: int) -> torch.Tensor:
    if wants_kernel(cfg.attn_backend, "attn_backend", ATTN_BACKENDS):
        # under sharding rules each rank's kernel takes its batch rows
        # and its whole GQA groups of heads
        qa, kva = ("batch", None, "heads", None), ("batch", None,
                                                  "kv_heads", None)
        return local_call(_flash, (q, k, v), (qa, kva, kva), (qa,))
    return blockwise_attention(q, k, v, causal=True, block_kv=block_kv)


def full_attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig, block_kv: int = 512
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention over the whole sequence, positions 0 .. S - 1
    -> (out, (k, v))."""
    q, k, v = _project_qkv(params, x, cfg,
                           torch.arange(x.shape[1], device=x.device))
    ctx = _context(q, k, v, cfg, block_kv)
    return _out_proj(ctx, params["wo"]), (k, v)


def _write_cache(caches: Tuple[torch.Tensor, ...],
                 news: Tuple[torch.Tensor, ...], pos: torch.Tensor,
                 active: Optional[torch.Tensor]) -> None:
    """Write each ``new`` (B, s_q, KV, D) into its ``cache`` (B, S_max, KV,
    D) in place (k and v share the index arithmetic).

    Per-slot single token (``attention.py:248-259``): rows that are inactive
    or at/past capacity keep their old contents (the reference drops them
    with an out-of-bounds scatter; torch has no drop mode, so the row is
    masked).  Per-slot multi-token replay (``:260-269``) writes row b at
    pos[b]..; scalar pos (``:270-274``) writes every row at pos..  Start
    indices clamp so the update fits, as ``dynamic_update_slice`` does.
    """
    b, s_q = news[0].shape[:2]
    s_max = caches[0].shape[1]
    rows = torch.arange(b, device=pos.device)
    if pos.dim() == 1 and s_q == 1:
        ok = pos < s_max
        if active is not None:
            ok = ok & active
        idx = pos.clamp_max(s_max - 1)
        for cache, new in zip(caches, news):
            keep = cache[rows, idx]
            cache[rows, idx] = torch.where(ok[:, None, None],
                                           new[:, 0].to(cache.dtype), keep)
        return
    start = pos.clamp(0, s_max - s_q)
    idx = start.reshape(-1, 1) + torch.arange(s_q, device=pos.device)
    for cache, new in zip(caches, news):
        if pos.dim() == 1:
            cache[rows[:, None], idx] = new.to(cache.dtype)
        else:
            cache[:, idx[0]] = new.to(cache.dtype)


PagedWrite = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def paged_write_rows(page_table: torch.Tensor, pos: torch.Tensor,
                     active: Optional[torch.Tensor],
                     page_size: int) -> PagedWrite:
    """(rows, page ids, in-page offsets) of the slots that write their new
    k/v into a shared pool this step (``attention.py:229-246``).

    Row b writes at offset ``pos[b] % page_size`` of page
    ``page_table[b, pos[b] // page_size]`` unless it is inactive, its page
    is unowned (-1) or it is past the table's capacity.  The reference
    sends such rows to an out-of-bounds sentinel that the scatter drops;
    torch has no drop mode, and a clamped index could be the very entry
    another slot writes in the same step, so the writing rows are selected
    instead.  The selection costs one device-to-host sync per call, which
    ``DenseLM.decode`` makes once per fused step for all layers.
    """
    b, max_pages = page_table.shape
    page = pos // page_size
    pid = page_table[torch.arange(b, device=pos.device),
                     page.clamp_max(max_pages - 1)].long()
    ok = (pid >= 0) & (page < max_pages)
    if active is not None:
        ok = ok & active
    rows = ok.nonzero().squeeze(1)
    return rows, pid[rows], (pos % page_size)[rows]


def decode_attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
                     cfg: ModelConfig, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     active: Optional[torch.Tensor] = None,
                     page_table: Optional[torch.Tensor] = None,
                     paged_write: Optional[PagedWrite] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode ``x`` (B, s_q, d) against a KV cache.

    ``pos`` is a 0-dim tensor (every row at one position) or a (B,) vector
    (each slot at its own depth).  The new k/v are written into the cache
    tensors in place (the reference donates the buffer) and the same
    tensors are returned.  Mask convention: after the write a row at
    position p has p + 1 valid entries, and cache row j attends iff
    j < p + 1 (``attention.py:283-284``).

    Cache layouts: dense (``page_table`` None) ``(B, S_max, KV, D)`` rows;
    paged (``page_table`` (B, max_pages) int32, -1 = unowned) shared
    ``(n_pages, page_size, KV, D)`` pools, row b's token j at page
    ``page_table[b, j // page_size]``, offset ``j % page_size``.  Paged
    decode is per-slot single-token only (the fused engine step); its
    writing rows are ``paged_write`` when the caller computed them once
    for all layers (:func:`paged_write_rows`), else computed here.
    """
    b, s_q = x.shape[0], x.shape[1]
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kvh
    per_slot = pos.dim() == 1
    offs = torch.arange(s_q, device=x.device)
    positions = pos[:, None] + offs if per_slot else pos + offs
    q, k, v = _project_qkv(params, x, cfg, positions)
    if page_table is not None:
        if not per_slot or s_q != 1:
            raise ValueError(f"paged decode is per-slot single-token only "
                             f"(got pos dim {pos.dim()}, s_q {s_q})")
        rows, pages, offs = paged_write or paged_write_rows(
            page_table, pos, active, cache_k.shape[1])
        cache_k[pages, offs] = k[rows, 0].to(cache_k.dtype)
        cache_v[pages, offs] = v[rows, 0].to(cache_v.dtype)
    else:
        _write_cache((cache_k, cache_v), (k, v), pos, active)

    use_kernel = wants_kernel(cfg.decode_backend, "decode_backend",
                              DECODE_BACKENDS)
    if use_kernel and s_q == 1:
        lengths = (pos + 1 if per_slot else (pos + 1).expand(b))
        lengths = lengths.to(torch.int32).contiguous()
        if page_table is not None:
            ctx = flash_decode_paged(q[:, 0], cache_k, cache_v, page_table,
                                     lengths)[:, None]
        else:
            ctx = local_call(
                flash_decode, (q[:, 0], cache_k, cache_v, lengths),
                (("batch", "heads", None), ("batch", None, "kv_heads", None),
                 ("batch", None, "kv_heads", None), ("batch",)),
                (("batch", "heads", None),))[:, None]
    else:
        kc, vc = cache_k, cache_v
        if page_table is not None:
            kc = gather_pages(cache_k, page_table)
            vc = gather_pages(cache_v, page_table)
        s_max = kc.shape[1]
        qg = q.reshape(b, s_q, kvh, g, d) * (1.0 / math.sqrt(d))
        s = torch.einsum("bqkgd,bjkd->bkgqj", qg, kc).float()
        counts = (positions if per_slot
                  else positions[None, :]) + 1  # valid-entry counts
        valid = (torch.arange(s_max, device=x.device)[None, None, :]
                 < counts[:, :, None])  # (B or 1, s_q, S_max)
        s = s.masked_fill(~valid[:, None, None], NEG_INF)
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bkgqj,bjkd->bkgqd", p.to(vc.dtype), vc)
        ctx = ctx.permute(0, 3, 1, 2, 4).reshape(b, s_q, h, d)
    out = _out_proj(ctx, params["wo"])
    return out, cache_k, cache_v
