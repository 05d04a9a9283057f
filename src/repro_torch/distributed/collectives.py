"""Flash decoding over a sequence-sharded KV cache, and slot migration
(``repro/distributed/collectives.py``).

For long-context decode the KV cache is sharded along its sequence axis
over a mesh axis.  All-gathering the cache would move B * S * KV * D
values; instead each shard computes a partial softmax over its own rows
and the shards merge their ``(o, m, l)`` triples with three small
all-reduces (``collectives.py:34-82``), bytes proportional to B * H * D.

Masking convention: ``pos`` counts the valid entries (cache row ``j`` is
valid iff ``j < pos``), as in the models' decode and the flash-decode
kernel.  The per-shard partial is the kernel's own ``(o, m, l)``
(``kernels.flash_decode.ops.flash_decode_partials``), so
``backend="kernel"`` runs the CUDA split-KV kernel on each rank's local
rows (its plain version on CPU tensors).  The merge is
:func:`merge_partials` of the stacked partials and two reductions: the
sharded path passes all-reduces over the axis's process group, and a
single card can merge several virtual shards' partials stacked along a
leading axis with the same code.

``migrate_row`` moves one slot's row between decode states
(``collectives.py:93-119``); its ``placement`` hook redistributes the row
onto another mesh.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.compat import (DeviceMesh, distribute_tensor,
                                            is_dtensor)
from repro_torch.kernels import DECODE_BACKENDS, wants_kernel
from repro_torch.kernels.flash_decode.kernel import flash_decode_fwd_plain
from repro_torch.kernels.flash_decode.ops import flash_decode_partials

Reduce = Callable[[torch.Tensor], torch.Tensor]


def merge_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                   reduce_max: Reduce, reduce_sum: Reduce) -> torch.Tensor:
    """Merge split-softmax partials (o (..., D), m (...), l (...), fp32)
    into the normalized output: ``gm = max(m)``, ``corr = exp(m - gm)``,
    ``sum(o corr) / sum(l corr)``, the max and sums taken by
    ``reduce_max`` / ``reduce_sum`` (all-reduces over a process group, or
    reductions over a stacked shard axis that keep it).  An empty shard's
    (0, -inf or NEG_INF, 0) drops out exactly."""
    gm = reduce_max(m)
    corr = torch.exp(m - gm)
    l_tot = reduce_sum(l * corr)
    o_tot = reduce_sum(o * corr[..., None])
    return o_tot / l_tot[..., None].clamp_min(1e-30)


def stacked_reductions():
    """``(reduce_max, reduce_sum)`` over the leading axis of stacked
    partials, the shard axis kept for the max (it broadcasts back) and
    dropped by the sums."""
    return (lambda t: t.amax(dim=0, keepdim=True),
            lambda t: t.sum(dim=0))


def group_reductions(group) -> tuple:
    """``(reduce_max, reduce_sum)`` as all-reduces over ``group``."""
    def reduce(op):
        def fn(t: torch.Tensor) -> torch.Tensor:
            t = t.clone()
            dist.all_reduce(t, op=op, group=group)
            return t
        return fn
    return reduce(dist.ReduceOp.MAX), reduce(dist.ReduceOp.SUM)


def shard_lengths(pos, base: int, s_local: int, b: int,
                  device) -> torch.Tensor:
    """(B,) int32 valid-entry counts inside one shard whose first row is
    global row ``base``: ``clip(pos - base, 0, s_local)`` (an empty shard
    gives 0)."""
    pos = torch.as_tensor(pos, device=device).to(torch.int64)
    return torch.broadcast_to((pos - base).clamp(0, s_local),
                              (b,)).to(torch.int32).contiguous()


def local_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor, use_kernel: bool):
    """``(o, m, l)`` of one shard: q (B, H, D), k/v (B, S_local, KV, D)."""
    if use_kernel:
        return flash_decode_partials(q, k, v, lengths)
    b, h, d = q.shape
    kvh = k.shape[2]
    return flash_decode_fwd_plain(q.reshape(b, kvh, h // kvh, d), k, v,
                                  lengths)


def flash_decode_sharded(mesh: DeviceMesh, seq_axis: str = "data",
                         backend: str = "reference"):
    """Returns ``fn(q, k_cache, v_cache, pos) -> out``.

    q: (B, 1, H, D), whole on every rank of ``seq_axis`` (a plain tensor
    or a replicated DTensor); k_cache / v_cache: (B, S, KV, D) DTensors
    sharded along S over ``seq_axis`` (``Shard(1)`` on that mesh dim);
    pos: the global count of valid entries (int, 0-dim or (B,)).  Returns
    the (B, 1, H, D) context, a plain tensor whole on every rank.
    ``backend`` "kernel" runs the flash-decode kernel on each rank's rows
    (on CUDA tensors; its plain version on CPU tensors), "reference" the
    plain partials.
    """
    use_kernel = wants_kernel(backend, "decode backend", DECODE_BACKENDS)
    group = mesh.get_group(seq_axis)
    shard = mesh.get_local_rank(seq_axis)
    reductions = group_reductions(group)

    def apply(q, k_cache, v_cache, pos):
        q = q.to_local() if is_dtensor(q) else q
        k = k_cache.to_local() if is_dtensor(k_cache) else k_cache
        v = v_cache.to_local() if is_dtensor(v_cache) else v_cache
        b, sq, h, d = q.shape
        if sq != 1:
            raise ValueError("flash decode serves one token per step")
        s_local = k.shape[1]
        lengths = shard_lengths(pos, shard * s_local, s_local, b, q.device)
        o, m, l = local_partials(q[:, 0], k.contiguous(), v.contiguous(),
                                 lengths, use_kernel)
        out = merge_partials(o, m, l, *reductions)
        return out.reshape(b, sq, h, d).to(q.dtype)

    return apply


def reference_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos) -> torch.Tensor:
    """Unsharded oracle of :func:`flash_decode_sharded`: a masked softmax
    over the whole cache (``collectives.py:80-90``); ``pos`` a scalar or
    per-row (B,) count of valid entries."""
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError("flash decode serves one token per step")
    kvh = k_cache.shape[2]
    s = k_cache.shape[1]
    lengths = torch.broadcast_to(torch.as_tensor(pos, device=q.device),
                                 (b,)).long()
    qg = q[:, 0].float().reshape(b, kvh, h // kvh, d)
    scores = torch.einsum("bkgd,bjkd->bkgj", qg, k_cache.float()) / (
        math.sqrt(d))
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths[:, None])[:, None, None, :]
    p = torch.softmax(scores.masked_fill(~valid, float("-inf")), dim=-1)
    out = torch.einsum("bkgj,bjkd->bkgd", torch.nan_to_num(p),
                       v_cache.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _place(row, placement):
    """Each leaf of ``row`` on ``placement`` (a ``NamedSharding``, or a
    dict of them by leaf name): a plain tensor is distributed from the
    same value on every rank, a DTensor redistributed."""
    out = {}
    for name, t in row.items():
        sh = placement[name] if isinstance(placement, dict) else placement
        mesh = sh.mesh
        out[name] = (t.redistribute(mesh, sh.placements) if is_dtensor(t)
                     else distribute_tensor(t, mesh, sh.placements))
    return out


def migrate_row(src_state, src_cache, src_slot: int, dst_state, dst_cache,
                dst_slot: int, cache_len=None, placement: Any = None):
    """Move one slot's cache row from ``src_state`` to ``dst_state``.

    The row travels in model format: ``gather`` on the source, ``fit_row``
    to the destination's capacity when ``cache_len`` is given (a paged
    gather returns ``pages_per_slot * page_size`` entries; everything past
    ``pos`` is never read, so trimming is lossless), ``placement`` (a
    ``NamedSharding`` on a ``DeviceMesh``, or a dict of them per leaf) to
    redistribute the row onto the destination's mesh, ``insert`` on the
    destination, ``evict`` on the source.  So it works across dense and
    paged states in either direction.  A placed row meets a destination
    cache of plain tensors as each rank's whole row.  Returns
    ``(src_cache, dst_cache)``; host bookkeeping (scheduler slots, page
    reservations) is the caller's (``Replica.migrate_slot_to``).
    """
    row = src_state.gather(src_cache, src_slot)
    if cache_len is not None:
        row = dst_state.fit_row(row, cache_len)
    if placement is not None:
        row = _place(row, placement)
        row = {name: (t.full_tensor() if not is_dtensor(dst_cache.get(name))
                      else t) for name, t in row.items()}
    dst_cache = dst_state.insert(dst_cache, dst_slot, row)
    src_cache = src_state.evict(src_cache, src_slot)
    return src_cache, dst_cache
