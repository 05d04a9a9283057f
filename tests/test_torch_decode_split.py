"""The flash-decode kernels' one-launch design, emulated on the host.

``csrc/flash_decode.cu`` serves each (slot, kv head) with a cluster of C
blocks.  Block r takes keys [r R, (r + 1) R) of the slot's valid ones, R =
ceil(len / C) rounded up to the 32-key tile, and walks them tile by tile:
key j of a tile belongs to key group j % KPW of warp (j // KPW) % WK, whose
LPK lanes each hold a slice of q and of the row (chunks of 16 bytes, chunk
c on lane part c % LPK), sum their slice in order and add the slices across
lanes by a butterfly.  Each key group keeps its own running (m, l, o) in
fp32: per tile m rises to the largest valid score, l and o are rescaled by
exp(m_old - m_new) and take p = exp(s - m_new) key by key.  After the
keys, the key groups of a warp merge by a butterfly, the warps in order,
and the cluster's blocks in rank order: gm = max m, o = sum o exp(m - gm),
l = sum l exp(m - gm).  The paged kernel does the same over a slot's
logical keys, reading key j from page table[b, j // ps] at offset j % ps
(the quotient a multiply-high and a shift), an unowned key a zero key and
value.

Here the same decomposition runs in plain PyTorch in fp32, from a numpy
seed, and must keep within a tenth of ``chip_smoke.py``'s ``check_partials``
limit (2e-5) of the fp64 oracle and of the JAX kernels in interpret mode:
normalised o and m absolutely, l relatively.  The tests marked ``gpu`` hold
the kernels on the card: two runs bit for bit, G = 3 and 6 against the
plain versions, the card against this emulation, and the wrappers' refusal
of caches that are not 16-byte aligned:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_decode_split.py
"""
from __future__ import annotations

import math
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                              flash_decode_fwd_plain,
                                              flash_decode_paged_fwd,
                                              flash_decode_paged_fwd_plain,
                                              gather_pages)

F32 = torch.float32
LIMIT = 2e-5    # chip_smoke.py check_partials
ROOM = 0.1      # the share of that limit the arithmetic may use
NEG_INF = -1e30
TILE, WARPS, MAX_CLUSTER = 32, 4, 8   # csrc/flash_decode.cu


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The emulation runs many small tensor ops; with one intra-op thread
    they stay cheap where test workers share the cores (six workers each
    spinning eight threads took this file from 9 s to 830 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's decode kernels (skips where JAX is absent)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_decode.ops import (flash_decode_paged_partials,
                                                flash_decode_partials)
    return types.SimpleNamespace(jnp=jnp, dense=flash_decode_partials,
                                 paged=flash_decode_paged_partials)


# ---------------------------------------------------------------------------
# the kernels' decomposition
# ---------------------------------------------------------------------------

def layout(d: int, g: int, elt: int) -> types.SimpleNamespace:
    """``Shape<T, D, G>`` of the kernel: 16-byte chunks of VEC elements,
    LPK lanes a key, KPW key groups a warp, WK warps across keys (the
    others across query rows), KPG keys a key group a tile."""
    vec = 16 // elt
    nc, lpk = d // vec, 8 if d == 128 else 4
    wk = WARPS // math.gcd(g, WARPS)
    kpw = 32 // lpk
    return types.SimpleNamespace(vec=vec, nc=nc, lpk=lpk, kpw=kpw, wk=wk,
                                 kpg=TILE // (wk * kpw))


def fast_div_magic(ps: int):
    """(mul, shift) with col // ps == umulhi(col, mul) >> shift for col <
    2^31 (ps > 1), as the paged wrapper's C side computes them."""
    log2 = (ps - 1).bit_length()
    return ((1 << (31 + log2)) + ps - 1) // ps, log2 - 1


def fast_div(col, ps: int):
    if ps == 1:
        return col
    mul, shift = fast_div_magic(ps)
    return ((col * mul) >> 32) >> shift


def lane_slices(d: int, lay) -> torch.Tensor:
    """(LPK, E) element indices of each lane part in its order of summing,
    -1 where a part has fewer chunks than another (D = 80 in bf16)."""
    cpl = -(-lay.nc // lay.lpk)
    idx = torch.full((lay.lpk, cpl * lay.vec), -1, dtype=torch.long)
    for part in range(lay.lpk):
        for i in range(cpl):
            c = part + lay.lpk * i
            if c < lay.nc:
                idx[part, i * lay.vec:(i + 1) * lay.vec] = torch.arange(
                    c * lay.vec, (c + 1) * lay.vec)
    return idx


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Lane 0's sum over the last axis (a key's LPK lanes) after the
    kernel's xor-shuffle rounds, offsets LPK / 2 down to 1."""
    n = x.shape[-1]
    off = n // 2
    while off:
        x = x + x[..., torch.arange(n) ^ off]
        off //= 2
    return x[..., 0]


def key_group_merge(m, l, o):
    """Lane 0's (m, l, o) after the kernel's xor-shuffle rounds over a
    warp's key groups (the last axis of m and l, the one before last of o),
    offsets 1, 2, 4 .. in key groups."""
    n = m.shape[-1]
    off = 1
    while off < n:
        idx = torch.arange(n) ^ off
        mo, lo, oo = m[..., idx], l[..., idx], o[..., idx, :]
        mx = torch.maximum(m, mo)
        ca, cb = torch.exp(m - mx), torch.exp(mo - mx)
        m, l, o = mx, l * ca + lo * cb, o * ca[..., None] + oo * cb[..., None]
        off *= 2
    return m[..., 0], l[..., 0], o[..., 0, :]


def merge(parts, axis: int):
    """Merge partial (m, l, o) along ``axis`` in order: gm = max m, then
    o and l as sums of x exp(m - gm) taken term by term from 0."""
    m, l, o = parts
    gm = m.amax(dim=axis)
    w = torch.exp(m - gm.unsqueeze(axis))
    lo = torch.zeros_like(gm)
    oo = torch.zeros_like(o.select(axis, 0))
    for i in range(m.shape[axis]):
        lo = lo + l.select(axis, i) * w.select(axis, i)
        oo = oo + o.select(axis, i) * w.select(axis, i).unsqueeze(-1)
    return gm, lo, oo


def emulate(q: torch.Tensor, rows, lengths: torch.Tensor, s: int,
            elt: int, c: int = MAX_CLUSTER):
    """The kernels' fp32 partials of q (B, KV, G, D) over the keys that
    ``rows(col)`` gives: (B, KV, len(col), D) k and v rows of each slot's
    logical keys ``col`` (B, n), zero where unowned, in clusters of ``c``
    blocks (the kernels take 1, 2, 4 or 8 by occupancy; each is exact to
    rounding)."""
    b, kvh, g, d = q.shape
    lay = layout(d, g, elt)
    sl = lane_slices(d, lay)
    qf = torch.cat([q.to(F32), q.new_zeros(b, kvh, g, 1, dtype=F32)], -1)
    qs = qf[..., sl]                                  # (B, KV, G, LPK, E)
    scale = torch.tensor(1.0, dtype=F32) / torch.sqrt(
        torch.tensor(float(d), dtype=F32))
    ln = lengths.long().clamp(0, s)
    per = (-(-ln // c) + TILE - 1) // TILE * TILE
    # key j of a tile, by (warp across keys, key group, key of the group)
    j = ((torch.arange(lay.kpg)[None, None, :] * lay.wk
          + torch.arange(lay.wk)[:, None, None]) * lay.kpw
         + torch.arange(lay.kpw)[None, :, None])      # (WK, KPW, KPG)
    blocks = []
    for rank in range(c):
        start = torch.minimum(ln, rank * per)
        end = torch.minimum(ln, start + per)
        n_tiles = int(((end - start + TILE - 1) // TILE).max())
        shp = (b, kvh, g, lay.wk, lay.kpw)
        m = torch.full(shp, NEG_INF, dtype=F32)
        l = torch.zeros(shp, dtype=F32)
        o = torch.zeros(shp + (d,), dtype=F32)
        for t in range(n_tiles):
            col = start[:, None] + t * TILE + j.reshape(1, -1)   # (B, n)
            valid = col < end[:, None]
            k, v = rows(torch.where(valid, col, 0))
            k = torch.where(valid[:, None, :, None], k.to(F32), 0.0)
            v = torch.where(valid[:, None, :, None], v.to(F32), 0.0)
            kf = torch.cat([k, k.new_zeros(k.shape[:-1] + (1,))], -1)
            ks = kf[..., sl]                         # (B, KV, n, LPK, E)
            # each lane's slice summed in order, then across lanes
            prod = qs[:, :, :, None] * ks[:, :, None]  # (B, KV, G, n, LPK, E)
            dot = torch.zeros(prod.shape[:-1], dtype=F32)
            for e in range(prod.shape[-1]):
                dot = dot + prod[..., e]
            dot = lane_sum(dot) * scale              # (B, KV, G, n)
            sc = dot.reshape(b, kvh, g, lay.wk, lay.kpw, lay.kpg)
            ok = valid.reshape(b, 1, 1, lay.wk, lay.kpw, lay.kpg)
            mx = torch.maximum(m, torch.where(ok, sc, NEG_INF).amax(-1))
            corr = torch.exp(m - mx)
            m, l, o = mx, l * corr, o * corr[..., None]
            p = torch.where(ok, torch.exp(sc - mx[..., None]), 0.0)
            vr = v.reshape(b, kvh, 1, lay.wk, lay.kpw, lay.kpg, d)
            for kk in range(lay.kpg):
                l = l + p[..., kk]
                o = o + p[..., kk, None] * vr[..., kk, :]
        # the key groups of a warp by shuffles, then the warps in order
        mw, lw, ow = key_group_merge(m, l, o)         # (B, KV, G, WK, ..)
        blocks.append(merge((mw, lw, ow), 3) if lay.wk > 1
                      else (mw[..., 0], lw[..., 0], ow[..., 0, :]))
    # the cluster's blocks in rank order
    m, l, o = zip(*blocks)
    gm, l, o = merge((torch.stack(m, 3), torch.stack(l, 3),
                      torch.stack(o, 3)), 3)
    return o, gm, l


def dense_rows(k: torch.Tensor, v: torch.Tensor):
    def rows(col):
        idx = col[:, :, None, None].expand(-1, -1, k.shape[2], k.shape[3])
        return (k.gather(1, idx).transpose(1, 2),
                v.gather(1, idx).transpose(1, 2))
    return rows


def paged_rows(k_pool, v_pool, table: torch.Tensor):
    ps = k_pool.shape[1]

    def rows(col):
        page = fast_div(col, ps)
        pid = table.long().gather(1, page)
        off = col - page * ps
        owned = (pid >= 0)[:, None, :, None]
        k = k_pool[pid.clamp_min(0), off].transpose(1, 2)   # (B, KV, n, D)
        v = v_pool[pid.clamp_min(0), off].transpose(1, 2)
        return torch.where(owned, k, 0), torch.where(owned, v, 0)
    return rows


def oracle(q, k, v, lengths):
    """fp64 partials over a dense (B, S, KV, D) cache."""
    qd, kd, vd = (t.double() for t in (q, k, v))
    sc = torch.einsum("bkgd,bjkd->bkgj", qd, kd) / math.sqrt(q.shape[-1])
    valid = (torch.arange(k.shape[1])[None, :]
             < lengths.long()[:, None])[:, None, None, :]
    sc = sc.masked_fill(~valid, NEG_INF)
    m = sc.amax(-1)
    p = torch.where(valid, torch.exp(sc - m[..., None]), 0.0)
    return torch.einsum("bkgj,bjkd->bkgd", p, vd), m, p.sum(-1)


def errors(got, ref, lengths) -> list:
    """[normalised o, m, relative l] of ``got`` against ``ref``; empty
    slots must give (0, -1e30, 0) exactly."""
    (o, m, l), (ro, rm, rl) = ([t.double() for t in x] for x in (got, ref))
    live = lengths > 0
    norm = (o / l[..., None].clamp_min(1e-30)
            - ro / rl[..., None].clamp_min(1e-30)).abs().max().item()
    dm = (m[live] - rm[live]).abs().max().item() if live.any() else 0.0
    dl = ((l - rl).abs() / rl.abs().clamp_min(1.0)).max().item()
    empty = ~live
    o32, m32, l32 = got
    assert bool((m32[empty] == -1e30).all() and (l32[empty] == 0).all()
                and (o32[empty] == 0).all())
    return [norm, dm, dl]


def _inputs(seed, b, s, kvh, g, d, dtype=F32):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .to(dtype) for shape in ((b, kvh, g, d), (b, s, kvh, d),
                                        (b, s, kvh, d)))
    return q, k, v


# lengths: empty, 1, a tile -1/0/+1, and around the blocks' edges of a
# cache of 1024 in clusters of 8 (R = 32 up to 256 keys, 64 up to 512, ...)
LENGTHS = [0, 1, 31, 32, 33, 224, 225, 255, 256, 257, 511, 512, 513, 1023,
           1024]


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("g", [1, 3, 4, 6, 8])
def test_dense_decomposition_matches_fp64(g, d):
    q, k, v = _inputs(g * d, len(LENGTHS), 1024, 2, g, d)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    got = emulate(q, dense_rows(k, v), lengths, 1024, 4)
    assert max(errors(got, oracle(q, k, v, lengths), lengths)) <= ROOM * LIMIT


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("g,d", [(1, 64), (6, 80)])
def test_dense_decomposition_any_cluster_size(cluster, g, d):
    q, k, v = _inputs(cluster, len(LENGTHS), 1024, 2, g, d)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    got = emulate(q, dense_rows(k, v), lengths, 1024, 4, cluster)
    assert max(errors(got, oracle(q, k, v, lengths), lengths)) <= ROOM * LIMIT


@pytest.mark.parametrize("g,d", [(1, 64), (3, 80), (8, 128)])
def test_dense_decomposition_bf16(g, d):
    q, k, v = _inputs(7 + g, len(LENGTHS), 1024, 2, g, d, torch.bfloat16)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    got = emulate(q, dense_rows(k, v), lengths, 1024, 2)
    assert max(errors(got, oracle(q, k, v, lengths), lengths)) <= ROOM * LIMIT


def _paged(seed, ps, g, d, s=576, kvh=2, dtype=F32):
    """A table over a shuffled pool: edge lengths; row 5 a hole inside its
    length, row 6 no page at all, row 7 a hole past its length and then a
    page id that row 4 also owns."""
    rng = np.random.default_rng(seed)
    mp = -(-s // ps)
    lengths = [0, 1, ps, ps + 1, mp * ps, 2 * ps + 5, 1, 2 * ps, TILE * 3 + 1]
    n_pages = sum(-(-n // ps) for n in lengths) + 2
    b = len(lengths)
    q = torch.from_numpy(rng.standard_normal((b, kvh, g, d),
                                             dtype=np.float32)).to(dtype)
    k_pool, v_pool = (torch.from_numpy(rng.standard_normal(
        (n_pages, ps, kvh, d), dtype=np.float32)).to(dtype) for _ in range(2))
    perm = list(rng.permutation(n_pages))
    table = torch.full((b, mp), -1, dtype=torch.int32)
    for i, n in enumerate(lengths):
        for p in range(-(-n // ps)):
            table[i, p] = int(perm.pop())
    table[5, 1] = -1
    table[6, 0] = -1
    if mp > 3:
        table[7, 3] = table[4, 0]
    return q, k_pool, v_pool, table, torch.tensor(lengths, dtype=torch.int32)


@pytest.mark.parametrize("ps,g,d", [(8, 1, 64), (16, 3, 80), (64, 1, 80),
                                    (16, 6, 128), (64, 4, 64), (8, 8, 128)])
def test_paged_decomposition_matches_fp64(ps, g, d):
    q, k_pool, v_pool, table, lengths = _paged(ps + g, ps, g, d)
    s = table.shape[1] * ps
    got = emulate(q, paged_rows(k_pool, v_pool, table), lengths, s, 4)
    ref = oracle(q, gather_pages(k_pool, table), gather_pages(v_pool, table),
                 lengths)
    assert max(errors(got, ref, lengths)) <= ROOM * LIMIT


def test_fast_division_is_exact():
    for ps in list(range(1, 130)) + [255, 256, 1000, 4096, 65537]:
        col = np.concatenate([np.arange(0, 20000),
                              np.array([2 ** 31 - 1 - i for i in range(200)])])
        got = fast_div(col.astype(object), ps)
        assert (np.asarray(got, dtype=np.int64) == col // ps).all(), ps
        mul, _ = fast_div_magic(ps)
        assert ps == 1 or 0 < mul < 2 ** 32


@pytest.mark.parametrize("g", [1, 3])
def test_dense_decomposition_matches_jax_kernel(jx, g):
    lengths = [0, 1, 31, 33, 129, 160, 97]
    q, k, v = _inputs(20 + g, len(lengths), 160, 2, g, 64)
    tl = torch.tensor(lengths, dtype=torch.int32)
    got = emulate(q, dense_rows(k, v), tl, 160, 4)
    b, kvh, _, d = q.shape
    jo, jm, jl = jx.dense(*(jx.jnp.asarray(x.numpy()) for x in (
        q.reshape(b, kvh * g, d), k, v, tl)), interpret=True)
    ref = tuple(torch.tensor(np.asarray(x)) for x in (jo, jm, jl))
    assert max(errors(got, ref, tl)) <= ROOM * LIMIT


@pytest.mark.parametrize("ps,g", [(16, 1), (64, 3)])
def test_paged_decomposition_matches_jax_kernel(jx, ps, g):
    """The TPU kernel skips an unowned page inside a row's length where the
    CUDA kernel and the oracle read zero keys, so rows 5 and 6 are compared
    with the oracle only (``test_paged_decomposition_matches_fp64``)."""
    q, k_pool, v_pool, table, lengths = _paged(40 + ps, ps, g, 64, s=256)
    got = emulate(q, paged_rows(k_pool, v_pool, table), lengths,
                  table.shape[1] * ps, 4)
    b, kvh, _, d = q.shape
    jo, jm, jl = jx.paged(*(jx.jnp.asarray(x.numpy()) for x in (
        q.reshape(b, kvh * g, d), k_pool, v_pool, table, lengths)),
        interpret=True)
    ref = tuple(torch.tensor(np.asarray(x)) for x in (jo, jm, jl))
    rows = [i for i in range(len(lengths)) if i not in (5, 6)]
    assert max(errors(tuple(x[rows] for x in got),
                      tuple(x[rows] for x in ref), lengths[rows])) <= (
        ROOM * LIMIT)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    """The CUDA device; skips where there is none (decided at run time, so
    every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, torch.bfloat16])
def test_cuda_decode_reruns_are_bit_identical(cuda, dtype):
    q, k, v = (x.to(cuda) for x in _inputs(3, len(LENGTHS), 1024, 12, 1, 64,
                                           dtype))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=cuda)
    first, again = flash_decode_fwd(q, k, v, lengths), flash_decode_fwd(
        q, k, v, lengths)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    args = [x.to(cuda) for x in _paged(5, 64, 1, 64, dtype=dtype)]
    first, again = flash_decode_paged_fwd(*args), flash_decode_paged_fwd(
        *args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, torch.bfloat16])
@pytest.mark.parametrize("g,d", [(3, 64), (6, 128)])
def test_cuda_decode_groups_3_and_6_match_plain(cuda, g, d, dtype):
    q, k, v = (x.to(cuda) for x in _inputs(g, len(LENGTHS), 1024, 4, g, d,
                                           dtype))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=cuda)
    got = flash_decode_fwd(q, k, v, lengths)
    assert max(errors(got, flash_decode_fwd_plain(q, k, v, lengths),
                      lengths)) <= LIMIT
    args = [x.to(cuda) for x in _paged(g, 16, g, d, dtype=dtype)]
    got = flash_decode_paged_fwd(*args)
    assert max(errors(got, flash_decode_paged_fwd_plain(*args),
                      args[-1])) <= LIMIT


@pytest.mark.gpu
@pytest.mark.parametrize("g,d", [(1, 64), (1, 80), (6, 128)])
def test_cuda_decode_matches_the_emulation(cuda, g, d):
    q, k, v = _inputs(30 + g, len(LENGTHS), 1024, 2, g, d)
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    got = flash_decode_fwd(q.to(cuda), k.to(cuda), v.to(cuda),
                           lengths.to(cuda))
    want = emulate(q, dense_rows(k, v), lengths, 1024, 4)
    assert max(errors(tuple(x.cpu() for x in got), want, lengths)) <= (
        ROOM * LIMIT)


@pytest.mark.gpu
def test_cuda_decode_refuses_misaligned_caches(cuda):
    q, k, v = (x.to(cuda) for x in _inputs(0, 2, 64, 2, 1, 64))
    lengths = torch.tensor([3, 64], dtype=torch.int32, device=cuda)
    flat = torch.zeros(k.numel() + 1, device=cuda)
    shifted = flat[1:].view(k.shape)             # starts 4 bytes off
    with pytest.raises(ValueError):
        flash_decode_fwd(q, shifted, v, lengths)
    wide = torch.zeros(2, 64, 2, 65, device=cuda)[..., :64]  # rows 260 B apart
    with pytest.raises(ValueError):
        flash_decode_fwd(q, k, wide, lengths)
    table = torch.tensor([[0], [1]], dtype=torch.int32, device=cuda)
    pool = k[:, :, :, :].reshape(2, 64, 2, 64)
    with pytest.raises(ValueError):
        flash_decode_paged_fwd(q, shifted, pool, table, lengths)
