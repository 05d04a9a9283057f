"""The WKV-6 kernels' three-pass design and product arithmetic, emulated on
the host.

``csrc/wkv6.cu`` runs each direction as three passes: chunk-local states
(L_c = (k o exp(cum_last - cum))^T v, or in the backward K_c = (r o
exp(cum_in))^T dy), the state passing across chunks in fp32
round-to-nearest (S_{c+1} = diag(exp(cum_last)) S_c + L_c; G_{c-1} =
diag(exp(cum_last)) G_c + K_c from G_{nc-1} = dstate), and the
chunk-parallel outputs from the inputs, S_c and G_c.  The per-channel
decay factors across 16-row tiles: for rows i of tile I and columns j <
16 I, exp(cum_in_i - cum_j) = exp(cum_in_i - ref_I) exp(ref_I - cum_j)
with ref_I = cum[16 I - 1], both exponents <= 0, so the off-diagonal score
tiles (and dr's and dk's off-diagonal parts) are tensor-core products of
rescaled operands, and only the diagonal tiles take an exp of each
difference.  Every product runs on the tensor cores: fp32 operands split
into TF32 hi and lo (``cvt.rna``), a product as a_lo b_hi + a_hi b_lo +
a_hi b_hi, each MMA's sum over its 8-step truncated, no accumulator over
more than one chunk's rows; the diagonal tiles are fp32 on the CUDA cores.

Here the same passes run in plain PyTorch on the CPU, at B 1, H 2, D 64,
S 256 (four chunks of 64) and a chunk of 40 (not a multiple of 16, padded
to 48 rows as the kernels pad it), from a numpy seed:

* in fp64 with exact products, the decomposition, and autograd through
  it, equal the sequential per-step recurrence (the JAX package's oracle
  ``wkv6_sequential``, and its fp64 twin here with autograd) to rounding;
* in the kernels' arithmetic, every output keeps within a tenth of the
  limits ``chip_smoke.py`` holds the kernels to on the card (``WKV_RTOL``
  1e-4 of the largest entry; ``WKV_FAST_RTOL`` 2e-3 with log_w near
  -54.6) of the fp64 recurrence and of the JAX kernels in interpret mode.

The tests marked ``gpu`` hold two backward runs bit for bit, a chunk below
16 rows (S = 40, chunk 8) and the padding wrapper (S = 300) on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_wkv6_split.py
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6 import (wkv6, wkv6_bwd, wkv6_bwd_plain,
                                       wkv6_fwd, wkv6_fwd_plain)

F32 = torch.float32
WKV_RTOL = 1e-4       # chip_smoke.py: each output, of its largest entry
WKV_FAST_RTOL = 2e-3  # chip_smoke.py: log_w near -54.6 a token
FAST_DECAY = -54.6
ROOM = 0.1            # the share of those limits the arithmetic may use
B, H, D = 1, 2, 64
TILE = 16


@pytest.fixture(scope="module")
def jx():
    """The JAX package's WKV-6 kernels and sequential oracle (skips where
    JAX is absent)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.rwkv6.kernel import wkv6_bwd as jwkv6_bwd
    from repro.kernels.rwkv6.kernel import wkv6_fwd as jwkv6_fwd
    from repro.kernels.rwkv6.ref import wkv6_sequential
    return types.SimpleNamespace(jnp=jnp, fwd=jwkv6_fwd, bwd=jwkv6_bwd,
                                 sequential=wkv6_sequential)


# ---------------------------------------------------------------------------
# the kernels' rounding (as tests/test_torch_ssd_split.py models it)
# ---------------------------------------------------------------------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 to nearest, ties away from zero: cvt.rna's
    rounding, by the integer operations the kernels use for it
    (``split_tf32_alu`` in ``csrc/sm90_mma.cuh``)."""
    bits = x.to(F32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(F32)


def split_tf32(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """fp64 to fp32, truncated: the tensor cores' rounding of a sum."""
    r = x.to(F32)
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def mma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched, fp32) as mma.sync m16n8k8 TF32 takes it: both
    operands split, the three products of each 8-step of k added exactly
    to one accumulator, small terms first, and the sum truncated to
    fp32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    terms = [(x.double(), y.double()) for x, y in ((al, bh), (ah, bl),
                                                   (ah, bh))]
    c = torch.zeros(torch.broadcast_shapes(a.shape[:-1] + (1,),
                                           b.shape[:-2] + (1, 1))[:-1]
                    + b.shape[-1:], dtype=F32)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in terms:
            c = round_toward_zero(c.double() + x[..., ks] @ y[..., ks, :])
    return c


def fma32(a, b, c):
    """a b + c rounded once to fp32 (fmaf)."""
    return (a.double() * b.double() + c.double()).to(F32)


KERNEL = types.SimpleNamespace(mm=mma, fma=fma32)
EXACT = types.SimpleNamespace(mm=lambda a, b: a @ b,
                              fma=lambda a, b, c: a * b + c)


# ---------------------------------------------------------------------------
# the three passes
# ---------------------------------------------------------------------------

def _chunks(r, k, v, lw, q):
    """(B, H, nc, Qp, D) chunk tiles, zero-padded from q to Qp = 16
    ceil(q / 16) rows as the kernels stage them (log_w = 0 there, so cum
    stays at row q - 1's), and the decay geometry."""
    bsz, h, s, d = r.shape
    nc, qp = s // q, TILE * -(-q // TILE)
    pad = lambda x: F.pad(x.reshape(bsz, h, nc, q, d), (0, 0, 0, qp - q))
    rc, kc, vc, lc = (pad(x) for x in (r, k, v, lw))
    cum = lc.cumsum(dim=-2)
    # cum_in as the kernels read it, the row before's cum: exponents of
    # adjacent rows are then exactly 0, where cum - log_w is off by up to an
    # ulp of cum (2.4e-4 at -3,500, log_w near -54.6)
    cin = F.pad(cum[..., :-1, :], (0, 0, 1, 0))
    last = cum[..., -1:, :]
    return types.SimpleNamespace(r=rc, k=kc, v=vc, cum=cum, cin=cin,
                                 last=last, e_in=torch.exp(cin),
                                 f=torch.exp(last - cum),
                                 alpha=torch.exp(last[..., 0, :]), nc=nc,
                                 q=q, qp=qp, nt=qp // TILE)


def _diag_decay(c, rows):
    """w[i, j, d] = exp(cum_in_i - cum_j) for tile rows j < i, else 0."""
    strict = torch.ones(TILE, TILE, dtype=torch.bool).tril(-1)[..., None]
    gap = c.cin[..., rows, None, :] - c.cum[..., None, rows, :]
    return torch.exp(torch.where(strict, gap, torch.full_like(gap,
                                                              -torch.inf)))


def _ref(c, tile):
    """ref_I = cum of the row before tile I, (..., 1, D)."""
    return c.cum[..., TILE * tile - 1:TILE * tile, :]


def _rp(c, tile):
    """r'_I = r o exp(cum_in - ref_I) on tile I's rows."""
    rows = slice(TILE * tile, TILE * tile + TILE)
    return c.r[..., rows, :] * torch.exp(c.cin[..., rows, :] - _ref(c, tile))


def _kp(c, tile, upto):
    """k'_I = k o exp(ref_I - cum) on rows [0, upto)."""
    return c.k[..., :upto, :] * torch.exp(_ref(c, tile) - c.cum[..., :upto, :])


def scores(c, ar):
    """The strictly causal (Qp, Qp) scores: the diagonal tiles from exps of
    differences (fp32 sums on the CUDA cores), the tiles below them as
    r'_I k'_I^T products."""
    att = torch.zeros(c.r.shape[:-1] + (c.qp,), dtype=c.r.dtype)
    for tile in range(c.nt):
        rows = slice(TILE * tile, TILE * tile + TILE)
        w = _diag_decay(c, rows)
        att[..., rows, rows] = (c.r[..., rows, None, :] * w
                                * c.k[..., None, rows, :]).sum(-1)
        if tile:
            att[..., rows, :TILE * tile] = ar.mm(
                _rp(c, tile), _kp(c, tile, TILE * tile).transpose(-1, -2))
    return att


def _unpad(x, c):
    bsz, h = x.shape[:2]
    return x[..., :c.q, :].reshape(bsz, h, c.nc * c.q, x.shape[-1])


def three_pass_fwd(r, k, v, lw, u, q, ar):
    """(y, final state, carries) by the kernels' passes in the arithmetic
    ``ar`` (KERNEL or EXACT)."""
    c = _chunks(r, k, v, lw, q)
    t = lambda m: m.transpose(-1, -2)
    # 1. chunk-local states, one accumulator over the chunk's rows
    local = ar.mm(t(c.k * c.f), c.v)
    # 2. state passing in round-to-nearest
    run = torch.zeros_like(local[:, :, 0])
    carries = []
    for ci in range(c.nc):
        carries.append(run)
        run = ar.fma(c.alpha[:, :, ci, :, None], run, local[:, :, ci])
    carries = torch.stack(carries, dim=2)
    # 3. y: the scores times v, the bonus, and the carried-state term in its
    #    own accumulator
    bon = (c.r * u[None, :, None, None, :] * c.k).sum(-1, keepdim=True)
    y = ar.mm(scores(c, ar), c.v) + ar.mm(c.r * c.e_in, carries) + bon * c.v
    return _unpad(y, c), run, carries


def three_pass_bwd(r, k, v, lw, u, carries, dy, dstate, q, ar):
    """(dr, dk, dv, d_log_w, du_part) by the kernels' passes."""
    c = _chunks(r, k, v, lw, q)
    t = lambda m: m.transpose(-1, -2)
    bsz, h = r.shape[:2]
    dyc = F.pad(dy.reshape(bsz, h, c.nc, q, D), (0, 0, 0, c.qp - q))
    # 1. chunk-local cotangents; 2. reverse passing from dstate
    local = ar.mm(t(c.r * c.e_in), dyc)
    run, gs = dstate, [None] * c.nc
    for ci in reversed(range(c.nc)):
        gs[ci] = run
        run = ar.fma(c.alpha[:, :, ci, :, None], run, local[:, :, ci])
    g = torch.stack(gs, dim=2)
    # 3. the chunk-parallel outputs
    p = ar.mm(dyc, t(c.v))
    dp = (dyc * c.v).sum(-1, keepdim=True)
    att = scores(c, ar)
    bon = (c.r * u[None, :, None, None, :] * c.k).sum(-1, keepdim=True)
    dv = ar.mm(t(att), dyc) + ar.mm(c.k * c.f, g) + bon * dyc
    dr_in = torch.zeros_like(c.r)
    dk_in = torch.zeros_like(c.k)
    for tile in range(c.nt):
        rows = slice(TILE * tile, TILE * tile + TILE)
        w = _diag_decay(c, rows)
        pt = p[..., rows, rows, None]
        dr_in[..., rows, :] += (w * c.k[..., None, rows, :] * pt).sum(-2)
        dk_in[..., rows, :] += (w * c.r[..., rows, None, :] * pt).sum(-3)
        if not tile:
            continue
        ref = _ref(c, tile)
        dr_in[..., rows, :] += torch.exp(c.cin[..., rows, :] - ref) * ar.mm(
            p[..., rows, :TILE * tile], _kp(c, tile, TILE * tile))
        for col in range(tile):
            cols = slice(TILE * col, TILE * col + TILE)
            dk_in[..., cols, :] += torch.exp(ref - c.cum[..., cols, :]) * \
                ar.mm(t(p[..., rows, cols]), _rp(c, tile))
    dks = c.f * ar.mm(c.v, t(g))
    dr_tot = dr_in + c.e_in * ar.mm(dyc, t(carries))
    dk_tot = dk_in + dks
    uu = u[None, :, None, None, :]
    dr, dk = dr_tot + uu * c.k * dp, dk_tot + uu * c.r * dp
    dcin, dcum = c.r * dr_tot, -(c.k * dk_tot)
    dcum[..., c.q - 1, :] += ((c.k * dks).sum(-2)
                              + c.alpha * (carries * g).sum(-1))
    total = dcum + dcin
    dlw = total.flip(-2).cumsum(-2).flip(-2) - dcin
    du = (c.r * c.k * dp).sum((2, 3))
    return (*(_unpad(x, c) for x in (dr, dk, dv, dlw)), du)


def sequential(r, k, v, lw, u, q):
    """The recurrence a step at a time: y_t = r_t S + (r_t . (u o k_t)) v_t,
    S <- diag(exp(log_w_t)) S + k_t v_t^T.  Returns y, the final state and
    the states entering each chunk of q."""
    bsz, h, s, d = r.shape
    state = torch.zeros(bsz, h, d, d, dtype=r.dtype)
    ys, carries = [], []
    for i in range(s):
        if i % q == 0:
            carries.append(state)
        rt, kt, vt = r[:, :, i], k[:, :, i], v[:, :, i]
        bonus = (rt * u * kt).sum(-1, keepdim=True)
        ys.append((rt[..., None] * state).sum(-2) + bonus * vt)
        state = (torch.exp(lw[:, :, i])[..., None] * state
                 + kt[..., None] * vt[..., None, :])
    return torch.stack(ys, dim=2), state, torch.stack(carries, dim=2)


def _inputs(seed: int, s: int, fast: bool = False):
    """fp32 r, k, v (B, H, S, D); log_w = -exp(N(0, 0.5^2)) (the model at
    init), or -54.6 plus noise of 0.01; u (H, D) of scale 0.5; the
    cotangents dy, dstate."""
    rng = np.random.default_rng(seed)
    randn = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    r, k, v = (randn(B, H, s, D) for _ in range(3))
    noise = randn(B, H, s, D)
    lw = FAST_DECAY + 0.01 * noise if fast else -np.exp(0.5 * noise)
    u = 0.5 * randn(H, D)
    dy, dstate = randn(B, H, s, D), randn(B, H, D, D)
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32))
            for x in (r, k, v, lw, u, dy, dstate)]


def _truth(xs, q):
    """fp64 y, state, carries and the five backward outputs (du summed over
    B), by autograd through the sequential recurrence."""
    r, k, v, lw, u, dy, dstate = (x.double() for x in xs)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, lw, u)]
    y, state, carries = sequential(*leaves, q)
    grads = torch.autograd.grad((y * dy).sum() + (state * dstate).sum(),
                                leaves)
    return (y.detach(), state.detach(), carries.detach()), grads


def _rel(got, ref, scale=None) -> float:
    """max |got - ref| over ``scale`` (default max |ref|; a zero ref, such
    as the first chunk's carry, must be met exactly)."""
    scale = ref.double().abs().max() if scale is None else scale
    return ((got.double() - ref.double()).abs().max()
            / max(float(scale), 1e-30)).item()


def _dlw_scale(r, k, grads) -> float:
    """d_log_w's scale, as ``chip_smoke.py`` takes it: it is a suffix sum
    of differences of r dr and k dk terms (near 0 under fast decay while
    they are not)."""
    dr, dk, _, dlw = grads[:4]
    return max(dlw.abs().max().item(), (r.double() * dr).abs().max().item(),
               (k.double() * dk).abs().max().item())


CASES = {"init": (256, 64, False), "fast": (256, 64, True),
         "chunk40": (240, 40, False)}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    s, q, fast = CASES[request.param]
    xs = _inputs(18 + len(request.param), s, fast)
    assert (xs[3].max().item() < -50) == fast
    return types.SimpleNamespace(xs=xs, q=q, truth=_truth(xs, q),
                                 rtol=WKV_FAST_RTOL if fast else WKV_RTOL)


NAMES_FWD = ("y", "state", "carries")
NAMES_BWD = ("dr", "dk", "dv", "dlw", "du")


def _check_bwd(got, ref, r, k, limit, what):
    scales = (None, None, None, _dlw_scale(r, k, ref), None)
    for name, g, e, sc in zip(NAMES_BWD, got, ref, scales):
        assert bool(torch.isfinite(g).all()), (what, name)
        assert _rel(g, e, sc) <= limit, (what, name, _rel(g, e, sc))


def test_tf32_split_recovers_fp32():
    one = torch.tensor([1.0 / 3.0, -7.123456, 1e-30])
    hi, lo = split_tf32(one)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    assert ((hi.double() + lo.double() - one.double()).abs()
            <= 2.0 ** -21 * one.double().abs()).all()


def test_three_passes_equal_the_sequential_recurrence(case, jx):
    """Exact products in fp64: the chunk-local states, the passing and the
    chunk-parallel outputs with the 16-row factorization give the fp64
    recurrence's y, final state, carries and all five backward outputs to
    fp64 rounding, and the JAX package's (fp32) oracle's y and state to
    fp32 rounding."""
    r, k, v, lw, u, dy, dstate = (x.double() for x in case.xs)
    fwd = three_pass_fwd(r, k, v, lw, u, case.q, EXACT)
    for name, got, ref in zip(NAMES_FWD, fwd, case.truth[0]):
        assert _rel(got, ref) <= 1e-10, name
    bwd = three_pass_bwd(r, k, v, lw, u, fwd[2], dy, dstate, case.q, EXACT)
    _check_bwd(bwd, case.truth[1], r, k, 1e-10, "three passes")
    oracle = jx.sequential(*(jx.jnp.asarray(x.numpy()) for x in case.xs[:5]))
    for name, got, ref in zip(NAMES_FWD, fwd, oracle):
        assert _rel(got, torch.from_numpy(np.array(ref))) <= 1e-5, name


def test_autograd_through_the_decomposition(case):
    """fp64 autograd through the three-pass forward (the factored
    off-diagonal tiles included) gives the recurrence's five gradients."""
    leaves = [x.double().clone().requires_grad_() for x in case.xs[:5]]
    dy, dstate = (x.double() for x in case.xs[5:])
    y, state, _ = three_pass_fwd(*leaves, case.q, EXACT)
    grads = torch.autograd.grad((y * dy).sum() + (state * dstate).sum(),
                                leaves)
    _check_bwd(grads, case.truth[1], leaves[0].detach(), leaves[1].detach(),
               1e-10, "autograd")


def test_kernel_arithmetic_forward_within_a_tenth_of_the_limit(case, jx):
    """y, the final state and the carries in the kernels' arithmetic
    against the fp64 recurrence and against the JAX kernel (interpret
    mode, with carries): within a tenth of the card's limit."""
    r, k, v, lw, u = case.xs[:5]
    got = three_pass_fwd(r, k, v, lw, u, case.q, KERNEL)
    ref = jx.fwd(*(jx.jnp.asarray(x.numpy()) for x in (r, k, v, lw, u)),
                 chunk=case.q, interpret=True, return_carries=True)
    for name, g, truth, e in zip(NAMES_FWD, got, case.truth[0], ref):
        assert g.dtype == F32 and bool(torch.isfinite(g).all()), name
        assert _rel(g, truth) <= ROOM * case.rtol, (name, _rel(g, truth))
        e = torch.from_numpy(np.array(e))
        assert _rel(g, e) <= ROOM * case.rtol, (name, _rel(g, e))


def test_kernel_arithmetic_backward_within_a_tenth_of_the_limit(case, jx):
    """dr, dk, dv, d_log_w and du in the kernels' arithmetic, from the
    emulated carries, against the fp64 recurrence's autograd and against
    the JAX backward kernel (interpret mode) on the same carries: within a
    tenth of the card's limit."""
    r, k, v, lw, u, dy, dstate = case.xs
    carries = three_pass_fwd(r, k, v, lw, u, case.q, KERNEL)[2]
    got = three_pass_bwd(r, k, v, lw, u, carries, dy, dstate, case.q, KERNEL)
    assert all(g.dtype == F32 for g in got)
    _check_bwd(got, case.truth[1], r, k, ROOM * case.rtol, "fp64 truth")
    ref = jx.bwd(*(jx.jnp.asarray(x.numpy()) for x in (
        r, k, v, lw, u, carries, dy, dstate)), chunk=case.q, interpret=True)
    ref = [torch.from_numpy(np.array(x)) for x in ref]
    ref[4] = ref[4].sum(0)
    _check_bwd(got, ref, r, k, ROOM * case.rtol, "JAX kernel")


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


def _card_inputs(cuda, b, s, seed, h=8):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, device=cuda, generator=gen)
    r, k, v = (randn(b, h, s, D) for _ in range(3))
    lw = -torch.exp(0.5 * randn(b, h, s, D))
    return [r, k, v, lw, 0.5 * randn(h, D), randn(b, h, s, D),
            randn(b, h, D, D)]


@pytest.mark.gpu
def test_cuda_wkv6_backward_runs_are_bit_identical(cuda):
    """No atomics, du summed over the chunks in a fixed order: two backward
    calls at 2 x 1024 give the same bits."""
    r, k, v, lw, u, dy, dstate = _card_inputs(cuda, 2, 1024, 9)
    _, _, carries = wkv6_fwd(r, k, v, lw, u, chunk=64, return_carries=True)
    first = wkv6_bwd(r, k, v, lw, u, carries, dy, dstate, chunk=64)
    second = wkv6_bwd(r, k, v, lw, u, carries, dy, dstate, chunk=64)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_cuda_wkv6_chunk_below_a_tile(cuda):
    """S = 40 in chunks of 8 (half a 16-row tile, zero-padded): the
    forward with carries and the backward within WKV_RTOL of the plain
    versions'."""
    r, k, v, lw, u, dy, dstate = _card_inputs(cuda, 2, 40, 40)
    got = wkv6_fwd(r, k, v, lw, u, chunk=8, return_carries=True)
    ref = wkv6_fwd_plain(r, k, v, lw, u, chunk=8, return_carries=True)
    grads = wkv6_bwd(r, k, v, lw, u, ref[2], dy, dstate, chunk=8)
    plain = wkv6_bwd_plain(r, k, v, lw, u, ref[2], dy, dstate, chunk=8)
    for g, e in zip(got + grads, ref + plain):
        assert _rel(g, e) <= WKV_RTOL


@pytest.mark.gpu
def test_cuda_wkv6_through_the_padding_wrapper(cuda):
    """S = 300 through ``wkv6`` (zero-padded to 320, sliced back) and the
    WKV6 Function: y, state and the five gradients within WKV_RTOL of
    autograd through the plain forward on the same padding (d_log_w
    against its scale, as ``chip_smoke.py`` takes it)."""
    r, k, v, lw, u, dy, dstate = _card_inputs(cuda, 2, 300, 300)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, lw, u)]
    y, state = wkv6(*leaves, chunk=64)
    got = [y, state, *torch.autograd.grad(
        (y * dy).sum() + (state * dstate).sum(), leaves)]
    plain = [x.clone().requires_grad_() for x in (r, k, v, lw, u)]
    py, pstate = wkv6_fwd_plain(*(F.pad(x, (0, 0, 0, 20)) for x in plain[:4]),
                                plain[4], chunk=64)
    py = py[:, :, :300]
    ref = [py, pstate, *torch.autograd.grad(
        (py * dy).sum() + (pstate * dstate).sum(), plain)]
    scales = [None] * 5 + [_dlw_scale(r, k, ref[2:]), None]
    for g, e, sc in zip(got, ref, scales):
        assert _rel(g, e, sc) <= WKV_RTOL
