"""The SSD kernels' three-pass design and product arithmetic, emulated on
the host.

``csrc/ssd.cu`` runs each direction as three passes: chunk-local states
(L_c = B_c^T diag(exp(cum_Q - cum) dt) x_c, or in the backward K_c =
C_c^T diag(exp(cum)) dy_c), the state passing across chunks in fp32
round-to-nearest (S_{c+1} = exp(cum_Q) S_c + L_c; G_{c-1} = exp(cum_Q) G_c
+ K_c from G_{nc-1} = dstate), and the chunk-parallel outputs from the
inputs, S_c and G_c.  Every product runs on the tensor cores: fp32
operands split into TF32 hi and lo (``cvt.rna``), a product as a_lo b_hi
+ a_hi b_lo + a_hi b_hi, each MMA's sum over its 8-step truncated, and no
accumulator over more than one chunk's rows; the decay-masked tiles stay
fp32 and are split.

Here the same passes run in plain PyTorch on the CPU, at B 1, H 2, S 256,
chunk 128, N = P = 64, from a numpy seed:

* in fp64 with exact products, the decomposition equals the sequential
  per-step scan (and autograd through it) to rounding;
* in the kernels' arithmetic, every output keeps within a tenth of the
  limits ``chip_smoke.py`` holds the kernels to on the card (``SSD_RTOL``
  1e-4 of the largest entry; ``SSD_DEEP_RTOL`` 2e-3 where cum passes
  -1000 within a chunk) of the fp64 scan and of the JAX kernels in
  interpret mode.

The tests marked ``gpu`` hold the kernels below a chunk (S = 40), through
the padding wrapper (S = 300) and two backward runs bit for bit on the
card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssd_split.py
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd import (ssd, ssd_bwd, ssd_bwd_plain, ssd_fwd,
                                     ssd_fwd_plain)

F32 = torch.float32
SSD_RTOL = 1e-4       # chip_smoke.py: each output, of its largest entry
SSD_DEEP_RTOL = 2e-3  # chip_smoke.py: cum past -1000 within a chunk
ROOM = 0.1            # the share of those limits the arithmetic may use
B, H, S, Q, N, P = 1, 2, 256, 128, 64, 64


@pytest.fixture(scope="module")
def jx():
    """The JAX package's SSD kernels (skips where JAX is absent)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssd.kernel import ssd_bwd as jssd_bwd
    from repro.kernels.ssd.kernel import ssd_fwd as jssd_fwd
    return types.SimpleNamespace(jnp=jnp, fwd=jssd_fwd, bwd=jssd_bwd)


# ---------------------------------------------------------------------------
# the kernels' rounding (as tests/test_torch_flash_split.py models it)
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

def _chunks(x, dt, a, b_in, c_in, q):
    bsz, h, s, p = x.shape
    nc, n = s // q, b_in.shape[-1]
    dtc = dt.reshape(bsz, h, nc, q)
    cum = torch.cumsum(dtc * a[None, :, None, None], dim=-1)
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    gap = (cum[..., :, None] - cum[..., None, :]).masked_fill(~causal, 0.0)
    return types.SimpleNamespace(
        x=x.reshape(bsz, h, nc, q, p), dt=dtc, cum=cum,
        b=b_in.reshape(bsz, 1, nc, q, n), c=c_in.reshape(bsz, 1, nc, q, n),
        e=torch.exp(cum), f=torch.exp(cum[..., -1:] - cum),
        alpha=torch.exp(cum[..., -1]), nc=nc,
        decay=torch.exp(gap) * causal)


def three_pass_fwd(x, dt, a, b_in, c_in, q, ar):
    """(y, final state, carries) by the kernels' passes in the arithmetic
    ``ar`` (KERNEL or EXACT)."""
    k = _chunks(x, dt, a, b_in, c_in, q)
    t = lambda m: m.transpose(-1, -2)
    # 1. chunk-local states, one accumulator over the chunk's rows
    local = ar.mm(t(k.b * (k.f * k.dt)[..., None]), k.x)
    # 2. state passing in round-to-nearest
    run = torch.zeros_like(local[:, :, 0])
    carries = []
    for c in range(k.nc):
        carries.append(run)
        run = ar.fma(k.alpha[..., c, None, None], run, local[:, :, c])
    carries = torch.stack(carries, dim=2)
    # 3. y: (C B^T o decay) diag(dt) x, plus e o (C S_c) in its own
    #    accumulator
    m = ar.mm(k.c, t(k.b)) * k.decay * k.dt[..., None, :]
    y = ar.fma(k.e[..., None], ar.mm(k.c, carries), ar.mm(m, k.x))
    return y.reshape(x.shape), run, carries


def three_pass_bwd(x, dt, a, b_in, c_in, carries, dy, dstate, q, ar):
    """(dx, ddt, dlog, db_h, dc_h) by the kernels' passes."""
    k = _chunks(x, dt, a, b_in, c_in, q)
    t = lambda m: m.transpose(-1, -2)
    dyc = dy.reshape(k.x.shape)
    # 1. chunk-local cotangents
    local = ar.mm(t(k.c * k.e[..., None]), dyc)
    # 2. reverse passing from dstate
    run, gs = dstate, [None] * k.nc
    for c in reversed(range(k.nc)):
        gs[c] = run
        run = ar.fma(k.alpha[..., c, None, None], run, local[:, :, c])
    g = torch.stack(gs, dim=2)
    # 3. everything of the reference's per-chunk backward
    scores = ar.mm(k.c, t(k.b))
    w = ar.mm(dyc, t(k.x)) * k.decay * k.dt[..., None, :]
    tt = scores * w
    m = scores * k.decay
    dcs = k.e[..., None] * ar.mm(dyc, t(carries))
    dc = ar.mm(w, k.b) + dcs
    dbs = (k.f * k.dt)[..., None] * ar.mm(k.x, t(g))
    db = ar.mm(t(w), k.c) + dbs
    dxdt = ar.fma(k.f[..., None], ar.mm(k.b, g), ar.mm(t(m), dyc))
    u = (k.b * dbs).sum(-1)
    dcum = tt.sum(-1) - tt.sum(-2) + (k.c * dcs).sum(-1) - u
    dcum[..., -1] += u.sum(-1) + k.alpha * (carries * g).sum((-1, -2))
    dlog = dcum.flip(-1).cumsum(-1).flip(-1)
    ddt = a[None, :, None, None] * dlog + (dxdt * k.x).sum(-1)
    bsz, h, s, p = x.shape
    return (dxdt * k.dt[..., None]).reshape(x.shape), ddt.reshape(bsz, h, s),\
        dlog.reshape(bsz, h, s), db.reshape(bsz, h, s, -1), \
        dc.reshape(bsz, h, s, -1)


def sequential(x, dt, log_decay, b_h, c_h):
    """The scan a step at a time: S_t = exp(log_decay_t) S_{t-1} + B_t^T
    (x_t dt_t), y_t = C_t S_t; per-head B, C (B, H, S, N).  Returns y, the
    final state and the states entering each chunk of Q."""
    bsz, h, s, p = x.shape
    state = torch.zeros(bsz, h, b_h.shape[-1], p, dtype=x.dtype)
    ys, carries = [], []
    for i in range(s):
        if i % Q == 0:
            carries.append(state)
        state = (torch.exp(log_decay[..., i])[..., None, None] * state
                 + b_h[:, :, i, :, None] * (x[:, :, i] * dt[..., i, None])
                 [:, :, None, :])
        ys.append((c_h[:, :, i, :, None] * state).sum(-2))
    return torch.stack(ys, dim=2), state, torch.stack(carries, dim=2)


def _inputs(seed: int, deep: bool = False):
    """fp32 x (B, H, S, P), dt = softplus(N(0, 1)) (deep: + 4), a =
    -exp(N(0, 0.5^2)) (deep: - 2, so cum passes -1000 within a chunk), B,
    C (B, S, N) of scale 0.5; cotangents dy, dstate."""
    rng = np.random.default_rng(seed)
    randn = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x = randn(B, H, S, P)
    dt = np.log1p(np.exp(randn(B, H, S) + (4.0 if deep else 0.0)))
    a = -np.exp(0.5 * randn(H)) - (2.0 if deep else 0.0)
    b_in, c_in = 0.5 * randn(B, S, N), 0.5 * randn(B, S, N)
    dy, dstate = randn(B, H, S, P), randn(B, H, N, P)
    return [torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for v in (x, dt, a, b_in, c_in, dy, dstate)]


def _truth(x, dt, a, b_in, c_in, dy, dstate):
    """fp64 y, state, carries and the five backward outputs, by autograd
    through the sequential scan."""
    x, dt, a, dy, dstate = (v.double() for v in (x, dt, a, dy, dstate))
    leaves = [x.clone().requires_grad_(), dt.clone().requires_grad_(),
              (dt * a[None, :, None]).requires_grad_(),
              b_in.double()[:, None].expand(-1, H, -1, -1).clone()
              .requires_grad_(),
              c_in.double()[:, None].expand(-1, H, -1, -1).clone()
              .requires_grad_()]
    y, state, carries = sequential(*leaves)
    dx, ddt, dlog, db_h, dc_h = torch.autograd.grad(
        (y * dy).sum() + (state * dstate).sum(), leaves)
    ddt = ddt + a[None, :, None] * dlog  # the total derivative through dt
    return ((y.detach(), state.detach(), carries.detach()),
            (dx, ddt, dlog, db_h, dc_h))


def _rel(got, ref) -> float:
    """max |got - ref| over max |ref| (a zero ref, such as the one chunk's
    carry, must be met exactly)."""
    return ((got.double() - ref.double()).abs().max()
            / ref.double().abs().max().clamp_min(1e-30)).item()


@pytest.fixture(scope="module", params=["normal", "deep"])
def case(request):
    deep = request.param == "deep"
    xs = _inputs(17 + deep, deep)
    cum = (xs[1][..., :Q] * xs[2][None, :, None]).sum(-1)
    assert (cum.min().item() < -1000) == deep
    return types.SimpleNamespace(xs=xs, truth=_truth(*xs), deep=deep,
                                 rtol=SSD_DEEP_RTOL if deep else SSD_RTOL)


NAMES_FWD = ("y", "state", "carries")
NAMES_BWD = ("dx", "ddt", "dlog", "db_h", "dc_h")


def test_tf32_split_recovers_fp32():
    one = torch.tensor([1.0 / 3.0, -7.123456, 1e-30])
    hi, lo = split_tf32(one)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    assert ((hi.double() + lo.double() - one.double()).abs()
            <= 2.0 ** -21 * one.double().abs()).all()


def test_three_passes_equal_the_sequential_scan(case):
    """Exact products in fp64: the chunk-local states, the passing and
    the chunk-parallel outputs give the sequential scan's y, final state,
    carries and all five backward outputs to fp64 rounding."""
    x, dt, a, b_in, c_in, dy, dstate = (v.double() for v in case.xs)
    fwd = three_pass_fwd(x, dt, a, b_in, c_in, Q, EXACT)
    bwd = three_pass_bwd(x, dt, a, b_in, c_in, fwd[2], dy, dstate, Q, EXACT)
    for name, got, ref in zip(NAMES_FWD + NAMES_BWD, fwd + bwd,
                              case.truth[0] + case.truth[1]):
        assert _rel(got, ref) <= 1e-10, name


def test_kernel_arithmetic_forward_within_a_tenth_of_the_limit(case, jx):
    """y, the final state and the carries in the kernels' arithmetic
    against the fp64 scan and against the JAX kernel (interpret mode,
    with carries): within a tenth of the card's limit."""
    x, dt, a, b_in, c_in = case.xs[:5]
    got = three_pass_fwd(x, dt, a, b_in, c_in, Q, KERNEL)
    ref = jx.fwd(*(jx.jnp.asarray(v.numpy()) for v in (x, dt, a, b_in,
                                                       c_in)),
                 chunk=Q, interpret=True, return_carries=True)
    for name, g, truth, r in zip(NAMES_FWD, got, case.truth[0], ref):
        assert g.dtype == F32 and bool(torch.isfinite(g).all()), name
        assert _rel(g, truth) <= ROOM * case.rtol, (name, _rel(g, truth))
        assert _rel(g, torch.from_numpy(np.array(r))) <= ROOM * case.rtol, \
            name


def test_kernel_arithmetic_backward_within_a_tenth_of_the_limit(case, jx):
    """dx, ddt, dlog and the per-head dB, dC in the kernels' arithmetic,
    from the emulated carries, against the fp64 scan's autograd and
    against the JAX backward kernel (interpret mode) on the same carries:
    within a tenth of the card's limit."""
    x, dt, a, b_in, c_in, dy, dstate = case.xs
    carries = three_pass_fwd(x, dt, a, b_in, c_in, Q, KERNEL)[2]
    got = three_pass_bwd(x, dt, a, b_in, c_in, carries, dy, dstate, Q,
                         KERNEL)
    ref = jx.bwd(*(jx.jnp.asarray(v.numpy()) for v in (
        x, dt, a, b_in, c_in, carries, dy, dstate)), chunk=Q,
        interpret=True)
    for name, g, truth, r in zip(NAMES_BWD, got, case.truth[1], ref):
        assert g.dtype == F32 and bool(torch.isfinite(g).all()), name
        assert _rel(g, truth) <= ROOM * case.rtol, (name, _rel(g, truth))
        assert _rel(g, torch.from_numpy(np.array(r))) <= ROOM * case.rtol, \
            name


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
    x, raw = randn(b, h, s, P), randn(b, h, s)
    a = -torch.exp(0.5 * randn(h))
    return [x, torch.nn.functional.softplus(raw), a, 0.5 * randn(b, s, N),
            0.5 * randn(b, s, N), randn(b, h, s, P), randn(b, h, N, P)]


@pytest.mark.gpu
def test_cuda_ssd_backward_runs_are_bit_identical(cuda):
    """No atomics: two backward calls at 2 x 1024 give the same bits."""
    x, dt, a, b_in, c_in, dy, dstate = _card_inputs(cuda, 2, 1024, 9)
    _, _, carries = ssd_fwd(x, dt, a, b_in, c_in, chunk=Q,
                            return_carries=True)
    first = ssd_bwd(x, dt, a, b_in, c_in, carries, dy, dstate, chunk=Q)
    second = ssd_bwd(x, dt, a, b_in, c_in, carries, dy, dstate, chunk=Q)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.gpu
def test_cuda_ssd_below_a_chunk(cuda):
    """S = 40 (the chunk clamped to 40, a ragged last 16-row tile): the
    forward with carries and the backward within SSD_RTOL of the plain
    versions'."""
    x, dt, a, b_in, c_in, dy, dstate = _card_inputs(cuda, 2, 40, 40)
    got = ssd_fwd(x, dt, a, b_in, c_in, chunk=Q, return_carries=True)
    ref = ssd_fwd_plain(x, dt, a, b_in, c_in, chunk=Q, return_carries=True)
    grads = ssd_bwd(x, dt, a, b_in, c_in, ref[2], dy, dstate, chunk=40)
    plain = ssd_bwd_plain(x, dt, a, b_in, c_in, ref[2], dy, dstate,
                          chunk=40)
    for g, r in zip(got + grads, ref + plain):
        assert _rel(g, r) <= SSD_RTOL


@pytest.mark.gpu
def test_cuda_ssd_through_the_padding_wrapper(cuda):
    """S = 300 through ``ssd`` (zero-padded to 384, sliced back) and the
    SSD Function: y, state and the five gradients within SSD_RTOL of
    autograd through the plain forward on the same padding."""
    x, dt, a, b_in, c_in, dy, dstate = _card_inputs(cuda, 2, 300, 300)
    leaves = [v.clone().requires_grad_() for v in (x, dt, a, b_in, c_in)]
    y, state = ssd(*leaves, chunk=Q)
    got = [y, state, *torch.autograd.grad(
        (y * dy).sum() + (state * dstate).sum(), leaves)]
    pad = lambda v, d: torch.nn.functional.pad(v, d)
    plain = [v.clone().requires_grad_() for v in (x, dt, a, b_in, c_in)]
    py, pstate = ssd_fwd_plain(pad(plain[0], (0, 0, 0, 84)),
                               pad(plain[1], (0, 84)), plain[2],
                               pad(plain[3], (0, 0, 0, 84)),
                               pad(plain[4], (0, 0, 0, 84)), chunk=Q)
    py = py[:, :, :300]
    ref = [py, pstate, *torch.autograd.grad(
        (py * dy).sum() + (pstate * dstate).sum(), plain)]
    for g, r in zip(got, ref):
        assert _rel(g, r) <= SSD_RTOL
