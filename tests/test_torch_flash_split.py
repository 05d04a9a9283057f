"""The flash-attention kernels' product arithmetic, emulated on the host.

``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu`` run
every product on the tensor cores:

* fp32 operands as error-compensated TF32: each x is split into
  hi = tf32(x) and lo = tf32(x - hi), rounded to nearest with ties away
  from zero (``cvt.rna.tf32.f32``), and a product is
  a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in fp32 8-step by 8-step;
* bf16 operands as they are (exact in TF32 and in bf16 products);
* the fp32 probabilities P (and dS) never rounded once: split into a bf16
  hi and lo part against bf16 V in the bf16 forward (two products a
  16-step), into TF32 hi and lo everywhere else;
* each MMA's sum rounded toward zero, as the tensor cores truncate it, and
  each streamed tile's product (P V over 64 keys, dS K, dS^T Q and P^T dO
  over the backward's tiles) taken in a fresh accumulator that is added to
  the running sum in round-to-nearest fp32, as the kernels do.

Here that arithmetic runs in plain PyTorch on the CPU, at a reduced shape
drawn from a numpy seed, against the same function in fp64 and against
the port's plain versions.  It shows the fixed limits the card's checks
hold the kernels to (``chip_smoke.py``: 2e-5 on o and lse, bf16 o within
2 bf16 ulps, each gradient within 1e-4 of its plain leaf's largest entry)
hold with a tenth of the room or less used (a fifth for the fp32 forward
at D = 128), and that they would not with one truncating accumulator
carried over all S.  The tests marked ``gpu``
hold the kernels themselves at head dim 128, and two backward runs bit
for bit, on the card.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_fwd,
                                                 flash_attention_fwd_plain)

F32, BF16 = torch.float32, torch.bfloat16


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 stored mantissa bits) to nearest, ties away
    from zero, by masking the bits as ``cvt.rna.tf32.f32`` rounds them."""
    bits = x.to(F32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(F32)


def split_tf32(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def split_bf16(x: torch.Tensor):
    hi = x.to(BF16).to(F32)
    return hi, (x - hi).to(BF16).to(F32)


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """fp64 to fp32, truncated: the tensor cores' rounding of a sum."""
    r = x.to(F32)
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def mma(a: torch.Tensor, b: torch.Tensor, a_kind: str, b_kind: str,
        step: int = 8, tile: int | None = None) -> torch.Tensor:
    """a @ b (batched) in the kernels' arithmetic.  A kind names how an
    operand enters: "f32" split into TF32 hi + lo, "exact" as it is (bf16
    values), "bf16split" split into bf16 hi + lo.  Each MMA adds the exact
    products of its k-step (8 for TF32, 16 for bf16) to its accumulator and
    truncates the sum to fp32, the small terms first.  Every ``tile`` of k
    (None: all of k) goes to a fresh accumulator, added to the result in
    round-to-nearest fp32."""
    def parts(x, kind):
        x = x.to(F32)
        if kind == "exact":
            return x, None
        return split_tf32(x) if kind == "f32" else split_bf16(x)
    ah, al = parts(a, a_kind)
    bh, bl = parts(b, b_kind)
    terms = [(x.double(), y.double()) for x, y in ((al, bh), (ah, bl),
                                                   (ah, bh))
             if x is not None and y is not None]
    n = a.shape[-1]
    tile = tile or n
    c = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=F32)
    for t0 in range(0, n, tile):
        frag = torch.zeros_like(c)
        for k0 in range(t0, min(t0 + tile, n), step):
            ks = slice(k0, k0 + step)
            for x, y in terms:
                frag = round_toward_zero(frag.double()
                                         + x[..., ks] @ y[..., ks, :])
        c = c + frag
    return c


def _mask(s: int) -> torch.Tensor:
    col = torch.arange(s)
    return col[None, :] <= col[:, None]


def emulated_fwd(q, k, v, one_accumulator: bool = False):
    """(o fp32 before the cast to the input dtype, lse) as the forward
    kernel computes them, causal: P V in a fresh accumulator every kv tile
    of 64 keys, or with ``one_accumulator`` carried over all S."""
    exact = q.dtype == BF16
    d = q.shape[-1]
    kind = "exact" if exact else "f32"
    sc = mma(q, k.transpose(1, 2), kind, kind, 16 if exact else 8)
    sc = sc * (1.0 / math.sqrt(d))
    sc = sc.masked_fill(~_mask(q.shape[1]), -1e30)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m) * _mask(q.shape[1])
    l = p.sum(-1, keepdim=True)
    tile = None if one_accumulator else 64
    o = (mma(p, v, "bf16split", "exact", 16, tile) if exact
         else mma(p, v, "f32", "f32", 8, tile))
    return o / l, (m + torch.log(l))[..., 0]


def emulated_bwd(q, k, v, lse, do, one_accumulator: bool = False):
    """(dq, dk, dv) fp32 as the three backward kernels compute them: every
    product in TF32, bf16 inputs exact, P and dS split; the products over
    the streamed tiles (dQ: keys, 32 a tile in fp32 and 64 in bf16; dK/dV:
    queries, 32 a tile but 64 in bf16 at D = 64) each in a fresh
    accumulator, or with ``one_accumulator`` carried over all S, in the
    forward's o (and so delta) too."""
    bf = q.dtype == BF16
    kind = "exact" if bf else "f32"
    scale = 1.0 / math.sqrt(q.shape[-1])
    kn = None if one_accumulator else 64 if bf else 32
    bn = None if one_accumulator else 64 if bf and q.shape[-1] == 64 else 32
    t = lambda x: x.transpose(1, 2)
    sc = mma(q, t(k), kind, kind)
    p = torch.exp(sc * scale - lse[..., None]) * _mask(q.shape[1])
    o = emulated_fwd(q, k, v, one_accumulator)[0]
    delta = (o * do.to(F32)).sum(-1)
    ds = p * (mma(do, t(v), kind, kind) - delta[..., None])
    dq = mma(ds, k, "f32", kind, 8, kn) * scale
    dk = mma(t(ds), q, "f32", kind, 8, bn) * scale
    dv = mma(t(p), do, "f32", kind, 8, bn)
    return dq, dk, dv


def fp64_fwd(q, k, v):
    q, k, v = (x.double() for x in (q, k, v))
    sc = (q @ k.transpose(1, 2)) / math.sqrt(q.shape[-1])
    sc = sc.masked_fill(~_mask(q.shape[1]), -math.inf)
    lse = torch.logsumexp(sc, -1)
    return torch.exp(sc - lse[..., None]) @ v, lse


def fp64_bwd(q, k, v, do):
    q, k, v, do = (x.double().requires_grad_(False) for x in (q, k, v, do))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o, _ = fp64_fwd(*leaves)
    return torch.autograd.grad(o, leaves, do)


def _inputs(dtype, d, seed, bh=2, s=96):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, s, d),
                                                 dtype=np.float32)).to(dtype)
            for _ in range(4)]


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp (8 significant bits) at |x|."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                      - 7)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = torch.tensor([1.0])
    step = 2.0 ** -10  # TF32 spacing at 1
    x = torch.tensor([1 + step / 2, -(1 + step / 2), 1 + step / 2 - 2 ** -23,
                      1 + 3 * step / 2, 3.0, 0.0], dtype=F32)
    want = torch.tensor([1 + step, -(1 + step), 1.0, 1 + 2 * step, 3.0, 0.0])
    assert torch.equal(tf32_rna(x), want)
    hi, lo = split_tf32(one / 3)
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    assert abs((hi + lo - one / 3).item()) <= 2.0 ** -22 / 3


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_split_products_against_fp64(dtype, d):
    """Q K^T and P V in the kernels' arithmetic: each entry within 2^-20
    (Q K^T in fp32), 2^-19 (P V in fp32) or the bf16 split's 2^-16 (P V,
    bf16) of the entry's sum of magnitudes, against fp64.  The split itself
    leaves ~2^-21; fp32 P V takes three truncating sums a key step over a
    tile of 64 keys, which reads up to 1.9 x 2^-20 here."""
    q, k, v, _ = _inputs(dtype, d, seed=d)
    exact = dtype == BF16
    kind = "exact" if exact else "f32"
    kt = k.transpose(1, 2)
    sc = mma(q, kt, kind, kind, 16 if exact else 8)
    ref = q.double() @ kt.double()
    mag = q.double().abs() @ kt.double().abs()
    assert ((sc.double() - ref).abs() <= 2.0 ** -20 * mag).all()
    p = torch.softmax(sc.masked_fill(~_mask(q.shape[1]), -1e30), -1)
    pv = (mma(p, v, "bf16split", "exact", 16, 64) if exact
          else mma(p, v, "f32", "f32", 8, 64))
    ref = p.double() @ v.double()
    mag = p.double() @ v.double().abs()
    room = 2.0 ** -16 if exact else 2.0 ** -19
    assert ((pv.double() - ref).abs() <= room * mag).all()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_split_forward_holds_the_card_limits_with_room(dtype, d):
    """o and lse: fp32 within a tenth of the card's 2e-5 of fp64 and of the
    plain version, a fifth at D = 128 (Q K^T there carries one truncating
    accumulator over 16 k-steps of three products: 0.16 of the room here);
    bf16 o (before its rounding to bf16) within a tenth of the card's bf16
    limit, so the rounded o keeps to it."""
    q, k, v, _ = _inputs(dtype, d, seed=100 + d)
    o, lse = emulated_fwd(q, k, v)
    ro, rlse = fp64_fwd(q, k, v)
    po, plse = flash_attention_fwd_plain(q, k, v)
    room = 2e-5 * (0.2 if dtype == F32 and d == 128 else 0.1)
    assert (lse.double() - rlse).abs().max().item() <= room
    assert (lse - plse).abs().max().item() <= room
    if dtype == F32:
        assert (o.double() - ro).abs().max().item() <= room
        assert (o - po).abs().max().item() <= room
    else:  # the card's bf16 limit: 2 ulps at the value plus 2e-5
        lim = 2 * _ulp(ro.float()) + 2e-5
        assert ((o.double() - ro).abs() <= 0.1 * lim).all()
        got, po = o.to(BF16).float(), po.float()
        lim = 2 * _ulp(torch.maximum(got.abs(), po.abs())) + 2e-5
        assert ((got - po).abs() <= lim).all()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_split_backward_holds_the_card_limits_with_room(dtype, d):
    """dq, dk, dv within a tenth of the card's 1e-4 of each leaf's largest
    entry, against fp64 and against the plain backward (which keeps the
    input dtype's values and computes in fp32)."""
    q, k, v, do = _inputs(dtype, d, seed=200 + d)
    _, lse = emulated_fwd(q, k, v)
    got = emulated_bwd(q, k, v, lse, do)
    ref = fp64_bwd(q, k, v, do)
    o, plse = flash_attention_fwd_plain(q.float(), k.float(), v.float())
    plain = flash_attention_bwd_plain(q.float(), k.float(), v.float(), o,
                                      plse, do.float())
    for name, a, r, p in zip(("dq", "dk", "dv"), got, ref, plain):
        scale = r.abs().max().item()
        assert (a.double() - r).abs().max().item() <= 1e-5 * scale, name
        assert (a - p).abs().max().item() <= 1e-5 * scale, name


def test_fresh_accumulator_per_tile_is_what_keeps_the_room():
    """The tensor cores truncate each MMA's sum.  Carried in one accumulator
    over all S = 1024 keys (queries), that bias takes o or a gradient past
    a tenth of the card's limits, against fp64; a fresh accumulator each
    tile, added in round-to-nearest, keeps every one within it."""
    q, k, v, do = _inputs(F32, 64, seed=7, bh=1, s=1024)
    ro, _ = fp64_fwd(q, k, v)
    ref = fp64_bwd(q, k, v, do)

    def errs(one_accumulator):
        o, lse = emulated_fwd(q, k, v, one_accumulator)
        got = emulated_bwd(q, k, v, lse, do, one_accumulator)
        return ([(o.double() - ro).abs().max().item() / 2e-5]
                + [(a.double() - r).abs().max().item()
                   / (1e-4 * r.abs().max().item())
                   for a, r in zip(got, ref)])
    assert max(errs(True)) > 0.1
    assert max(errs(False)) <= 0.1


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


def _card_inputs(dtype, d, s, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(8, s, d, device=device, generator=gen).to(dtype)
            for _ in range(4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("s", [1, 96, 427, 1024])
def test_cuda_flash_attention_head_dim_128(cuda, s, dtype):
    """The D = 128 instances against the plain versions, with the limits of
    the D = 64 tests in ``test_torch_kernels.py``, but for the absolute
    floor of the gradients: an entry that is 0 in exact arithmetic (every
    dq at S = 1) comes out of the cancellation dP - delta, two sums of D
    products carried to ~2^-21 by the TF32 splits, so the floor scales
    with D: 1e-5 at 64, 2e-5 here."""
    q, k, v, do = _card_inputs(dtype, 128, s, cuda, s)
    o, lse = flash_attention_fwd(q, k, v)
    ro, rlse = flash_attention_fwd_plain(q, k, v)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    bf = dtype == BF16
    err = (o.float() - ro.float()).abs()
    lim = 2 * _ulp(torch.maximum(o.float().abs(), ro.float().abs())) if bf \
        else 0.0
    assert bool((err <= lim + 2e-5).all())
    assert (lse - rlse).abs().max().item() <= 2e-5
    for a, r in zip(got, ref):
        err = (a.float() - r.float()).abs()
        tol = 1e-4 * r.float().abs().max().item() + 2e-5
        if bf:
            tol = tol + 2 * _ulp(torch.maximum(a.float().abs(),
                                               r.float().abs()))
        assert bool((err <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_flash_attention_bwd_is_deterministic(cuda, dtype):
    """No atomics: two backward runs on the same inputs agree bit for bit."""
    q, k, v, do = _card_inputs(dtype, 64, 1000, cuda, 7)
    o, lse = flash_attention_fwd(q, k, v)
    first = flash_attention_bwd(q, k, v, o, lse, do)
    again = flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
