"""The port's kernel modules against the JAX kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the
tensors lie on the CPU); the JAX side runs the Pallas kernels in interpret
mode, as the JAX package's own tests do.  Inputs come from numpy with a
fixed seed and feed both.  Tolerance: fp32 max abs error 1e-5, the scale
of the reference's own kernel-vs-oracle errors (3.6e-7 for flash attention,
1.6e-7 for flash decode, both fp32) with room for a different summation
order.

Tests marked ``gpu`` hold the CUDA kernels against their plain versions on
the card; the ``cuda`` fixture skips them where there is none.  The JAX
side comes through the ``jx`` fixture, so the card tests also run where
JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_fwd,
                                                 flash_attention_fwd_plain)
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_fwd,
                                              flash_decode_fwd_plain,
                                              flash_decode_partials)

TOL = 1e-5  # fp32 max abs error, see the module docstring


@pytest.fixture(scope="module")
def jx():
    """The JAX kernels' public functions (skips where JAX is absent)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.kernel import flash_attention_fwd
    from repro.kernels.flash_attention.ops import flash_attention
    from repro.kernels.flash_attention.ref import attention_reference
    from repro.kernels.flash_decode.ops import (flash_decode,
                                                flash_decode_partials)
    from repro.kernels.flash_decode.ref import decode_partials_reference
    return types.SimpleNamespace(
        jnp=jnp, flash_attention_fwd=flash_attention_fwd,
        flash_attention=flash_attention, flash_decode=flash_decode,
        flash_decode_partials=flash_decode_partials,
        attention_reference=attention_reference,
        decode_partials_reference=decode_partials_reference)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, ref, tol=TOL):
    port = port.detach().cpu().float().numpy() if torch.is_tensor(port) \
        else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref, np.float32), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("s", [1, 40, 128])
def test_flash_attention_fwd_matches_jax_kernel(jx, s):
    rng = np.random.default_rng(s)
    q, k, v = (_randn(rng, 3, s, 16) for _ in range(3))
    o, lse = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    jo, jlse = jx.flash_attention_fwd(*map(jx.jnp.asarray, (q, k, v)),
                                      causal=True, valid_len=s,
                                      interpret=True)
    _close(o, jo)
    _close(lse, jlse)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s", [1, 40, 128])
def test_flash_attention_gqa_matches_jax(jx, s, g):
    rng = np.random.default_rng(10 * s + g)
    q = _randn(rng, 2, s, 2 * g, 16)
    k, v = _randn(rng, 2, s, 2, 16), _randn(rng, 2, s, 2, 16)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)))
    ref = jx.flash_attention(*map(jx.jnp.asarray, (q, k, v)), interpret=True)
    assert out.shape == (2, s, 2 * g, 16)
    _close(out, ref)


def test_flash_attention_plain_masks_valid_len_and_agrees_with_oracle(jx):
    rng = np.random.default_rng(5)
    q, k, v = (_randn(rng, 2, 37, 16) for _ in range(3))
    o, _ = flash_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)))
    _close(o, jx.attention_reference(*map(jx.jnp.asarray, (q, k, v))))
    q, k, v = map(torch.from_numpy, (q, k, v))
    # keys at or past valid_len never contribute (non-causal case)
    o_vl, _ = flash_attention_fwd_plain(q, k, v, causal=False, valid_len=20)
    p = torch.softmax(q @ k[:, :20].transpose(1, 2) / 4.0, dim=-1)
    _close(o_vl, (p @ v[:, :20]).numpy())


def _decode_inputs(seed, g):
    rng = np.random.default_rng(seed)
    b, s, kvh, d = 5, 40, 2, 16
    q = _randn(rng, b, kvh * g, d)
    kc, vc = _randn(rng, b, s, kvh, d), _randn(rng, b, s, kvh, d)
    lengths = np.array([0, 1, 17, 39, 40], np.int32)  # empty + ragged + full
    return q, kc, vc, lengths


@pytest.mark.parametrize("g", [1, 4])
def test_flash_decode_matches_jax(jx, g):
    q, kc, vc, lengths = _decode_inputs(g, g)
    tq, tk, tv, tl = map(torch.from_numpy, (q, kc, vc, lengths))
    jargs = tuple(map(jx.jnp.asarray, (q, kc, vc, lengths)))
    _close(flash_decode(tq, tk, tv, tl),
           jx.flash_decode(*jargs, interpret=True))
    o, m, l = flash_decode_partials(tq, tk, tv, tl)
    jo, jm, jl = jx.flash_decode_partials(*jargs, interpret=True)
    _close(o, jo)
    _close(l, jl)
    # m: compare where the slot has valid entries; a zero-length slot is
    # the (0, NEG_INF, 0) triple on both sides
    _close(m[1:], np.asarray(jm)[1:])
    assert (m[0] == -1e30).all() and (l[0] == 0).all() and (o[0] == 0).all()
    assert (np.asarray(jm)[0] == -1e30).all()


def test_flash_decode_plain_agrees_with_oracle_on_strided_cache(jx):
    q, kc, vc, lengths = _decode_inputs(7, 2)
    b, h, d = q.shape
    stacked = torch.from_numpy(np.stack([kc, vc]))  # (2, B, S, KV, D)
    tq, tl = torch.from_numpy(q), torch.from_numpy(lengths)
    o, m, l = flash_decode_fwd(tq.reshape(b, 2, h // 2, d), stacked[0],
                               stacked[1], tl)
    ro, rm, rl = jx.decode_partials_reference(
        *map(jx.jnp.asarray, (q, kc, vc, lengths)))
    _close(o, ro)
    _close(m, rm)
    _close(l, rl)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 96, 427])
def test_cuda_flash_attention_fwd_matches_plain(cuda, s, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(24, s, 64, device=cuda, generator=gen).to(dtype)
               for _ in range(3))
    before = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v)
    assert flash_attention_fwd.launches == before + 1
    ro, rlse = flash_attention_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 2e-5
    else:  # 2 bf16 ulps at the value, plus the fp32 tolerance of both sides
        mag = torch.maximum(o.float().abs(), ro.float().abs())
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126)))
                         - 7)
        assert bool((err <= 2 * ulp + 2e-5).all())
    assert (lse - rlse).abs().max().item() <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 4])
def test_cuda_flash_decode_matches_plain(cuda, g, dtype):
    gen = torch.Generator(device=cuda).manual_seed(g)
    q = torch.randn(8, 12, g, 64, device=cuda, generator=gen).to(dtype)
    kc, vc = (torch.randn(8, 1024, 12, 64, device=cuda,
                          generator=gen).to(dtype) for _ in range(2))
    lengths = torch.tensor([0, 1, 127, 128, 1000, 1024, 600, 5],
                           dtype=torch.int32, device=cuda)
    before = flash_decode_fwd.launches
    o, m, l = flash_decode_fwd(q, kc, vc, lengths)
    assert flash_decode_fwd.launches == before + 1
    ro, rm, rl = flash_decode_fwd_plain(q, kc, vc, lengths)
    torch.cuda.synchronize()
    norm = o / l[..., None].clamp_min(1e-30)
    rnorm = ro / rl[..., None].clamp_min(1e-30)
    assert (norm - rnorm).abs().max().item() <= 2e-5
    assert ((l - rl).abs() / rl.clamp_min(1.0)).max().item() <= 2e-5
    assert (m - rm).abs().max().item() <= 2e-5


@pytest.mark.gpu
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 8, 48, device=cuda)  # head dim 48
    with pytest.raises(ValueError):
        flash_attention_fwd(x, x, x)
    h = torch.zeros(2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        flash_attention_fwd(h, h, h)
