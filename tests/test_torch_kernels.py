"""The port's kernel modules against the JAX kernels.

On the CPU the port's wrappers run their plain PyTorch versions (the
tensors lie on the CPU); the JAX side runs the Pallas kernels in interpret
mode, as the JAX package's own tests do.  Inputs come from numpy with a
fixed seed and feed both.  Tolerance: fp32 max abs error 1e-5, the scale
of the reference's own kernel-vs-oracle errors (3.6e-7 for flash attention,
1.6e-7 for flash decode, 2.4e-6 for the flash-attention gradients, all
fp32) with room for a different summation order.  The backward is held
twice: ``flash_attention_bwd_plain`` against the JAX backward kernels on
the same (q, k, v, o, lse, dO), and ``torch.autograd.grad`` through the
port's ``FlashAttention`` Function against ``jax.grad`` through the JAX
custom VJP.

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

from repro_torch.kernels.flash_attention import (
    FlashAttention, flash_attention, flash_attention_bwd,
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_bwd_plain,
    flash_attention_bwd_preprocess, flash_attention_fwd,
    flash_attention_fwd_plain)
from repro_torch.kernels.flash_decode import (flash_decode,
                                              flash_decode_fwd,
                                              flash_decode_fwd_plain,
                                              flash_decode_partials)

TOL = 1e-5  # fp32 max abs error, see the module docstring


def bwd_tol(ref: torch.Tensor) -> float:
    """Card backward against its plain version, fp32: 1e-4 x max |plain|
    (another summation order over up to S = 1024 keys), plus 1e-5 absolute
    for entries that cancel to 0: at S = 1, dq = P (dP - delta) K is 0 in
    exact arithmetic and both sides return rounding noise near 1e-6."""
    return 1e-4 * ref.float().abs().max().item() + 1e-5


BWD_KERNELS = (flash_attention_bwd_preprocess, flash_attention_bwd_dq,
               flash_attention_bwd_dkv)


def _gqa_plain(q, k, v):
    """Attention through the plain forward, differentiated by autograd."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    flat = lambda x, g: (x.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
                         .reshape(-1, s, d))
    o, _ = flash_attention_fwd_plain(flat(q, 1), flat(k, g), flat(v, g))
    return o.reshape(b, h, s, d).permute(0, 2, 1, 3)


@pytest.fixture(scope="module")
def jx():
    """The JAX kernels' public functions (skips where JAX is absent)."""
    jnp = pytest.importorskip("jax.numpy")
    import jax
    from repro.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                      flash_attention_fwd)
    from repro.kernels.flash_attention.ops import flash_attention
    from repro.kernels.flash_attention.ref import attention_reference
    from repro.kernels.flash_decode.ops import (flash_decode,
                                                flash_decode_partials)
    from repro.kernels.flash_decode.ref import decode_partials_reference
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, flash_attention_fwd=flash_attention_fwd,
        flash_attention_bwd=flash_attention_bwd,
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


@pytest.mark.parametrize("s", [8, 40, 128])
def test_flash_attention_bwd_plain_matches_jax_kernel(jx, s):
    """Same (q, k, v, o, lse, dO) into both backwards.  The JAX side runs
    at S padded to its 32-row blocks (S = 40 -> 64, as ops.py pads) with
    valid_len = S and zero dO on the padded rows, then drops them."""
    rng = np.random.default_rng(100 + s)
    q, k, v, do = (_randn(rng, 4, s, 16) for _ in range(4))
    block = min(32, s)
    pad = (-s) % block
    padded = [jx.jnp.pad(x, ((0, 0), (0, pad), (0, 0))) for x in (q, k, v, do)]
    jo, jlse = jx.flash_attention_fwd(*padded[:3], block_q=block,
                                      block_k=block, valid_len=s,
                                      interpret=True)
    jgrads = jx.flash_attention_bwd(*padded[:3], jo, jlse, padded[3],
                                    block_q=block, block_k=block,
                                    valid_len=s, interpret=True)
    o, lse = np.array(jo)[:, :s], np.array(jlse)[:, :s]
    got = flash_attention_bwd_plain(*map(torch.from_numpy, (q, k, v, o, lse,
                                                            do)))
    for a, r in zip(got, jgrads):
        _close(a, np.asarray(r)[:, :s])


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s", [8, 40])
def test_flash_attention_grad_through_function_matches_jax(jx, s, g):
    rng = np.random.default_rng(20 * s + g)
    q, w = _randn(rng, 2, s, 2 * g, 16), _randn(rng, 2, s, 2 * g, 16)
    k, v = _randn(rng, 2, s, 2, 16), _randn(rng, 2, s, 2, 16)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    ref = jx.jax.grad(
        lambda *qkv: (jx.flash_attention(*qkv, interpret=True) * w).sum(),
        argnums=(0, 1, 2))(*map(jx.jnp.asarray, (q, k, v)))
    for a, r in zip(got, ref):
        _close(a, r)


def test_gradients_reach_the_projections_through_flash_attention():
    """A one-layer ``full_attention`` under "flash": the output's node is
    the Function's backward, and wq, wk, wv all get a gradient."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import attention
    from repro_torch.models.layers import init_params
    cfg = reduced(get_arch("gpt2-117m"))
    assert cfg.attn_backend == "flash"
    params = init_params(attention.attention_def(cfg),
                         torch.Generator().manual_seed(0), torch.device("cpu"))
    for p in params.values():
        p.requires_grad_(True)
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    out, _ = attention.full_attention(params, x, cfg)
    grads = torch.autograd.grad(out.square().sum(), list(params.values()))
    for name, grad in zip(params, grads):
        assert grad.abs().max() > 0, name
    ctx = attention._context(*attention._project_qkv(params, x, cfg), cfg,
                             block_kv=512)
    assert isinstance(ctx.grad_fn, FlashAttention._backward_cls)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 8, 96, 427, 1024])
def test_cuda_flash_attention_bwd_matches_plain(cuda, s, dtype):
    """Each of dq, dk, dv within :func:`bwd_tol` in fp32; bf16 outputs
    within 2 bf16 ulps of the plain version rounded to bf16, plus that."""
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v, do = (torch.randn(24, s, 64, device=cuda, generator=gen)
                   .to(dtype) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v)
    counts = [f.launches for f in BWD_KERNELS]
    got = flash_attention_bwd(q, k, v, o, lse, do)
    assert [f.launches for f in BWD_KERNELS] == [n + 1 for n in counts]
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, a, r in zip("qkv", got, ref):
        assert a.dtype == dtype and a.shape == r.shape
        err = (a.float() - r.float()).abs()
        tol = bwd_tol(r)
        if dtype == torch.bfloat16:
            mag = torch.maximum(a.float().abs(), r.float().abs())
            tol = tol + 2 * torch.exp2(torch.floor(torch.log2(
                mag.clamp_min(2.0 ** -126))) - 7)
        assert bool((err <= tol).all()), (name, err.max().item())


@pytest.mark.gpu
def test_cuda_flash_attention_bwd_masks_valid_len(cuda):
    """Keys at or past valid_len get zero dk/dv and do not reach dq."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(4, 130, 64, device=cuda, generator=gen)
                   for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, valid_len=70)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, valid_len=70)
    rq, rk, rv = flash_attention_bwd_plain(q, k, v, o, lse, do, valid_len=70)
    torch.cuda.synchronize()
    assert (dk[:, 70:] == 0).all() and (dv[:, 70:] == 0).all()
    for a, r in ((dq, rq), (dk, rk), (dv, rv)):
        assert (a - r).abs().max().item() <= bwd_tol(r)


@pytest.mark.gpu
def test_cuda_flash_attention_grad_through_function(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(2, 200, 12, 64, device=cuda, generator=gen,
                    requires_grad=True)
    k, v = (torch.randn(2, 200, 6, 64, device=cuda, generator=gen,
                        requires_grad=True) for _ in range(2))
    w = torch.randn(2, 200, 12, 64, device=cuda, generator=gen)
    got = torch.autograd.grad((flash_attention(q, k, v) * w).sum(), (q, k, v))
    ref = torch.autograd.grad((_gqa_plain(q, k, v) * w).sum(), (q, k, v))
    for a, r in zip(got, ref):
        assert (a - r).abs().max().item() <= bwd_tol(r)


@pytest.mark.gpu
def test_cuda_bwd_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 8, 64, device=cuda)
    lse = torch.zeros(2, 8, device=cuda)
    with pytest.raises(ValueError):  # lse of the wrong shape
        flash_attention_bwd(x, x, x, x, lse[:, :4].contiguous(), x)
    with pytest.raises(ValueError):  # lse not float32
        flash_attention_bwd(x, x, x, x, lse.double(), x)
    strided = torch.zeros(2, 64, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):  # dO strided
        flash_attention_bwd(x, x, x, x, lse, strided)
    h = torch.zeros(2, 8, 48, device=cuda)  # head dim 48
    with pytest.raises(ValueError):
        flash_attention_bwd(h, h, h, h, lse, h)
