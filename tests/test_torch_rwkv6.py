"""The port's WKV-6 kernels and RWKV-6 model against the JAX package.

On the CPU the port's kernel wrappers run their plain PyTorch versions;
the JAX side runs the Pallas kernels in interpret mode, as the JAX
package's own tests do, or its model's oracle.  Inputs come from numpy with
a fixed seed and feed both; parameters cross by ``bridge``.

Tolerances, fp32: kernel outputs and gradients within 1e-4 absolute, the
scale of the reference's own kernel-vs-oracle errors (6.10e-05 forward,
7.25e-05 gradient) with room for another summation order; model loss
within 1e-5, every gradient leaf within 1e-4 x its largest entry, prefill
logits and cache leaves and 8 decode steps within 1e-4.  The zero-
initialised leaves (token-shift mixes, the decay base and its LoRA up
projection) are redrawn at random, so that the decay is data-dependent and
the LoRA down projection gets a gradient.

Tests marked ``gpu`` hold the CUDA kernels against their plain versions on
the card; the ``cuda`` fixture skips them where there is none.  The JAX
side comes through the ``jx`` fixture:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_rwkv6.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels.rwkv6 import (wkv6, wkv6_bwd, wkv6_bwd_plain,
                                       wkv6_fwd, wkv6_fwd_plain)
from repro_torch.models import model_zoo as tzoo
from repro_torch.models.layers import ParamDef
from repro_torch.optim import transforms as ttx

CPU = torch.device("cpu")
TOL = 1e-4  # fp32 absolute, see the module docstring
REDRAWN = ("mix", "w_base", "w_lora_b")  # zero-initialised leaves


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side (skips where JAX is absent)."""
    jnp = pytest.importorskip("jax.numpy")
    import jax
    from repro.configs import get_arch, reduced
    from repro.kernels.rwkv6.kernel import wkv6_bwd as jwkv6_bwd
    from repro.kernels.rwkv6.kernel import wkv6_fwd as jwkv6_fwd
    from repro.kernels.rwkv6.ops import wkv6 as jwkv6
    from repro.kernels.rwkv6.ref import wkv6_sequential
    from repro.models import build_model, init_params
    return types.SimpleNamespace(**locals())


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _wkv_inputs(rng, b, h, s, d):
    r, k, v = (_randn(rng, b, h, s, d) for _ in range(3))
    lw = -np.exp(_randn(rng, b, h, s, d, scale=0.5))
    return r, k, v, lw, _randn(rng, h, d, scale=0.5)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [8, 40])
def test_wkv6_fwd_plain_with_carries_matches_jax_kernel(jx, s):
    """B 2, H 2, D 16, chunk 16: the plain forward (on the padded sequence
    where S = 40 is uneven) against the Pallas kernel with carries, and the
    padded wrapper against the sequential oracle."""
    rng = np.random.default_rng(s)
    xs = _wkv_inputs(rng, 2, 2, s, 16)
    chunk = min(16, s)
    pad = (-s) % chunk
    padded = [np.pad(t, ((0, 0), (0, 0), (0, pad), (0, 0))) for t in xs[:4]]
    y, state, carries = wkv6_fwd_plain(*map(torch.from_numpy, padded),
                                       torch.from_numpy(xs[4]), chunk=chunk,
                                       return_carries=True)
    jy, jstate, jcarries = jx.jwkv6_fwd(
        *map(jx.jnp.asarray, padded), jx.jnp.asarray(xs[4]), chunk=chunk,
        interpret=True, return_carries=True)
    assert carries.shape == (2, 2, (s + pad) // chunk, 16, 16)
    for a, b in ((y, jy), (state, jstate), (carries, jcarries)):
        _close(a, b)
    sy, sstate = jx.wkv6_sequential(*map(jx.jnp.asarray, xs))
    y, state = wkv6(*map(torch.from_numpy, xs), chunk=16)
    assert y.shape == (2, 2, s, 16)
    _close(y, sy)
    _close(state, sstate)


@pytest.mark.parametrize("s,chunk", [(40, 16), (8, 16), (64, 16)])
def test_wkv6_function_grads_match_jax(jx, s, chunk):
    """torch.autograd through the port's WKV6 Function (plain forward and
    reverse scan) against jax.grad through the Pallas custom VJP, with
    random cotangents on y and on the final state: all five gradients."""
    rng = np.random.default_rng(100 + s)
    xs = _wkv_inputs(rng, 2, 2, s, 16)
    w, ws = _randn(rng, 2, 2, s, 16), _randn(rng, 2, 2, 16, 16)

    def jloss(*t):
        y, st = jx.jwkv6(*t, chunk=chunk, interpret=True)
        return jx.jnp.sum(y * w) + jx.jnp.sum(st * ws)

    jgrads = jx.jax.grad(jloss, (0, 1, 2, 3, 4))(*map(jx.jnp.asarray, xs))
    ts = [torch.from_numpy(t).requires_grad_() for t in xs]
    y, st = wkv6(*ts, chunk=chunk)
    loss = (y * torch.from_numpy(w)).sum() + (st * torch.from_numpy(ws)).sum()
    grads = torch.autograd.grad(loss, ts)
    for name, g, r in zip(("dr", "dk", "dv", "dlw", "du"), grads, jgrads):
        assert g.shape == r.shape, name
        _close(g, r)


def test_wkv6_bwd_plain_matches_jax_kernel(jx):
    """The plain reverse scan against the Pallas backward kernel on the
    same inputs, carries and cotangents."""
    rng = np.random.default_rng(7)
    xs = _wkv_inputs(rng, 2, 2, 48, 16)
    dy, ds = _randn(rng, 2, 2, 48, 16), _randn(rng, 2, 2, 16, 16)
    _, _, carries = wkv6_fwd_plain(*map(torch.from_numpy, xs), chunk=16,
                                   return_carries=True)
    ref = jx.jwkv6_bwd(*map(jx.jnp.asarray, xs), jx.jnp.asarray(carries.numpy()),
               jx.jnp.asarray(dy), jx.jnp.asarray(ds), chunk=16,
               interpret=True)
    got = wkv6_bwd(*map(torch.from_numpy, xs), carries, torch.from_numpy(dy),
                   torch.from_numpy(ds), chunk=16)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        _close(a, b)


def test_padding_rows_leave_the_state_unchanged():
    """log_w = 0, k = 0 rows appended to a sequence change neither its y
    rows nor its final state."""
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(t) for t in _wkv_inputs(rng, 1, 2, 24, 16)]
    y, state = wkv6_fwd_plain(*xs, chunk=8)
    pad = [torch.nn.functional.pad(t, (0, 0, 0, 8)) for t in xs[:4]]
    pad[2][:, :, 24:] = 1.0  # v of the pad rows is read only through k = 0
    py, pstate = wkv6_fwd_plain(*pad, xs[4], chunk=8)
    torch.testing.assert_close(py[:, :, :24], y, rtol=0, atol=1e-6)
    torch.testing.assert_close(pstate, state, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm(jx):
    """Reduced rwkv6 (2 layers, d 64, 4 heads of 16, rank 8, chunk 16) with
    the JAX package's parameters, zero-initialised leaves redrawn."""
    cfg = jx.reduced(jx.get_arch("rwkv6-7b").model)
    rng = np.random.default_rng(0)

    def redraw(path, x):
        if any(n in jx.jax.tree_util.keystr(path) for n in REDRAWN):
            return jx.jnp.asarray(_randn(rng, *x.shape, scale=0.5))
        return x

    params = jx.jax.tree_util.tree_map_with_path(
        redraw, jx.init_params(jx.jax.random.PRNGKey(0), cfg))
    tcfg = tconfigs.reduced(tconfigs.get_arch("rwkv6-7b"))
    tparams = params_from_numpy(
        jx.jax.tree_util.tree_map(np.asarray, params), tcfg, CPU)
    return cfg, params, tcfg, tparams


def _port_grads(tcfg, tparams, batch, remat):
    model = tzoo.build_model(tcfg, remat=remat)
    leaves = [p.detach().clone().requires_grad_()
              for p in ttx.tree_leaves(tparams)]
    loss, metrics = model.loss(ttx.tree_unflatten(tparams, leaves),
                               {k: torch.from_numpy(v).long()
                                for k, v in batch.items()})
    return loss, metrics, torch.autograd.grad(loss, leaves)


def test_reduced_rwkv6_matches_the_reference_config(jx):
    cfg = jx.reduced(jx.get_arch("rwkv6-7b").model)
    tcfg = tconfigs.reduced(tconfigs.get_arch("rwkv6-7b"))
    for f in ("n_layers", "d_model", "d_ff", "vocab_size", "rwkv_head_dim",
              "rwkv_lora_rank", "rwkv_chunk", "rwkv_backend", "norm_eps"):
        assert getattr(tcfg, f) == getattr(cfg, f), f
    full = tconfigs.get_arch("rwkv6-7b")
    assert tzoo.param_count(full) == 7_534_952_448
    assert tzoo.param_count(full.replace(n_layers=4)) == 1_411_645_440
    assert tzoo.param_count(tcfg) == sum(
        x.size for x in jx.jax.tree_util.tree_leaves(
            jx.init_params(jx.jax.random.PRNGKey(0), cfg)))


@pytest.mark.parametrize("s", [8, 40])
def test_loss_and_every_gradient_match_reference(jx, lm, s):
    """RWKV6LM.loss and every gradient leaf, remat "none" and "full"; the
    port's "kernel" backend runs its WKV6 Function on CPU tensors, the JAX
    side its oracle (what "kernel" dispatches to off the TPU)."""
    cfg, jparams, tcfg, tparams = lm
    rng = np.random.default_rng(s)
    seqs = rng.integers(0, cfg.vocab_size, (3, s + 1), dtype=np.int32)
    batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
    jmodel = jx.build_model(cfg, dtype=jx.jnp.float32, remat="none")
    (jloss, _), jgrads = jx.jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, jx.jax.tree_util.tree_map(jx.jnp.asarray, batch))
    ref = ttx.tree_leaves(params_from_numpy(
        jx.jax.tree_util.tree_map(np.asarray, jgrads), tcfg, CPU))
    for remat in ("none", "full"):
        loss, metrics, grads = _port_grads(tcfg, tparams, batch, remat)
        assert abs(loss.item() - float(jloss)) <= 1e-5
        assert metrics["tokens"].item() == 3 * s
        assert len(grads) == len(ref)
        for g, r in zip(grads, ref):
            assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item()


def _leaf_names(tree, prefix=""):
    """Names of a param tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree)
                for n in _leaf_names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


def test_gradients_reach_the_projections_through_the_kernel_backend(lm):
    """Through rwkv_backend="kernel" (the WKV6 Function) wr, wk, wv and
    w_lora_a get a nonzero gradient, equal to the "reference" backend's
    (autograd through the plain forward)."""
    _, _, tcfg, tparams = lm
    rng = np.random.default_rng(11)
    seqs = rng.integers(0, tcfg.vocab_size, (2, 25), dtype=np.int64)
    batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
    _, _, kern = _port_grads(tcfg, tparams, batch, "none")
    _, _, plain = _port_grads(tcfg.replace(rwkv_backend="reference"),
                              tparams, batch, "none")
    names = _leaf_names(tparams)
    for layer in range(tcfg.n_layers):
        for leaf in ("wr", "wk", "wv", "w_lora_a"):
            i = names.index(f"layers.{layer}.{leaf}")
            assert kern[i].abs().max().item() > 0, names[i]
            torch.testing.assert_close(
                kern[i], plain[i], rtol=0,
                atol=1e-5 * plain[i].abs().max().item())


def _cache_close(tcache, jcache):
    assert sorted(tcache) == sorted(jcache)
    for name in jcache:
        if name == "pos":
            assert np.array_equal(tcache[name].numpy(),
                                  np.asarray(jcache[name])), name
        else:
            _close(tcache[name], jcache[name])


def test_prefill_and_decode_match_reference(jx, lm):
    """Prefill logits and every cache leaf, then 8 decode steps."""
    cfg, jparams, tcfg, tparams = lm
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 21), dtype=np.int32)
    jmodel = jx.build_model(cfg, dtype=jx.jnp.float32, remat="none")
    tmodel = tzoo.build_model(tcfg)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jx.jnp.asarray(toks)})
    tlog, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    _close(tlog, jlog)
    _cache_close(tcache, jcache)
    for _ in range(8):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1), dtype=np.int32)
        jlog, jcache = jmodel.decode(jparams, jcache, jx.jnp.asarray(nxt))
        tlog, tcache = tmodel.decode(tparams, tcache, torch.from_numpy(nxt))
        _close(tlog, jlog)
        _cache_close(tcache, jcache)


def test_rwkv_backends(lm):
    """"reference" and "kernel" run; the reference's "kernel_interpret"
    (Pallas interpret mode) and unknown values raise."""
    _, _, tcfg, tparams = lm
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long),
             "labels": torch.zeros(1, 4, dtype=torch.long)}
    for backend in ("reference", "kernel"):
        model = tzoo.build_model(tcfg.replace(rwkv_backend=backend))
        assert torch.isfinite(model.loss(tparams, batch)[0])
    for backend, match in (("kernel_interpret", "interpret"),
                           ("nope", "unknown")):
        model = tzoo.build_model(tcfg.replace(rwkv_backend=backend))
        with pytest.raises(ValueError, match=match):
            model.loss(tparams, batch)


def test_cpu_generator_weights_do_not_change():
    """A CPU generator draws a "normal" leaf on the CPU, scaled afterwards,
    whatever the target device: the weights of a seed stay what they were."""
    leaf = ParamDef((5, 7), "normal", 0.25)
    got = leaf.materialize(torch.Generator().manual_seed(3), CPU)
    want = torch.empty(5, 7)
    torch.nn.init.trunc_normal_(want, 0.0, 1.0, -3.0, 3.0,
                                generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, 0.25 * want)
    params = tzoo.init_params(tconfigs.reduced(tconfigs.get_arch("rwkv6-7b")),
                              torch.Generator().manual_seed(0), CPU)
    again = tzoo.init_params(tconfigs.reduced(tconfigs.get_arch("rwkv6-7b")),
                             torch.Generator().manual_seed(0), CPU)
    for a, b in zip(ttx.tree_leaves(params), ttx.tree_leaves(again)):
        assert torch.equal(a, b)


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


def _card_inputs(cuda, b, h, s, dtype, seed, decay=None):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r, k, v = (torch.randn(b, h, s, 64, device=cuda, generator=gen).to(dtype)
               for _ in range(3))
    noise = torch.randn(b, h, s, 64, device=cuda, generator=gen)
    lw = (-torch.exp(0.5 * noise) if decay is None else decay + 0.01 * noise)
    return r, k, v, lw, 0.5 * torch.randn(h, 64, device=cuda, generator=gen)


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,chunk", [(1, 512, 64), (4, 40, 8), (2, 96, 32)])
def test_cuda_wkv6_fwd_and_bwd_match_plain(cuda, b, s, chunk):
    """fp32: y, state, carries and the five gradients within 1e-4 of the
    largest entry of the plain version's."""
    r, k, v, lw, u = _card_inputs(cuda, b, 8, s, torch.float32, s)
    before = (wkv6_fwd.launches, wkv6_bwd.launches)
    got = wkv6_fwd(r, k, v, lw, u, chunk=chunk, return_carries=True)
    ref = wkv6_fwd_plain(r, k, v, lw, u, chunk=chunk, return_carries=True)
    for a, e in zip(got, ref):
        assert _rel(a, e) <= 1e-4
    gen = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(r.shape, device=cuda, generator=gen)
    ds = torch.randn(b, 8, 64, 64, device=cuda, generator=gen)
    grads = wkv6_bwd(r, k, v, lw, u, ref[2], dy, ds, chunk=chunk)
    plain = wkv6_bwd_plain(r, k, v, lw, u, ref[2], dy, ds, chunk=chunk)
    for a, e in zip(grads, plain):
        assert _rel(a, e) <= 1e-4
    assert (wkv6_fwd.launches, wkv6_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)


@pytest.mark.gpu
def test_cuda_wkv6_fast_decay_stays_finite(cuda):
    """log_w near -54.6 a token: finite, and y within 2e-3 of the plain
    version's largest entry (the pairwise exponent is a difference of
    cumulative sums near -3,500, whose fp32 ulp is 2.4e-4)."""
    r, k, v, lw, u = _card_inputs(cuda, 1, 8, 128, torch.float32, 2, -54.6)
    y, state = wkv6_fwd(r, k, v, lw, u, chunk=64)
    ry, rstate = wkv6_fwd_plain(r, k, v, lw, u, chunk=64)
    assert bool(torch.isfinite(y).all() and torch.isfinite(state).all())
    assert _rel(y, ry) <= 2e-3 and _rel(state, rstate) <= 2e-3


@pytest.mark.gpu
def test_cuda_wkv6_grad_through_function(cuda):
    """torch.autograd through WKV6 on the card against autograd through the
    plain forward, with cotangents on y and on the state."""
    xs = [t.requires_grad_() for t in
          _card_inputs(cuda, 2, 4, 100, torch.float32, 4)]
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn(2, 4, 100, 64, device=cuda, generator=gen)
    ws = torch.randn(2, 4, 64, 64, device=cuda, generator=gen)
    y, st = wkv6(*xs, chunk=64)
    got = torch.autograd.grad((y * w).sum() + (st * ws).sum(), xs)
    pad = [torch.nn.functional.pad(t, (0, 0, 0, 28)) for t in xs[:4]]
    py, pst = wkv6_fwd_plain(*pad, xs[4], chunk=64)
    ref = torch.autograd.grad((py[:, :, :100] * w).sum() + (pst * ws).sum(),
                              xs)
    for a, e in zip(got, ref):
        assert _rel(a, e) <= 1e-4


@pytest.mark.gpu
def test_cuda_wkv6_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 2, 16, 32, device=cuda)  # head dim 32
    u = torch.zeros(2, 32, device=cuda)
    with pytest.raises(ValueError):
        wkv6_fwd(x, x, x, x, u, chunk=16)
    x = torch.zeros(1, 2, 24, 64, device=cuda)
    u = torch.zeros(2, 64, device=cuda)
    with pytest.raises(ValueError):  # S not a multiple of the chunk
        wkv6_fwd(x, x, x, x, u, chunk=16)
    with pytest.raises(ValueError):  # float16
        h = x.half()
        wkv6_fwd(h, h, h, h, u, chunk=8)
