"""The port's SSD kernels, rotary positions and Zamba-2 model against the
JAX package.

On the CPU the port's kernel wrappers run their plain PyTorch versions;
the JAX side runs the Pallas kernels in interpret mode, as the JAX
package's own tests do, or its model's oracle (``ssm_backend=
"reference"``).  Inputs come from numpy with a fixed seed and feed both;
parameters cross by ``bridge``.

Tolerances, fp32, each relative to the largest entry of the JAX side's
tensor: the forward (y, state, carries) within 1e-5 (read: 3.2e-6 at
chunk 64), against the reference's own kernel-vs-oracle error of
4.77e-07 absolute (``benchmarks/bench_kernels.py:104``, entries of order
1-10); the five gradients within 2e-5 of the leaf's largest entry (read:
4.9e-6), against the reference's 2.14e-03 absolute maximum over
unnormalised gradients, where dA sums over b and s (so its largest entry
is in the hundreds).  Rope
within 1e-6 absolute.  The model: loss within 1e-5, every gradient leaf
within 1e-4 of its largest entry, prefill logits, cache leaves and 8
decode steps within 1e-4.  The zero-initialised ``a_log``, ``dt_bias``
and conv biases are redrawn at random, so that the decay differs by head
and the conv biases get a gradient.

Tests marked ``gpu`` hold the CUDA kernels against their plain versions on
the card; the ``cuda`` fixture skips them where there is none:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssd.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                              flash_decode_fwd_plain,
                                              flash_decode_paged_fwd,
                                              flash_decode_paged_fwd_plain)
from repro_torch.kernels.ssd import (ssd, ssd_bwd, ssd_bwd_plain, ssd_fwd,
                                     ssd_fwd_plain)
from repro_torch.models import model_zoo as tzoo
from repro_torch.models.layers import apply_rope
from repro_torch.optim import transforms as ttx

CPU = torch.device("cpu")
FWD_RTOL = 1e-5
GRAD_RTOL = 2e-5
# (s, chunk): single-chunk, many-chunk, uneven tail, chunk clamped to s
# (tests/test_kernels.py:311)
SEQ_CHUNK_CASES = [(64, 64), (128, 32), (100, 32), (48, 64)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side (skips where JAX is absent)."""
    jnp = pytest.importorskip("jax.numpy")
    import jax
    from repro.kernels.ssd.kernel import ssd_bwd as jssd_bwd
    from repro.kernels.ssd.kernel import ssd_fwd as jssd_fwd
    from repro.kernels.ssd.ops import ssd as jssd
    from repro.kernels.ssd.ref import ssd_fwd_reference
    from repro.configs import get_arch, reduced
    from repro.models import build_model, init_params
    from repro.models.layers import apply_rope as japply_rope
    return types.SimpleNamespace(**locals())


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ssd_inputs(rng, b, h, s, p, n):
    x = _randn(rng, b, h, s, p)
    dt = np.log1p(np.exp(_randn(rng, b, h, s))).astype(np.float32)
    a = -np.exp(_randn(rng, h, scale=0.5))
    return x, dt, a, _randn(rng, b, s, n), _randn(rng, b, s, n)


def _rel_close(port, ref, rtol):
    ref = np.asarray(ref, np.float32)
    err = np.abs(port.detach().float().numpy() - ref).max()
    assert err <= rtol * np.abs(ref).max(), (err, np.abs(ref).max())


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", SEQ_CHUNK_CASES)
def test_ssd_fwd_plain_with_carries_matches_jax_kernel(jx, s, chunk):
    """B 2, H 3, P 16, N 8: the plain forward (on the padded sequence where
    S is uneven) against the Pallas kernel with carries; the padding
    wrapper against the reference's oracle."""
    rng = np.random.default_rng(s + chunk)
    xs = _ssd_inputs(rng, 2, 3, s, 16, 8)
    q = min(chunk, s)
    pad = (-s) % q
    padded = (np.pad(xs[0], ((0, 0), (0, 0), (0, pad), (0, 0))),
              np.pad(xs[1], ((0, 0), (0, 0), (0, pad))), xs[2],
              *(np.pad(t, ((0, 0), (0, pad), (0, 0))) for t in xs[3:]))
    got = ssd_fwd_plain(*map(torch.from_numpy, padded), chunk=q,
                        return_carries=True)
    ref = jx.jssd_fwd(*map(jx.jnp.asarray, padded), chunk=q, interpret=True,
                      return_carries=True)
    assert got[2].shape == (2, 3, (s + pad) // q, 8, 16)
    for a, b in zip(got, ref):
        _rel_close(a, b, FWD_RTOL)
    y, state = ssd(*map(torch.from_numpy, xs), chunk=chunk)
    ry, rstate = jx.ssd_fwd_reference(*map(jx.jnp.asarray, xs), chunk=chunk)
    assert y.shape == (2, 3, s, 16)
    _rel_close(y, ry, FWD_RTOL)
    _rel_close(state, rstate, FWD_RTOL)


@pytest.mark.parametrize("s,chunk", SEQ_CHUNK_CASES)
def test_ssd_function_grads_match_jax(jx, s, chunk):
    """torch.autograd through the port's SSD Function (plain forward and
    reverse scan, then the reductions over b, s and H) against jax.grad
    through the Pallas custom VJP, with random cotangents on y and on the
    final state: all five gradients."""
    rng = np.random.default_rng(100 + s + chunk)
    xs = _ssd_inputs(rng, 2, 2, s, 8, 4)
    w, ws = _randn(rng, 2, 2, s, 8), _randn(rng, 2, 2, 4, 8)

    def jloss(*t):
        y, st = jx.jssd(*t, chunk=chunk, interpret=True)
        return jx.jnp.sum(y * w) + jx.jnp.sum(st * ws)

    jgrads = jx.jax.grad(jloss, (0, 1, 2, 3, 4))(*map(jx.jnp.asarray, xs))
    ts = [torch.from_numpy(t).requires_grad_() for t in xs]
    y, st = ssd(*ts, chunk=chunk)
    loss = (y * torch.from_numpy(w)).sum() + (st * torch.from_numpy(ws)).sum()
    grads = torch.autograd.grad(loss, ts)
    for name, g, r in zip(("dx", "ddt", "da", "db", "dc"), grads, jgrads):
        assert g.shape == r.shape, name
        _rel_close(g, r, GRAD_RTOL)


def test_ssd_bwd_plain_matches_jax_kernel(jx):
    """The plain reverse scan against the Pallas backward kernel on the
    same inputs, carries and cotangents."""
    rng = np.random.default_rng(7)
    xs = _ssd_inputs(rng, 2, 2, 96, 16, 8)
    dy, ds = _randn(rng, 2, 2, 96, 16), _randn(rng, 2, 2, 8, 16)
    _, _, carries = ssd_fwd_plain(*map(torch.from_numpy, xs), chunk=32,
                                  return_carries=True)
    ref = jx.jssd_bwd(*map(jx.jnp.asarray, xs),
                      jx.jnp.asarray(carries.numpy()), jx.jnp.asarray(dy),
                      jx.jnp.asarray(ds), chunk=32, interpret=True)
    got = ssd_bwd(*map(torch.from_numpy, xs), carries, torch.from_numpy(dy),
                  torch.from_numpy(ds), chunk=32)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        _rel_close(a, b, GRAD_RTOL)


def test_zero_dt_padding_leaves_the_state_unchanged():
    """dt = 0 rows appended to a sequence change neither its y rows nor its
    final state, whatever x, B and C hold there."""
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(t) for t in _ssd_inputs(rng, 1, 2, 24, 8, 4)]
    y, state = ssd_fwd_plain(*xs, chunk=8)
    pad = [torch.nn.functional.pad(t, (0, 0, 0, 8)) for t in xs[:1]]
    px = pad[0]
    px[:, :, 24:] = 1.0
    pdt = torch.nn.functional.pad(xs[1], (0, 8))
    pb, pc = (torch.nn.functional.pad(t, (0, 0, 0, 8), value=1.0)
              for t in xs[3:])
    py, pstate = ssd_fwd_plain(px, pdt, xs[2], pb, pc, chunk=8)
    torch.testing.assert_close(py[:, :, :24], y, rtol=0, atol=1e-6)
    torch.testing.assert_close(pstate, state, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# rotary positions and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope_matches_jax(jx, batched):
    """x (B, S, H, D) rotated at positions (S,) and per row (B, S)."""
    rng = np.random.default_rng(batched)
    x = _randn(rng, 2, 7, 3, 80)
    pos = (rng.integers(0, 600, (2, 7)) if batched
           else np.arange(7) + 5).astype(np.int32)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    ref = jx.japply_rope(jx.jnp.asarray(x), jx.jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


REDRAWN = ("a_log", "dt_bias", "'b'")  # zero-initialised leaves


@pytest.fixture(scope="module")
def lm(jx):
    """Reduced zamba2 (4 layers, the shared block after every 2, d 64, SSD
    state 16 and heads of 16, chunk 32) with the JAX package's
    parameters, zero-initialised leaves redrawn; the JAX side at its
    oracle backends."""
    cfg = jx.reduced(jx.get_arch("zamba2-2.7b").model).replace(
        ssm_backend="reference", decode_backend="reference")
    rng = np.random.default_rng(0)

    def redraw(path, x):
        if any(n in jx.jax.tree_util.keystr(path) for n in REDRAWN):
            return jx.jnp.asarray(_randn(rng, *x.shape, scale=0.5))
        return x

    params = jx.jax.tree_util.tree_map_with_path(
        redraw, jx.init_params(jx.jax.random.PRNGKey(0), cfg))
    tcfg = tconfigs.reduced(tconfigs.get_arch("zamba2-2.7b"))
    tparams = params_from_numpy(
        jx.jax.tree_util.tree_map(np.asarray, params), tcfg, CPU)
    return cfg, params, tcfg, tparams


def test_reduced_zamba2_matches_the_reference_config(jx, lm):
    cfg = jx.reduced(jx.get_arch("zamba2-2.7b").model)
    tcfg = tconfigs.reduced(tconfigs.get_arch("zamba2-2.7b"))
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "attn_every", "ssm_state",
              "ssm_head_dim", "ssm_expand", "ssm_chunk", "conv_kernel",
              "ssm_backend", "decode_backend", "attn_backend", "pos_emb",
              "rope_theta", "norm", "mlp", "norm_eps"):
        assert getattr(tcfg, f) == getattr(cfg, f), f
    full = tconfigs.get_arch("zamba2-2.7b")
    assert full.resolved_head_dim == 80
    assert tzoo.param_count(full) == 2_422_670_240
    assert tzoo.param_count(tcfg) == sum(
        x.size for x in jx.jax.tree_util.tree_leaves(lm[1]))


def _port_grads(tcfg, tparams, batch, remat):
    model = tzoo.build_model(tcfg, remat=remat)
    leaves = [p.detach().clone().requires_grad_()
              for p in ttx.tree_leaves(tparams)]
    loss, metrics = model.loss(ttx.tree_unflatten(tparams, leaves),
                               {k: torch.from_numpy(v).long()
                                for k, v in batch.items()})
    return loss, metrics, torch.autograd.grad(loss, leaves)


def test_loss_and_every_gradient_match_reference(jx, lm):
    """Zamba2LM.loss and every gradient leaf, remat "none" and "full"; the
    port's "kernel" backend runs its SSD Function on CPU tensors, the JAX
    side its oracle.  The shared block's leaves hold the sum over its two
    applications; S = 40 pads to two chunks of 32."""
    cfg, jparams, tcfg, tparams = lm
    s = 40
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


def test_gradients_reach_the_ssm_leaves_through_the_kernel_backend(lm):
    """Through ssm_backend="kernel" (the SSD Function) wx, wb, wc, wdt,
    a_log and dt_bias of every layer get a nonzero gradient, equal to the
    "reference" backend's (autograd through the plain forward)."""
    _, _, tcfg, tparams = lm
    rng = np.random.default_rng(11)
    seqs = rng.integers(0, tcfg.vocab_size, (2, 45), dtype=np.int64)
    batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
    _, _, kern = _port_grads(tcfg, tparams, batch, "none")
    _, _, plain = _port_grads(tcfg.replace(ssm_backend="reference"),
                              tparams, batch, "none")
    names = _leaf_names(tparams)
    for layer in range(tcfg.n_layers):
        for leaf in ("wx", "wb", "wc", "wdt", "a_log", "dt_bias"):
            i = names.index(f"mamba_layers.{layer}.{leaf}")
            assert kern[i].abs().max().item() > 0, names[i]
            torch.testing.assert_close(
                kern[i], plain[i], rtol=0,
                atol=1e-5 * plain[i].abs().max().item())


MAMBA_LEAVES = ("ssm_state", "conv_x", "conv_b", "conv_c")


def _cache_close(tcache, jcache):
    """The port's flat cache against the reference's nested one."""
    assert sorted(tcache) == sorted(MAMBA_LEAVES + ("attn_k", "attn_v",
                                                    "pos"))
    for name in MAMBA_LEAVES:
        _rel_close(tcache[name], jcache["mamba"][name], 1e-4)
    for name in ("attn_k", "attn_v"):
        _rel_close(tcache[name], jcache[name], 1e-4)
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))


@pytest.mark.parametrize("plen", [1, 21])
def test_prefill_and_decode_match_reference(jx, lm, plen):
    """Prefill logits and every cache leaf, then 8 decode steps; a prompt
    of 1 token is shorter than conv_kernel - 1, so the conv windows are
    zero-left-padded (tests/test_serve_engine.py:181-197)."""
    cfg, jparams, tcfg, tparams = lm
    rng = np.random.default_rng(5 + plen)
    toks = rng.integers(0, cfg.vocab_size, (2, plen), dtype=np.int32)
    jmodel = jx.build_model(cfg, dtype=jx.jnp.float32, remat="none")
    tmodel = tzoo.build_model(tcfg)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jx.jnp.asarray(toks)},
                                  cache_len=32)
    tlog, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                  cache_len=32)
    _rel_close(tlog, jlog, 1e-4)
    _cache_close(tcache, jcache)
    for _ in range(8):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1), dtype=np.int32)
        jlog, jcache = jmodel.decode(jparams, jcache, jx.jnp.asarray(nxt))
        tlog, tcache = tmodel.decode(tparams, tcache, torch.from_numpy(nxt))
        _rel_close(tlog, jlog, 1e-4)
        _cache_close(tcache, jcache)


def test_ssm_backends(lm):
    """"reference" and "kernel" run; the reference's "kernel_interpret"
    (Pallas interpret mode) and unknown values raise."""
    _, _, tcfg, tparams = lm
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long),
             "labels": torch.zeros(1, 4, dtype=torch.long)}
    for backend in ("reference", "kernel"):
        model = tzoo.build_model(tcfg.replace(ssm_backend=backend))
        assert torch.isfinite(model.loss(tparams, batch)[0])
    for backend, match in (("kernel_interpret", "interpret"),
                           ("nope", "unknown")):
        model = tzoo.build_model(tcfg.replace(ssm_backend=backend))
        with pytest.raises(ValueError, match=match):
            model.loss(tparams, batch)


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


def _card_ssd(cuda, b, s, dtype, seed, h=8, deep=False):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(b, h, s, 64, device=cuda, generator=gen).to(dtype)
    raw = torch.randn(b, h, s, device=cuda, generator=gen)
    dt = torch.nn.functional.softplus(raw + (4.0 if deep else 0.0))
    a = -torch.exp(0.5 * torch.randn(h, device=cuda, generator=gen))
    if deep:
        a = a - 2.0  # dt * a near -8 a step: cum passes -1000 in a chunk
    b_in, c_in = (0.3 * torch.randn(b, s, 64, device=cuda, generator=gen)
                  for _ in range(2))
    return x, dt, a, b_in.to(dtype), c_in.to(dtype)


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,chunk", [(1, 512, 128), (4, 40, 8),
                                       (2, 384, 128), (3, 96, 32)])
def test_cuda_ssd_fwd_and_bwd_match_plain(cuda, b, s, chunk):
    """fp32: y, state, carries and the five kernel outputs of the backward
    within 1e-4 of the largest entry of the plain version's."""
    xs = _card_ssd(cuda, b, s, torch.float32, s)
    before = (ssd_fwd.launches, ssd_bwd.launches)
    got = ssd_fwd(*xs, chunk=chunk, return_carries=True)
    ref = ssd_fwd_plain(*xs, chunk=chunk, return_carries=True)
    for a, e in zip(got, ref):
        assert _rel(a, e) <= 1e-4
    gen = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(xs[0].shape, device=cuda, generator=gen)
    ds = torch.randn(b, 8, 64, 64, device=cuda, generator=gen)
    grads = ssd_bwd(*xs, ref[2], dy, ds, chunk=chunk)
    plain = ssd_bwd_plain(*xs, ref[2], dy, ds, chunk=chunk)
    for a, e in zip(grads, plain):
        assert _rel(a, e) <= 1e-4
    assert (ssd_fwd.launches, ssd_bwd.launches) == (before[0] + 1,
                                                    before[1] + 1)


@pytest.mark.gpu
def test_cuda_ssd_bf16_and_deep_decay(cuda):
    """bf16 x, B, C: y within 1e-2 of the plain version's largest entry
    (bf16 rounding of y), the fp32 state within 1e-4; cum past -1000 in a
    chunk: finite, within 2e-3."""
    xs = _card_ssd(cuda, 2, 256, torch.bfloat16, 3)
    y, state = ssd_fwd(*xs, chunk=128)
    ry, rstate = ssd_fwd_plain(*xs, chunk=128)
    assert y.dtype == torch.bfloat16
    assert _rel(y, ry) <= 1e-2 and _rel(state, rstate) <= 1e-4
    xs = _card_ssd(cuda, 1, 256, torch.float32, 4, deep=True)
    cum = (xs[1][..., :128] * xs[2][None, :, None]).sum(dim=-1)
    assert cum.min().item() < -1000
    y, state = ssd_fwd(*xs, chunk=128)
    ry, rstate = ssd_fwd_plain(*xs, chunk=128)
    assert bool(torch.isfinite(y).all() and torch.isfinite(state).all())
    assert _rel(y, ry) <= 2e-3 and _rel(state, rstate) <= 2e-3


@pytest.mark.gpu
def test_cuda_ssd_grad_through_function(cuda):
    """torch.autograd through SSD on the card (S = 100, padded to 128)
    against autograd through the plain forward, with cotangents on y and
    on the state: dx, ddt, dA, dB, dC."""
    xs = [t.requires_grad_() for t in _card_ssd(cuda, 2, 100,
                                                torch.float32, 5)]
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn(2, 8, 100, 64, device=cuda, generator=gen)
    ws = torch.randn(2, 8, 64, 64, device=cuda, generator=gen)
    y, st = ssd(*xs, chunk=128)
    got = torch.autograd.grad((y * w).sum() + (st * ws).sum(), xs)
    py, pst = ssd_fwd_plain(*xs, chunk=128)
    ref = torch.autograd.grad((py * w).sum() + (pst * ws).sum(), xs)
    for a, e in zip(got, ref):
        assert _rel(a, e) <= 1e-4


@pytest.mark.gpu
def test_cuda_ssd_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 2, 16, 32, device=cuda)  # head dim 32
    dt = torch.zeros(1, 2, 16, device=cuda)
    a = torch.zeros(2, device=cuda)
    bc = torch.zeros(1, 16, 64, device=cuda)
    with pytest.raises(ValueError):
        ssd_fwd(x, dt, a, bc, bc, chunk=16)
    x = torch.zeros(1, 2, 24, 64, device=cuda)
    dt = torch.zeros(1, 2, 24, device=cuda)
    bc = torch.zeros(1, 24, 64, device=cuda)
    with pytest.raises(ValueError):  # S not a multiple of the chunk
        ssd_fwd(x, dt, a, bc, bc, chunk=16)
    with pytest.raises(ValueError):  # float16
        ssd_fwd(x.half(), dt, a, bc.half(), bc.half(), chunk=8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_at_head_dim_80(cuda, dtype):
    """Dense and paged decode at D = 80, G = 1 (zamba2's shared block):
    partials within 2e-5 of the plain versions' (normalised o, m,
    relative l), lengths ragged and off multiples of 32."""
    gen = torch.Generator(device=cuda).manual_seed(80)
    q = torch.randn(8, 32, 1, 80, device=cuda, generator=gen).to(dtype)
    kc, vc = (torch.randn(8, 576, 32, 80, device=cuda,
                          generator=gen).to(dtype) for _ in range(2))
    lengths = torch.tensor([0, 1, 31, 129, 576, 300, 545, 77],
                           dtype=torch.int32, device=cuda)
    table = torch.arange(8 * 9, dtype=torch.int32, device=cuda).reshape(8, 9)
    table = table[:, torch.randperm(9, generator=torch.Generator()
                                    .manual_seed(0)).to(cuda)].contiguous()
    pools = [c.reshape(8 * 9, 64, 32, 80) for c in (kc, vc)]
    before = (flash_decode_fwd.launches, flash_decode_paged_fwd.launches)
    for got, ref in (
            (flash_decode_fwd(q, kc, vc, lengths),
             flash_decode_fwd_plain(q, kc, vc, lengths)),
            (flash_decode_paged_fwd(q, *pools, table, lengths),
             flash_decode_paged_fwd_plain(q, *pools, table, lengths))):
        (o, m, l), (ro, rm, rl) = got, ref
        torch.cuda.synchronize()
        norm = o / l[..., None].clamp_min(1e-30)
        rnorm = ro / rl[..., None].clamp_min(1e-30)
        assert (norm - rnorm).abs().max().item() <= 2e-5
        assert ((l - rl).abs() / rl.clamp_min(1.0)).max().item() <= 2e-5
        assert (m - rm).abs().max().item() <= 2e-5
    assert (flash_decode_fwd.launches, flash_decode_paged_fwd.launches) == (
        before[0] + 1, before[1] + 1)
