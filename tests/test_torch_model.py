"""The port's dense LM against the JAX model on transferred weights.

Reduced gpt2 (2 layers, d 64, vocab 512), fp32 on the CPU.  The JAX
parameters go to the port through ``repro_torch.bridge``; tokens come from
numpy.  Tolerance: max abs error 1e-4 on logits and caches (fp32 through
two layers and a 512-wide tied unembedding, summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_arch, reduced
from repro.models import build_model, init_params
from repro.models import layers as jax_layers
from repro.models import model_zoo as jax_zoo
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import layers as tlayers
from repro_torch.models import model_zoo as tzoo

TOL = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model, port params) for reduced gpt2."""
    cfg = reduced(get_arch("gpt2-117m").model)
    model = build_model(cfg, dtype=jnp.float32, remat="none")
    params = init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tconfigs.reduced(tconfigs.get_arch("gpt2-117m"))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                tcfg, CPU)
    return model, params, tzoo.build_model(tcfg), tparams


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)


@pytest.mark.parametrize("use_reduced", [True, False])
def test_param_count_matches_reference(use_reduced):
    cfg = get_arch("gpt2-117m").model
    tcfg = tconfigs.get_arch("gpt2-117m")
    if use_reduced:
        cfg, tcfg = reduced(cfg), tconfigs.reduced(tcfg)
    assert tzoo.param_count(tcfg) == jax_zoo.param_count(cfg)


def test_bridge_checks_shapes(pair):
    _, params, _, _ = pair
    tree = jax.tree_util.tree_map(np.asarray, params)
    tree["embed"] = tree["embed"][:, :8]
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(tree, tconfigs.reduced(
            tconfigs.get_arch("gpt2-117m")), CPU)


def test_init_params_draws_reference_distributions():
    tcfg = tconfigs.reduced(tconfigs.get_arch("gpt2-117m"))
    p = tzoo.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    emb = p["embed"]
    assert emb.abs().max() <= 0.02 * 3 and 0.015 < emb.std() < 0.02
    assert (p["layers"][0]["ln1"]["scale"] == 1).all()
    assert (p["layers"][1]["mlp"]["b_up"] == 0).all()
    q = p["layers"][0]["attn"]["wq"]
    assert q.shape == (64, 4, 16) and q.abs().max() <= 3 / 8


def test_layer_norm_gelu_and_advance_pos_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    _close(tlayers.layer_norm(*map(torch.from_numpy, (x, scale, bias)), 1e-5),
           jax_layers.layer_norm(*map(jnp.asarray, (x, scale, bias)), 1e-5),
           1e-5)
    _close(F.gelu(torch.from_numpy(x), approximate="tanh"),
           jax.nn.gelu(jnp.asarray(x)), 1e-5)
    pos = np.array([0, 5, 16, 16], np.int64)
    active = np.array([True, True, True, False])
    _close(tlayers.advance_pos(torch.from_numpy(pos), 1,
                               torch.from_numpy(active), limit=16),
           jax_layers.advance_pos(jnp.asarray(pos), 1, jnp.asarray(active),
                                  limit=16), 0)


def _prefill(pair, toks, cache_len):
    model, params, tmodel, tparams = pair
    lg, c = model.prefill(params, {"tokens": jnp.asarray(toks)},
                          cache_len=cache_len)
    tlg, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks).long()},
                             cache_len=cache_len)
    return (lg, c), (tlg, tc)


@pytest.mark.parametrize("s", [1, 13])
def test_prefill_matches_reference(pair, s):
    toks = np.random.default_rng(s).integers(0, 512, (2, s)).astype(np.int32)
    (lg, c), (tlg, tc) = _prefill(pair, toks, 24)
    assert tlg.shape == (2, 512)
    _close(tlg, lg)
    _close(tc["k"], c["k"])
    _close(tc["v"], c["v"])
    assert int(tc["pos"]) == int(c["pos"]) == s


def test_scalar_pos_decode_matches_reference(pair):
    model, params, tmodel, tparams = pair
    toks = np.random.default_rng(1).integers(0, 512, (2, 9)).astype(np.int32)
    (_, c), (_, tc) = _prefill(pair, toks, 16)
    for step in range(3):
        nxt = np.array([[7 + step], [300 - step]], np.int32)
        lg, c = model.decode(params, c, jnp.asarray(nxt))
        tlg, tc = tmodel.decode(tparams, tc, torch.from_numpy(nxt).long())
        _close(tlg, lg)
    _close(tc["k"], c["k"])
    assert int(tc["pos"]) == int(c["pos"]) == 12
    # a two-token replay step at a scalar position writes both tokens
    two = np.array([[1, 2], [3, 4]], np.int32)
    lg, c = model.decode(params, c, jnp.asarray(two))
    tlg, tc = tmodel.decode(tparams, tc, torch.from_numpy(two).long())
    _close(tlg, lg)
    _close(tc["v"], c["v"])


@pytest.mark.parametrize("decode_backend", ["reference", "kernel"])
def test_per_slot_decode_matches_reference(pair, decode_backend):
    """Per-slot positions with an inactive slot and a slot at capacity:
    their writes are dropped (reference) / masked (port), their positions
    freeze or saturate."""
    model, params, tmodel, tparams = pair
    model = build_model(model.cfg.replace(decode_backend=decode_backend),
                        dtype=jnp.float32, remat="none")
    tmodel = tzoo.build_model(tmodel.cfg.replace(
        decode_backend=decode_backend))
    rng = np.random.default_rng(2)
    cap = 12
    k = rng.standard_normal((2, 4, cap, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 4, cap, 4, 16)).astype(np.float32)
    pos = np.array([3, cap, 7, 0], np.int64)
    active = np.array([True, True, False, True])
    cache = {"k": jnp.asarray(k), "v": jnp.asarray(v),
             "pos": jnp.asarray(pos, jnp.int32), "active": jnp.asarray(active)}
    tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
              "pos": torch.from_numpy(pos), "active": torch.from_numpy(active)}
    for step in range(3):
        nxt = rng.integers(0, 512, (4, 1)).astype(np.int32)
        lg, cache = model.decode(params, cache, jnp.asarray(nxt))
        tlg, tcache = tmodel.decode(tparams, tcache,
                                    torch.from_numpy(nxt).long())
        _close(tlg, lg)
        _close(tcache["k"], cache["k"])
        _close(tcache["v"], cache["v"])
        _close(tcache["pos"], cache["pos"], 0)
    assert tcache["pos"].tolist() == [6, cap, 7, 3]
    # the inactive slot's rows and the full slot's rows were never written
    _close(tcache["k"][:, 2], k[:, 2], 0)
    _close(tcache["k"][:, 1], k[:, 1], 0)


def test_per_slot_multi_token_replay_matches_reference(pair):
    model, params, tmodel, tparams = pair
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, 2, 10, 4, 16)).astype(np.float32)
    pos = np.array([2, 5], np.int64)
    cache = {"k": jnp.asarray(k), "v": jnp.asarray(k),
             "pos": jnp.asarray(pos, jnp.int32)}
    tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(k.copy()),
              "pos": torch.from_numpy(pos)}
    toks = rng.integers(0, 512, (2, 3)).astype(np.int32)
    lg, cache = model.decode(params, cache, jnp.asarray(toks))
    tlg, tcache = tmodel.decode(tparams, tcache, torch.from_numpy(toks).long())
    _close(tlg, lg)
    _close(tcache["k"], cache["k"])
    assert tcache["pos"].tolist() == [5, 8]


def test_blockwise_and_flash_backends_agree(pair):
    _, _, tmodel, tparams = pair
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, 512, (2, 37))).long()
    outs = []
    for backend in ("blockwise", "flash"):
        m = tzoo.build_model(tmodel.cfg.replace(attn_backend=backend),
                             block_kv=16)
        outs.append(m.prefill(tparams, {"tokens": toks})[0])
    _close(outs[0], outs[1], 1e-5)


def test_interpret_backends_are_refused(pair):
    _, _, tmodel, tparams = pair
    m = tzoo.build_model(tmodel.cfg.replace(attn_backend="flash_interpret"))
    with pytest.raises(ValueError, match="interpret"):
        m.prefill(tparams, {"tokens": torch.zeros(1, 4, dtype=torch.long)})
