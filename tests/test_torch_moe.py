"""The port's MoE family against the JAX package on the CPU.

Reduced deepseek-moe-16b and moonshot-v1-16b-a3b (2 layers, d 64, 4
experts of which top-2, one shared expert), fp32, the JAX parameters moved
through ``repro_torch.bridge``, inputs from a numpy seed.

* The routed FFN under both dispatches (``row_local``, ``global``), with
  drops (``capacity_factor`` 0.5) and without (8.0): first the routing
  decision (``expert_idx``, ``keep``, ``dest``) exactly, then ``y``, the
  three aux values and every gradient (of x and of each weight).
* ``MoELM``: the total loss and its metrics, every gradient, prefill
  logits and caches, per-slot decode, and greedy engine streams (dense and
  paged) against the JAX engine.

Tolerance: 1e-4 absolute on values, 1e-4 of each leaf's largest entry on
gradients (fp32, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.serve import InferenceEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SchedulerConfig as JaxSchedulerConfig
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe
from repro_torch.serve import InferenceEngine, Request, SchedulerConfig

CPU = torch.device("cpu")
TOL = 1e-4
PRESETS = ("deepseek-moe-16b", "moonshot-v1-16b-a3b")
DISPATCHES = ("row_local", "global")
SHAPES = [(7, 5), (20, 9), (33, 3), (12, 7), (40, 4), (9, 8)]
SCHED = dict(n_slots=3, cache_len=64, min_prompt_bucket=8, round_multiple=16,
             max_buckets=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one intra-op thread keeps them cheap where
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(preset, **kw):
    return (jreduced(jget_arch(preset).model).replace(**kw),
            tconfigs.reduced(tconfigs.get_arch(preset)).replace(**kw))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, np.asarray(tree))]


def _grads_close(got, ref):
    """Every leaf of two host trees within TOL of the reference leaf's
    largest entry."""
    got, ref = _leaves(got), _leaves(ref)
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (name, g), (_, r) in zip(got, ref):
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(g - r).max())
        assert err <= TOL * scale, f"{name}: {err} > {TOL} x {scale}"


def _jax_routing(params, x, cfg):
    """``moe.py:121-132`` (the global dispatch is one row of B * S)."""
    if cfg.moe_dispatch != "row_local":
        x = x.reshape(1, -1, x.shape[-1])
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = jmoe.capacity(s, cfg)
    logits = jnp.einsum("bsd,de->bse", x, params["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    flat_e = expert_idx.reshape(b, s * k)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - 1,
                              flat_e[..., None], axis=2)[..., 0]
    keep = pos < c
    return expert_idx, keep, jnp.where(keep, flat_e * c + pos, e * c)


@pytest.mark.parametrize("cf", [0.5, 8.0])
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("preset", PRESETS)
def test_moe_ffn_matches_reference(preset, dispatch, cf):
    jcfg, tcfg = _cfgs(preset, capacity_factor=cf, moe_dispatch=dispatch)
    params = jlayers.init_params(jax.random.PRNGKey(0),
                                 jmoe.moe_ffn_def(jcfg))
    host = jax.tree_util.tree_map(np.asarray, params)
    tparams = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a.copy()).requires_grad_(True), host)
    x = np.random.default_rng(1).standard_normal((2, 12, 64)).astype(
        np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)

    # the routing decision, exactly
    ridx, rkeep, rdest = jax.jit(_jax_routing, static_argnums=2)(
        params, jnp.asarray(x), jcfg)
    flat = tx.reshape(1, 24, 64) if dispatch == "global" else tx
    r = tmoe.route(tparams["router"], flat, tcfg)
    np.testing.assert_array_equal(_np(r.expert_idx), np.asarray(ridx))
    np.testing.assert_array_equal(_np(r.keep), np.asarray(rkeep))
    np.testing.assert_array_equal(_np(r.dest), np.asarray(rdest))
    assert (not np.asarray(rkeep).all()) == (cf < 1)

    # values, then the gradient of a scalar of y and the aux losses
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.apply_moe_ffn(p, xx, jcfg)
        return (jnp.sum(y * w) + aux["load_balance"] + 0.1 * aux["router_z"],
                (y, aux))

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    y, aux = tmoe.apply_moe_ffn(tparams, tx, tcfg)
    _close(y, jy)
    for key in tmoe.AUX_KEYS:
        _close(aux[key], jaux[key])
    (y * torch.from_numpy(w)).sum().add(
        aux["load_balance"] + 0.1 * aux["router_z"]).backward()
    _grads_close({"x": _np(tx.grad),
                  **jax.tree_util.tree_map(lambda t: _np(t.grad), tparams)},
                 {"x": np.asarray(jgx),
                  **jax.tree_util.tree_map(np.asarray, jgp)})


@pytest.fixture(scope="module", params=PRESETS)
def weights(request):
    jcfg, tcfg = _cfgs(request.param)
    params = jax.jit(jinit_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, CPU)
    return jcfg, params, tcfg, tparams


@pytest.mark.parametrize("dispatch,remat", [("row_local", "full"),
                                            ("global", "none")])
def test_moelm_loss_and_grads_match_reference(weights, dispatch, remat):
    jcfg, params, tcfg, tparams = weights
    jcfg = jcfg.replace(moe_dispatch=dispatch, capacity_factor=0.75)
    tcfg = tcfg.replace(moe_dispatch=dispatch, capacity_factor=0.75)
    batch = tzoo.make_train_batch(5, tcfg, 3, 16)
    jmodel = jbuild_model(jcfg, dtype=jnp.float32, remat=remat)
    (jtotal, jm), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [p.detach().clone().requires_grad_(True)
              for p in jax.tree_util.tree_leaves(tparams)]
    tp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tparams), leaves)
    total, m = tzoo.build_model(tcfg, remat=remat).loss(
        tp, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    _close(total, jtotal)
    assert float(m["dropped_frac"]) > 0  # capacity 0.75 drops
    for key in ("loss", "tokens") + tmoe.AUX_KEYS:
        _close(m[key], jm[key])
    total.backward()
    grads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tparams), [p.grad for p in leaves])
    _grads_close(bridge.params_to_numpy(grads, tcfg),
                 jax.tree_util.tree_map(np.asarray, jg))


def test_prefill_and_per_slot_decode_match_reference(weights):
    jcfg, params, tcfg, tparams = weights
    jmodel = jbuild_model(jcfg, dtype=jnp.float32, remat="none")
    tmodel = tzoo.build_model(tcfg)
    toks = np.random.default_rng(3).integers(0, 512, (2, 11)).astype(np.int32)
    lg, c = jmodel.prefill(params, {"tokens": jnp.asarray(toks)},
                           cache_len=20)
    tlg, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks).long()},
                             cache_len=20)
    _close(tlg, lg)
    _close(tc["k"], c["k"])
    _close(tc["v"], c["v"])
    # per-slot positions, one slot inactive
    pos = np.array([11, 6], np.int64)
    active = np.array([True, False])
    c = dict(c, pos=jnp.asarray(pos, jnp.int32), active=jnp.asarray(active))
    tc = dict(tc, pos=torch.from_numpy(pos), active=torch.from_numpy(active))
    for step in range(3):
        nxt = np.array([[5 + step], [400 - step]], np.int32)
        lg, c = jmodel.decode(params, c, jnp.asarray(nxt))
        tlg, tc = tmodel.decode(tparams, tc, torch.from_numpy(nxt).long())
        _close(tlg[0], np.asarray(lg)[0])
    _close(tc["k"], c["k"])
    assert tc["pos"].tolist() == np.asarray(c["pos"]).tolist() == [14, 6]


def test_engine_greedy_streams_match_reference(weights):
    """deepseek from the dense slot cache, moonshot from a paged pool."""
    jcfg, params, tcfg, tparams = weights
    paged = jcfg.name.startswith("moonshot")
    sched = dict(SCHED, paged=True, page_size=16, n_pages=7) if paged \
        else SCHED
    rng = np.random.default_rng(4)
    prompts = [(tuple(int(t) for t in rng.integers(0, 512, size=n)), mt)
               for n, mt in SHAPES]
    jeng = JaxEngine(jbuild_model(jcfg, dtype=jnp.float32, remat="none"),
                     params, JaxSchedulerConfig(**sched))
    teng = InferenceEngine(tzoo.build_model(tcfg), tparams,
                           SchedulerConfig(**sched), device="cpu")
    jres = jeng.run([JaxRequest(uid=i, tokens=t, max_tokens=mt)
                     for i, (t, mt) in enumerate(prompts)])
    tres = teng.run([Request(uid=i, tokens=t, max_tokens=mt)
                     for i, (t, mt) in enumerate(prompts)])
    for j, t in zip(jres, tres):
        assert t.tokens == j.tokens, f"uid {t.uid}"
        assert t.finish_reason == j.finish_reason
    assert sorted(teng.scheduler.free) == [0, 1, 2]
    if paged:
        teng.state.alloc.check()
        assert teng.state.alloc.pages_in_use == 0


def test_moelm_tree_has_lm_head_and_no_pos_embed():
    _, tcfg = _cfgs("deepseek-moe-16b", pos_emb="learned",
                    tie_embeddings=True)
    defs = tzoo.model_defs(tcfg)
    assert "lm_head" in defs and "pos_embed" not in defs
    assert sorted(defs["layers"][0]["moe"]) == ["router", "shared", "w_down",
                                                "w_gate", "w_up"]
