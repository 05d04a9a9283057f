"""The optimizer chain's extras on the port against the JAX package, on
the CPU.

* 50-step fp32 trajectories of each chain the reference builds besides
  the default one, on a small tree with stacked ``layers`` leaves (the
  port's tree has them unstacked), gradients from numpy, the LR and the
  clip scale changing at run time: SM3 with and without momentum, Shampoo
  refreshed every 3 steps, AGC, ``lr_scales`` patterns, the per-leaf
  telemetry and a runtime ``leaf_lr_scale`` vector.  Params, chain state
  and telemetry agree with the reference at every step within 1e-6
  relative (1e-7 absolute near zero) for AdamW and SM3: the same fp32
  arithmetic, per-group reductions summed per layer first.  Shampoo's
  telemetry is held within 2e-5 relative, its params and state within
  2e-5 of each leaf's largest entry (plus 1e-6): its inverse 4th roots
  come from two fp32 ``eigh`` implementations whose eigenvectors agree to
  ~1e-7 of the matrix's scale, so small off-diagonal entries of the
  preconditioners differ by ~1e-2 of themselves (~4e-7 of the largest),
  and 50 grafted steps compound that to a few 1e-6.
* The legacy functions of ``optim/adam.py`` against the reference's.
* SM3 and Shampoo chain states of reduced gpt2 go both ways through
  ``repro_torch.bridge`` and through the checkpoint format (either
  package restores the other's), bit for bit, and a step from the
  carried state matches the reference's step.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import restore, save
from repro_torch.configs import OptimizerConfig, get_arch, reduced
from repro_torch.core.telemetry import leaf_groups
from repro_torch.optim import adam as tadam
from repro_torch.optim import transforms as ttx

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one intra-op thread keeps them cheap where
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's optimizer chain, legacy AdamW, checkpoints and
    train state (skips where JAX is absent)."""
    jax = pytest.importorskip("jax")
    from repro.checkpoint import checkpoint as ckpt
    from repro.configs import base, get_arch as jget_arch, reduced as jreduced
    from repro.launch import steps
    from repro.optim import adam, transforms
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, base=base,
                                 tx=transforms, adam=adam, ckpt=ckpt,
                                 steps=steps, get_arch=jget_arch,
                                 reduced=jreduced)


def _toy_host(rng):
    """A tree with stacked ``layers`` leaves (a stacked matrix, a stacked
    vector), a matrix, a bias and a scalar, in the JAX layout."""
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "layers": {"w": rng.standard_normal((2, 8, 8)).astype(np.float32),
                       "scale": rng.standard_normal((2, 8)).astype(np.float32)},
            "bias": rng.standard_normal(8).astype(np.float32),
            "gain": np.float32(rng.standard_normal())}


def _unstack(tree):
    out = {k: torch.tensor(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: torch.tensor(v[i]) for k, v in tree["layers"].items()}
                     for i in range(2)]
    return out


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _ref_params(t):
    """A toy params-shaped tree of the port in the JAX layout."""
    layers = t["layers"]
    out = {k: _np(v) for k, v in t.items() if k != "layers"}
    out["layers"] = {k: np.stack([_np(layer[k]) for layer in layers])
                     for k in layers[0]}
    return out


def _port_state_as_ref(state):
    """The port's toy chain state in the JAX layout: params-shaped
    subtrees restacked, the rest as it is."""
    def conv(t, path):
        if path in bridge._PARAM_SHAPED:
            return _ref_params(t)
        if isinstance(t, dict):
            return {k: conv(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v, path + (str(i),)) for i, v in enumerate(t)]
        return None if t is None else _np(t)
    return conv(state, ())


def _assert_trees_close(got, ref, rtol, atol, what, scaled=False):
    """Leaf by leaf within ``rtol`` relative and ``atol`` absolute, or,
    ``scaled``, within ``rtol`` of the leaf's largest entry plus ``atol``."""
    if ref is None:
        assert got is None, what
        return
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), what
        for k in ref:
            _assert_trees_close(got[k], ref[k], rtol, atol, f"{what}/{k}",
                                scaled)
        return
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_trees_close(g, r, rtol, atol, f"{what}/{i}", scaled)
        return
    got, ref = np.asarray(got), np.asarray(ref)
    if scaled:
        atol, rtol = atol + rtol * float(np.max(np.abs(ref), initial=0)), 0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


CHAINS = {
    "sm3": dict(optimizer="sm3"),
    "sm3_no_momentum": dict(optimizer="sm3", sm3_momentum=0.0),
    "shampoo": dict(optimizer="shampoo", shampoo_interval=3),
    "agc": dict(agc_clip=0.05, grad_clip=0.0),
    "agc_with_clip_std_mask": dict(agc_clip=0.05, decay_mask="std"),
    "lr_scales": dict(lr_scales=(("layers", 0.5), ("w", 3.0),
                                 ("embed", 0.0))),
    "per_leaf": dict(telemetry_level="per_leaf"),
    "per_leaf_sm3": dict(optimizer="sm3", telemetry_level="per_leaf"),
    "per_leaf_shampoo": dict(optimizer="shampoo", shampoo_interval=3,
                             telemetry_level="per_leaf"),
    "leaf_lr_scale": dict(telemetry_level="per_leaf"),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_trajectory_matches_reference(jx, name):
    kw = CHAINS[name]
    shampoo = kw.get("optimizer") == "shampoo"
    rtol, atol = (2e-5, 1e-6) if shampoo else (1e-6, 1e-7)
    rng = np.random.default_rng(11)
    host = _toy_host(rng)
    jparams = jx.jax.tree_util.tree_map(jx.jnp.asarray, host)
    tparams = _unstack(host)
    jtx_ = jx.tx.build_optimizer(jx.base.OptimizerConfig(**kw))
    ttx_ = ttx.build_optimizer(OptimizerConfig(**kw))
    jopt, topt = jtx_.init(jparams), ttx_.init(tparams)
    jupdate = jx.jax.jit(jtx_.update)
    n_leaves = len(leaf_groups(tparams).labels)
    for step in range(50):
        grads = jx.jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(np.shape(p)) *
                       (1.0 if step % 3 else 0.01)).astype(np.float32), host)
        lr = np.float32(1e-2 * (1 + step % 4))
        clip = np.float32(0.5 if 20 <= step < 30 else 1.0)
        jhyper = {"lr": lr, "clip_scale": clip}
        thyper = {"lr": float(lr), "clip_scale": float(clip)}
        if name == "leaf_lr_scale":
            scales = rng.uniform(0.25, 1.5, n_leaves).astype(np.float32)
            jhyper["leaf_lr_scale"] = jx.jnp.asarray(scales)
            thyper["leaf_lr_scale"] = torch.from_numpy(scales)
        ju, jopt, jtel = jupdate(jx.jax.tree_util.tree_map(jx.jnp.asarray,
                                                           grads),
                                 jopt, jparams, jhyper)
        jparams = jx.tx.apply_updates(jparams, ju)
        with torch.no_grad():
            tu, topt, ttel = ttx_.update(_unstack(grads), topt, tparams,
                                         thyper)
            tparams = ttx.apply_updates(tparams, tu)
        assert sorted(ttel) == sorted(jtel), step
        for key in jtel:
            np.testing.assert_allclose(_np(ttel[key]), np.asarray(jtel[key]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{key} @ {step}")
        host_params = jx.jax.tree_util.tree_map(np.asarray, jparams)
        _assert_trees_close(_ref_params(tparams), host_params, rtol, atol,
                            f"params @ {step}", scaled=shampoo)
    _assert_trees_close(_port_state_as_ref(topt),
                        jx.jax.tree_util.tree_map(np.asarray, jopt),
                        rtol, atol, "chain state", scaled=shampoo)
    if "per_leaf" in kw.get("telemetry_level", ""):
        assert ttel["leaf_var_max"].shape == (n_leaves,)


def test_shampoo_staleness_and_eligibility(jx):
    """The refresh cadence keys off the shared Adam count; the stacked
    (2, 8) leaf is one (2 x 8) block coupling both layers, as in the
    reference, and the bias and the scalar take the Adam update."""
    cfg = OptimizerConfig(optimizer="shampoo", shampoo_interval=3)
    tx = ttx.build_optimizer(cfg)
    params = _unstack(_toy_host(np.random.default_rng(0)))
    state = tx.init(params)
    labels = leaf_groups(params).labels
    stats = dict(zip(labels, state["shampoo"]["stats"]))
    assert stats["bias"] is None and stats["gain"] is None
    assert stats["layers/scale"]["l"].shape == (1, 2, 2)
    assert stats["layers/w"]["r"].shape == (2, 8, 8)
    seen = []
    for _ in range(7):
        grads = ttx.tree_map(torch.randn_like, params)
        with torch.no_grad():
            _, state, tel = tx.update(grads, state, params,
                                      {"lr": 1e-3, "clip_scale": 1.0})
        seen.append(float(tel["shampoo_staleness"]))
    assert seen == [0, 1, 2, 0, 1, 2, 0]


def test_legacy_adam_functions_match_reference(jx):
    rng = np.random.default_rng(5)
    host = _toy_host(rng)
    grads = jx.jax.tree_util.tree_map(
        lambda p: rng.standard_normal(np.shape(p)).astype(np.float32) * 3,
        host)
    jparams = jx.jax.tree_util.tree_map(jx.jnp.asarray, host)
    tparams = _unstack(host)
    for mask in ("all", "std"):
        cfg_kw = dict(lr=1e-2, weight_decay=0.1, decay_mask=mask)
        jopt = jx.adam.init_opt_state(jparams)
        topt = tadam.init_opt_state(tparams)
        assert sorted(topt) == sorted(jopt) == ["count", "m", "v"]
        jp, tp = jparams, tparams
        for step in range(3):
            jg, jn = jx.adam.clip_by_global_norm(
                jx.jax.tree_util.tree_map(jx.jnp.asarray, grads), 1.0)
            tg, tn = tadam.clip_by_global_norm(_unstack(grads), 1.0)
            np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
            np.testing.assert_allclose(
                float(tadam.global_norm(tparams)),
                float(jx.adam.global_norm(jparams)), rtol=1e-6)
            jp, jopt, jtel = jx.adam.adamw_update(
                jp, jg, jopt, jx.jnp.float32(1e-2),
                jx.base.OptimizerConfig(**cfg_kw))
            tp, topt, ttel = tadam.adamw_update(tp, tg, topt, 1e-2,
                                                OptimizerConfig(**cfg_kw))
            for key in jtel:
                np.testing.assert_allclose(float(ttel[key]),
                                           float(jtel[key]), rtol=1e-6)
        _assert_trees_close(_ref_params(tp),
                            jx.jax.tree_util.tree_map(np.asarray, jp),
                            1e-6, 1e-7, f"params {mask}")
        assert int(topt["count"]) == 3
    abstract = tadam.abstract_opt_state(tparams)
    assert abstract["count"].device.type == "meta"
    assert [tuple(t.shape) for t in ttx.tree_leaves(abstract["m"])] == [
        tuple(t.shape) for t in ttx.tree_leaves(tparams)]


def _jax_state(jx, opt_kw, steps):
    """A reduced gpt2 train state of the reference after ``steps`` chain
    updates on numpy gradients, and its config objects."""
    jcfg = jx.reduced(jx.get_arch("gpt2-117m").model)
    jopt_cfg = jx.base.OptimizerConfig(**opt_kw)
    state = jx.steps.init_train_state(jx.jax.random.PRNGKey(0), jcfg,
                                      jopt_cfg)
    tx = jx.tx.build_optimizer(jopt_cfg)
    update = jx.jax.jit(tx.update)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        grads = jx.jax.tree_util.tree_map(
            lambda p: jx.jnp.asarray(rng.standard_normal(p.shape),
                                     jx.jnp.float32), state["params"])
        u, opt, _ = update(grads, state["opt"], state["params"],
                              {"lr": jx.jnp.float32(1e-3),
                               "clip_scale": jx.jnp.float32(1.0)})
        state = {"params": jx.tx.apply_updates(state["params"], u),
                 "opt": opt, "step": state["step"] + 1}
    return state, jcfg, jopt_cfg, update


def _flat(jx, tree):
    return jx.jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("opt_kw", [dict(optimizer="sm3"),
                                    dict(optimizer="shampoo",
                                         shampoo_interval=2)],
                         ids=["sm3", "shampoo"])
def test_chain_state_both_ways_through_bridge_and_checkpoints(jx, tmp_path,
                                                              opt_kw):
    state, jcfg, jopt_cfg, jupdate = _jax_state(jx, opt_kw, 3)
    host = jx.jax.tree_util.tree_map(np.asarray, state)
    cfg = reduced(get_arch("gpt2-117m"))
    opt_cfg = OptimizerConfig(**opt_kw)
    port = bridge.train_state_from_numpy(host, cfg, opt_cfg, CPU)
    back = bridge.train_state_to_numpy(port, cfg)
    ref_flat, got_flat = _flat(jx, host), _flat(jx, back)
    assert [p for p, _ in got_flat] == [p for p, _ in ref_flat]
    for (path, a), (_, b) in zip(got_flat, ref_flat):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # the port's checkpoint restores in the reference, and the reverse
    save(str(tmp_path / "port"), 3, back)
    like = jx.steps.abstract_train_state(jcfg, jopt_cfg)
    got, _ = jx.ckpt.restore(str(tmp_path / "port"), 3, like)
    for (path, a), (_, b) in zip(_flat(jx, got), ref_flat):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    jx.ckpt.save(str(tmp_path / "ref"), 3, state)
    tree, _ = restore(str(tmp_path / "ref"), 3,
                      bridge.abstract_train_state(cfg, opt_cfg))
    again = bridge.train_state_to_numpy(
        bridge.train_state_from_numpy(tree, cfg, opt_cfg, CPU), cfg)
    for (path, a), (_, b) in zip(_flat(jx, again), ref_flat):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # one more update from the carried state matches the reference's
    rng = np.random.default_rng(9)
    grads = jx.jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32),
        host["params"])
    hyper = {"lr": np.float32(1e-3), "clip_scale": np.float32(1.0)}
    ju, jopt, _ = jupdate(
        jx.jax.tree_util.tree_map(jx.jnp.asarray, grads), state["opt"],
        state["params"], hyper)
    jp = jx.tx.apply_updates(state["params"], ju)
    with torch.no_grad():
        tu, topt, _ = ttx.build_optimizer(opt_cfg).update(
            bridge.params_from_numpy(grads, cfg, CPU), port["opt"],
            port["params"], {k: float(v) for k, v in hyper.items()})
        tp = ttx.apply_updates(port["params"], tu)
    rtol = 2e-5 if opt_kw["optimizer"] == "shampoo" else 1e-6
    for (path, a), (_, b) in zip(
            _flat(jx, bridge.params_to_numpy(tp, cfg)),
            _flat(jx, jx.jax.tree_util.tree_map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6,
                                   err_msg=str(path))


def test_abstract_chain_state_is_meta():
    params = _unstack(_toy_host(np.random.default_rng(0)))
    for kw in CHAINS.values():
        tx = ttx.build_optimizer(OptimizerConfig(**kw))
        abstract = ttx.tree_leaves(ttx.abstract_chain_state(tx, params))
        real = ttx.tree_leaves(tx.init(params))
        assert [t is None for t in abstract] == [t is None for t in real]
        assert all(t.device.type == "meta" for t in abstract
                   if t is not None)
        assert [(tuple(a.shape), a.dtype) for a in abstract
                if a is not None] == [(tuple(r.shape), r.dtype)
                                      for r in real if r is not None]
