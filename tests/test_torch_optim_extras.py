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
* The fused route of the default AdamW chain (``optimizer_step``): which
  chains have it, that it takes CUDA leaves alone (off the card the
  chain, its plain version, runs with the chain's state tree, tensors,
  telemetry keys and bits) and raises for CUDA leaves that are no plain
  fp32 tensors, that the sharded step drops it, the ``optim.fused`` /
  ``optim.params`` counters, and the kernel's chunk table.  The kernel
  itself is held against the chain on the card
  (``test_torch_fused_adamw.py``).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import restore, save
from repro_torch.configs import OptimizerConfig, get_arch, reduced
from repro_torch.core import trace
from repro_torch.core.telemetry import leaf_groups
from repro_torch.kernels.fused_adamw import TELEMETRY, chunk_table
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


# ---------------------------------------------------------------------------
# the fused route of the default AdamW chain
# ---------------------------------------------------------------------------

# chain config, and whether its optimizer has the fused route
ROUTES = {"adamw": ({}, True),
          "adamw_std_no_clip": (dict(decay_mask="std", grad_clip=0.0,
                                     weight_decay=0.1), True),
          "adamw_no_decay": (dict(weight_decay=0.0), True),
          **{name: (kw, False) for name, kw in CHAINS.items()}}


def _toy_grads(params, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return ttx.tree_map(lambda p: torch.randn(p.shape, generator=gen
                                              ).to(dtype), params)


def _traced_step(tx, grads, state, params, hyper):
    """``optimizer_step`` inside one span: its result and the span's
    counters."""
    with trace.tracing():
        with trace.span("step"):
            got = ttx.optimizer_step(tx, grads, state, params, hyper)
    (sp,) = trace.take()
    return got, sp.counts


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_fused_route_selection_and_counters(name):
    """Only the default AdamW chain (any decay mask, clip or decay) has the
    fused route, and the route takes no CPU leaves: every chain runs its
    links here.  Under the tracer the step counts every parameter element
    in ``optim.params``, and in ``optim.fused`` those a route that takes
    the leaves updated (here a stand-in route of the chain's own links)."""
    kw, fused = ROUTES[name]
    params = _unstack(_toy_host(np.random.default_rng(3)))
    tx = ttx.build_optimizer(OptimizerConfig(**kw))
    assert (tx.fused is not None) == fused
    state = tx.init(params)
    n = sum(p.numel() for p in ttx.tree_leaves(params))
    hyper = {"lr": 1e-2, "clip_scale": 1.0}
    if name == "leaf_lr_scale":
        hyper["leaf_lr_scale"] = torch.full(
            (len(leaf_groups(params).labels),), 0.5)
    if fused:
        assert tx.fused(_toy_grads(params, 1), state, params, hyper) is None
    (_, state, tel), counts = _traced_step(tx, _toy_grads(params, 1), state,
                                           params, hyper)
    assert counts == {"optim.params": n}
    assert {"grad_norm", "grad_norm_clipped", "var_max"} <= set(tel)

    def links(grads, state, params, hyper):
        updates, state, tel = tx.update(grads, state, params, hyper)
        ttx.apply_updates(params, updates)
        return state, tel
    (_, _, tel), counts = _traced_step(tx._replace(fused=links),
                                       _toy_grads(params, 2), state, params,
                                       hyper)
    assert counts == {"optim.params": n, "optim.fused": n}
    # the tracer off: nothing counted, nothing recorded
    ttx.optimizer_step(tx, _toy_grads(params, 3), state, params, hyper)
    assert trace.take() == []


@pytest.mark.parametrize("case", ["adamw", "adamw_std_no_clip",
                                  "adamw_no_decay", "adamw_leaf_lr"])
def test_fused_route_keeps_the_chain_state_and_numbers(case):
    """Three steps of the default AdamW chain through ``optimizer_step`` on
    the CPU (the route takes no CPU leaves: the chain, its plain version,
    runs) against the chain's ``update`` and ``apply_updates`` on a copy:
    the same state tree with the same ``m`` and ``v`` tensors, a new
    ``count``, the chain's five telemetry keys, and the same bits; the
    kernel keeps the same tree, tensors and keys on the card
    (``test_torch_fused_adamw.py``)."""
    kw = ROUTES.get(case, ({}, True))[0]  # adamw_leaf_lr: the default
    tx = ttx.build_optimizer(OptimizerConfig(**kw))
    params = _unstack(_toy_host(np.random.default_rng(4)))
    twin = ttx.tree_map(torch.clone, params)
    state, twin_state = tx.init(params), tx.init(twin)
    m0, v0 = (ttx.tree_leaves(state["adam"][k]) for k in ("m", "v"))
    for step in range(3):
        hyper = {"lr": 1e-2 * (step + 1), "clip_scale": 0.5 + step}
        if case == "adamw_leaf_lr":
            hyper["leaf_lr_scale"] = torch.linspace(
                0.25, 1.5, len(leaf_groups(params).labels))
        grads = _toy_grads(params, 10 + step)
        count_before = state["adam"]["count"]
        got, new_state, tel = ttx.optimizer_step(tx, grads, state, params,
                                                 hyper)
        assert got is params
        assert sorted(new_state) == ["adam", "clip", "decay", "lr"]
        assert sorted(new_state["adam"]) == ["count", "m", "v"]
        assert all(a is b for a, b in zip(
            ttx.tree_leaves(new_state["adam"]["m"]), m0))
        assert all(a is b for a, b in zip(
            ttx.tree_leaves(new_state["adam"]["v"]), v0))
        assert new_state["adam"]["count"] is not count_before
        assert int(count_before) == step
        with torch.no_grad():
            u, twin_state, twin_tel = tx.update(_toy_grads(params, 10 + step),
                                                twin_state, twin, hyper)
            ttx.apply_updates(twin, u)
        assert list(tel) == list(twin_tel) == list(TELEMETRY)
        for key in TELEMETRY:
            assert torch.equal(tel[key], twin_tel[key]), (key, step)
        state = new_state
    for a, b in zip(ttx.tree_leaves((params, state)),
                    ttx.tree_leaves((twin, twin_state))):
        assert torch.equal(a, b)
    assert int(state["adam"]["count"]) == 3


def test_other_dtypes_and_dtensors_take_the_chain(tmp_path):
    """On the CPU a gradient of another dtype, or DTensor leaves (one gloo
    rank), run the default AdamW chain's links, with its numbers."""
    import torch.distributed as dist
    from repro_torch.distributed.compat import (Replicate, distribute_tensor,
                                                init_device_mesh)
    tx = ttx.build_optimizer(OptimizerConfig())
    params = _unstack(_toy_host(np.random.default_rng(5)))
    n = sum(p.numel() for p in ttx.tree_leaves(params))
    hyper = {"lr": 1e-2, "clip_scale": 1.0}
    twin = ttx.tree_map(torch.clone, params)

    def grads():  # the chain clips fp32 gradients in place: new ones a call
        g = _toy_grads(params, 6)
        g["bias"] = g["bias"].to(torch.bfloat16)
        return g

    (_, _, tel), counts = _traced_step(tx, grads(), tx.init(params), params,
                                       hyper)
    assert counts == {"optim.params": n}
    u, _, twin_tel = tx.update(grads(), tx.init(twin), twin, hyper)
    ttx.apply_updates(twin, u)
    assert all(torch.equal(a, b) for a, b in zip(ttx.tree_leaves(params),
                                                 ttx.tree_leaves(twin)))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        place = lambda t: distribute_tensor(t, mesh, [Replicate()])
        dparams = ttx.tree_map(place, twin)
        dgrads = ttx.tree_map(place, _toy_grads(twin, 7))
        dstate = ttx.tree_map(place, tx.init(twin))
        (_, _, dtel), counts = _traced_step(tx, dgrads, dstate, dparams,
                                            hyper)
        assert counts == {"optim.params": n}
        assert sorted(dtel) == sorted(TELEMETRY)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fake_f32", "bf16"])
def test_fused_route_raises_for_other_cuda_leaves(dtype):
    """On CUDA leaves the route runs the kernel or raises: a tensor
    subclass (here a fake tensor; a DTensor is one too) or another dtype is
    refused before any launch, never sent to the chain unseen."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    tx = ttx.build_optimizer(OptimizerConfig())
    with FakeTensorMode():
        params = {"w": torch.empty(4, 3, device="cuda", dtype=dtype),
                  "b": torch.empty(3, device="cuda", dtype=dtype)}
        grads = ttx.tree_map(torch.empty_like, params)
        state = tx.init(params)
        with pytest.raises(TypeError, match="plain float32 tensors"):
            tx.fused(grads, state, params, {"lr": 1e-2, "clip_scale": 1.0})


def test_sharded_step_drops_the_fused_route(tmp_path, monkeypatch):
    """Under sharding rules (one gloo rank, a (1, 1) mesh, ``fsdp``) the
    train step runs the default AdamW chain without its fused route, on
    DTensor leaves, and lands where the unsharded step does."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    cfg = reduced(get_arch("gpt2-117m"))
    opt = OptimizerConfig()
    model = model_zoo.build_model(cfg)
    state = steps_lib.init_train_state(torch.Generator().manual_seed(0), cfg,
                                       opt, CPU)
    batch = {k: torch.from_numpy(v).long() for k, v in
             model_zoo.make_train_batch(0, cfg, 2, 16).items()}
    seen = []
    step_of = ttx.optimizer_step

    def spy(tx, grads, state, params, hyper):
        seen.append(tx.fused)
        return step_of(tx, grads, state, params, hyper)
    monkeypatch.setattr(ttx, "optimizer_step", spy)
    clone = lambda tree: ttx.tree_map(lambda t: t.detach().clone(), tree)
    plain, _ = steps_lib.make_train_step(model, opt)(clone(state), batch,
                                                     1e-3)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        rules = ShardingRules.make(make_host_mesh((1, 1), ("data", "model")),
                                   "fsdp")
        sharded = steps_lib.shard_train_state(clone(state), rules, cfg, opt)
        sharded, _ = steps_lib.make_train_step(model, opt, rules)(
            sharded, batch, 1e-3)
        got = steps_lib.unshard_tree(sharded["params"])
    finally:
        dist.destroy_process_group()
    assert seen[0] is not None and seen[1] is None
    for a, b in zip(ttx.tree_leaves(got), ttx.tree_leaves(plain["params"])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lengths,chunk", [
    ([1], 16384), ([0, 5, 0], 4), ([16383, 16384, 16385], 16384),
    ([3, 70001, 0, 1, 8], 16384), ([9, 4, 1, 12], 4)])
def test_chunk_table_covers_every_element_once(lengths, chunk):
    """The kernel's chunks, leaf by leaf in order, cover each leaf's
    elements once: chunk j of a leaf is [j * chunk, min((j + 1) * chunk,
    n))."""
    table = chunk_table(lengths, chunk)
    assert table.dtype == np.int32 and table.shape[1] == 2
    want = [(leaf, j) for leaf, n in enumerate(lengths)
            for j in range(-(-n // chunk))]
    assert [tuple(r) for r in table.tolist()] == want
    covered = [0] * len(lengths)
    for leaf, j in table.tolist():
        covered[leaf] += min(chunk, lengths[leaf] - j * chunk)
    assert covered == list(lengths)
