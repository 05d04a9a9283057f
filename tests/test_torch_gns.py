"""The gradient-noise-scale path of the port against the JAX package, on
the CPU.

* Host side, exactly: the estimator, the precursor,
  ``CriticalBatchRegulator``, ``GradNoiseBatchRegulator`` and the
  throttle's per-leaf gate and blame, fed the same host inputs, give the
  reference's numbers, events, batches and states; each one's
  ``ControllerState`` slice crosses between the packages through JSON and
  continues the same.
* The GNS train step on one transferred batch of reduced gpt2 (8 rows, 4
  shards): the loss, the ``gns_*`` scalars and the per-leaf pairs within
  1e-5 relative, and the full-batch gradient (Adam's first moment after a
  step without clipping) within 1e-4 of each leaf's largest entry.  The
  port sums each shard's gradient weighted by its tokens and divides once;
  the reference takes ``tensordot(tokens / sum, g)``: fp32 sums in
  another order, on gradients that agree to ~1e-5 of their largest entry
  (``tests/test_torch_train.py``).  Rows that give one shard (13) emit no
  GNS pair, as in the reference.
* The sketch, fed the reference's own Rademacher signs, matches the
  reference's ``leaf_gns_sketch`` within 1e-4 of each row's largest entry
  (the bucket sums of gradients of the precision above).
* With GNS off, the step is bit for bit the step without GNS; with
  ``grad_scale`` and ``leaf_lr`` it matches the reference's step.
* A Trainer with ``critical_batch`` and SLW through a checkpoint/resume
  continues the uninterrupted run's batch, seqlen and LR exactly.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import (GNSConfig, OptimizerConfig, RegulatorSpec,
                                 SLWConfig, TrainConfig, get_arch, reduced)
from repro_torch.core import regulators as tregs
from repro_torch.core.telemetry import leaf_groups
from repro_torch.gns import (CriticalBatchRegulator, GNSEstimator,
                             GradientPrecursor, gns_estimates)
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import train
from repro_torch.models import model_zoo
from repro_torch.optim.transforms import tree_leaves

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
    """The JAX package's GNS subsystem, regulators, step and data (skips
    where JAX is absent)."""
    jax = pytest.importorskip("jax")
    from repro import gns
    from repro.configs import base, get_arch as jget_arch, reduced as jreduced
    from repro.core import regulators
    from repro.data import DataPipeline, SyntheticCorpus
    from repro.gns import precursor, regulator
    from repro.launch import steps
    from repro.models import model_zoo as jzoo
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, gns=gns, precursor=precursor,
        regulator=regulator, base=base, regulators=regulators, steps=steps,
        zoo=jzoo, get_arch=jget_arch, reduced=jreduced,
        DataPipeline=DataPipeline, SyntheticCorpus=SyntheticCorpus)


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------

def _json(d):
    return json.loads(json.dumps(d))


def test_estimator_matches_reference(jx):
    rng = np.random.default_rng(0)
    obs = [(rng.uniform(5, 50, 4), rng.uniform(1, 20, 4),
            float(rng.choice([1, 2, 4])), 8.0) for _ in range(20)]
    obs[7] = (obs[7][0], obs[7][1], 8.0, 8.0)  # degenerate: ignored
    got, ref = GNSEstimator(8, 3), jx.gns.GNSEstimator(8, 3)
    for i, (small, big, b, B) in enumerate(obs):
        for est, args in ((got, (small, big, b, B)),
                          (ref, (small, big, b, B))):
            est.update(*args)
        if i == 10:  # a restore in between, through JSON
            got = GNSEstimator(8, 3)
            got.load_state_dict(_json(ref.state_dict()))
        assert got.state_dict() == ref.state_dict()
        assert got.ready == ref.ready
        assert (np.isnan(got.b_noise) and np.isnan(ref.b_noise)) or \
            got.b_noise == ref.b_noise
        np.testing.assert_array_equal(got.leaf_b_noise, ref.leaf_b_noise)
        assert got.efficiency(16) == pytest.approx(ref.efficiency(16),
                                                   nan_ok=True, rel=0)
    scalar_got, scalar_ref = GNSEstimator(4, 2), jx.gns.GNSEstimator(4, 2)
    for small, big, b, B in obs[:6]:
        scalar_got.update(small.sum(), big.sum(), b, B)
        scalar_ref.update(small.sum(), big.sum(), b, B)
    assert scalar_got.critical_batch() == scalar_ref.critical_batch()
    assert scalar_got.leaf_b_noise is None
    for a, r in zip(gns_estimates(30.0, 10.0, 2, 8),
                    jx.gns.gns_estimates(30.0, 10.0, 2, 8)):
        assert float(a) == float(r)


def _precursor_cfgs(jx):
    kw = dict(enabled=True, precursor_window=6, precursor_dim=16,
              precursor_lags=2, precursor_gate=0.8, precursor_rise=0.25,
              precursor_grace=4, precursor_cooldown_steps=4)
    return GNSConfig(**kw), jx.base.GNSConfig(**kw)


def test_precursor_matches_reference(jx):
    """Noise, a leaf whose direction freezes (events, cooldown), a NaN
    sketch that clears the ring: the same events and state."""
    labels = ("blk0/attn", "blk0/mlp", "pos_embed")
    tcfg, jcfg = _precursor_cfgs(jx)
    got, ref = GradientPrecursor(tcfg), jx.precursor.GradientPrecursor(jcfg)
    rng = np.random.default_rng(0)
    frozen = rng.standard_normal(16)
    events = []
    for step in range(48):
        sk = rng.standard_normal((3, 16))
        if 12 <= step < 36:
            sk[1] = frozen + 0.05 * rng.standard_normal(16)
        if step == 40:
            sk[0, 0] = np.nan
        a, b = got.observe(step, sk, labels), ref.observe(step, sk, labels)
        assert (a is None) == (b is None), step
        if a is not None:
            assert str(a) == str(b) and a.leaf == b.leaf
            events.append(a)
        assert len(got.ring) == len(ref.ring) and got.cooldown == ref.cooldown
        np.testing.assert_array_equal(got.trailing, ref.trailing)
    assert events and events[0].leaf == "blk0/mlp"


def _gns_tele(mod, step, small, big, per_leaf=None, b=2.0, B=8.0):
    return mod.StepTelemetry(
        step=step, gns_small_sq=small, gns_big_sq=big, gns_b_small=b,
        gns_b_big=B, per_leaf=per_leaf,
        leaf_labels=("a", "b") if per_leaf is not None else ())


@pytest.mark.parametrize("per_leaf", [False, True])
def test_critical_batch_regulator_matches_reference(jx, per_leaf):
    kw = dict(enabled=True, min_batch=2, headroom=2.0, growth=1.5,
              ema_window=4, warmup_obs=2)
    got = CriticalBatchRegulator(GNSConfig(**kw), full_batch=16)
    ref = jx.regulator.CriticalBatchRegulator(jx.base.GNSConfig(**kw),
                                              full_batch=16)
    rng = np.random.default_rng(1)
    batches = []
    for step in range(24):
        small = rng.uniform(20, 100, 2)
        big = small * rng.uniform(0.2, 1.0 if step > 12 else 0.3, 2)
        pl = ({"gns_small_sq": small.astype(np.float32),
               "gns_big_sq": big.astype(np.float32)} if per_leaf else None)
        for mod, reg in ((tregs, got), (jx.regulators, ref)):
            reg.observe(_gns_tele(mod, step, float(small.sum()),
                                  float(big.sum()), pl), 0)
        if step == 9:
            fresh = CriticalBatchRegulator(GNSConfig(**kw), full_batch=16)
            fresh.load_state_dict(_json(ref.state_dict()))
            got = fresh
        assert got.batch == ref.batch and got.state_dict() == ref.state_dict()
        batches.append(got.batch)
    assert batches[0] == 2 and batches[-1] > 2
    assert (got.est.leaf_b_noise is not None) == per_leaf


def test_grad_noise_batch_regulator_matches_reference(jx):
    kw = dict(kind="grad_noise_batch", noise_window=4, noise_target=0.1)
    got = tregs.GradNoiseBatchRegulator(RegulatorSpec(**kw), 32, dp_size=2)
    ref = jx.regulators.GradNoiseBatchRegulator(jx.base.RegulatorSpec(**kw),
                                                32, dp_size=2)
    rng = np.random.default_rng(2)
    for step in range(30):
        g = float(rng.uniform(0.5, 2.0)) if step != 5 else float("nan")
        got.observe(tregs.StepTelemetry(grad_norm=g), 0)
        ref.observe(jx.regulators.StepTelemetry(grad_norm=g), 0)
        assert got.state_dict() == ref.state_dict()
        plan = dict(seq_len=8, batch_size=32, lr=1.0)
        assert got.plan(tregs.StepTelemetry(), tregs.StepPlan(**plan)) == \
            tregs.StepPlan(**dataclasses.asdict(ref.plan(
                jx.regulators.StepTelemetry(),
                jx.regulators.StepPlan(**plan))))
    assert got.batch > 4


def test_per_leaf_throttle_and_its_state_both_ways(jx):
    """The per-leaf gate and blame step by step, its ``ControllerState``
    through JSON into the other package mid-run, and the scalar fallback
    when the per-leaf vectors are not finite."""
    labels = tuple(f"layers/{n}" for n in "abcde")
    spec = dict(kind="var_lr_throttle", gate=1.5)
    got = tregs.VarianceLRThrottle(RegulatorSpec(**spec))
    ref = jx.regulators.VarianceLRThrottle(jx.base.RegulatorSpec(**spec))
    rng = np.random.default_rng(3)
    scales = []
    for step in range(30):
        v = rng.uniform(1.0, 1.2, 5).astype(np.float32)
        g = rng.uniform(1.0, 1.2, 5).astype(np.float32)
        if step in (8, 9):
            v[3] *= 4.0  # layers/d spikes
        if step == 15:
            g[1] *= 9.0  # a gradient burst the clip hides: layers/b
        if step == 20:
            v[0] = np.nan  # unusable var_max vector: grad_norm still gates
        pl = {"var_max": v, "grad_norm": g} if step != 25 else None
        vm = float(np.nanmax(v))
        for mod, thr in ((tregs, got), (jx.regulators, ref)):
            thr.observe(mod.StepTelemetry(var_max=vm, per_leaf=pl,
                                          leaf_labels=labels), 0)
        assert _json(got.state_dict()) == _json(ref.state_dict()), step
        scales.append(got.scale)
        if step == 12:  # the reference's state into the port
            got = tregs.VarianceLRThrottle(RegulatorSpec(**spec))
            got.load_state_dict(_json(ref.state_dict()))
        if step == 18:  # the port's state into the reference
            ref = jx.regulators.VarianceLRThrottle(
                jx.base.RegulatorSpec(**spec))
            ref.load_state_dict(_json(got.state_dict()))
    assert got.blamed == "layers/b" and got.blamed_ratio > 5
    assert got.leaf_trailing and min(scales) < 1.0


# ---------------------------------------------------------------------------
# the GNS train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm(jx):
    jcfg = jx.reduced(jx.get_arch("gpt2-117m").model).replace(vocab_size=128)
    cfg = reduced(get_arch("gpt2-117m")).replace(vocab_size=128)
    jparams = jx.zoo.init_params(jx.jax.random.PRNGKey(0), jcfg)
    corpus = jx.SyntheticCorpus(vocab_size=128, seq_len=32, seed=0)
    batch = jx.DataPipeline(corpus, 13, model_cfg=jcfg).batch_at(0)
    return jcfg, cfg, jparams, batch


def _steps(jx, lm, gns_kw, rows=8, opt_kw=None, **extra):
    """One step of each package from the same params and batch rows."""
    jcfg, cfg, jparams, batch = lm
    opt_kw = dict(lr=1e-3, schedule="constant", grad_clip=0.0, **(opt_kw or {}))
    batch = {k: v[:rows] for k, v in batch.items()}
    jgns = jx.base.GNSConfig(**gns_kw) if gns_kw is not None else None
    tgns = GNSConfig(**gns_kw) if gns_kw is not None else None
    jopt, topt = jx.base.OptimizerConfig(**opt_kw), OptimizerConfig(**opt_kw)
    jmodel = jx.zoo.build_model(jcfg, dtype=jx.jnp.float32, remat="none")
    jstate = {"params": jparams, "opt": jx.steps.optim_tx.build_optimizer(
        jopt).init(jparams), "step": jx.jnp.zeros((), jx.jnp.int32)}
    jstate, jm = jx.jax.jit(jx.steps.make_train_step(jmodel, jopt,
                                                     gns=jgns))(
        jstate, batch, np.float32(1e-3), np.float32(1.0),
        **{k: jx.jnp.asarray(v) for k, v in extra.items()})
    host = jx.jax.tree_util.tree_map(np.asarray, jparams)
    params = bridge.params_from_numpy(host, cfg, CPU)
    tx = tsteps.optim_tx.build_optimizer(topt)
    state = {"params": params, "opt": tx.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    signs = None
    if gns_kw is not None and gns_kw.get("precursor_window", 12) > 0:
        key = jx.jax.random.PRNGKey(tgns.sketch_seed)

        def signs(i, n, device):  # the reference's own signs
            return torch.from_numpy(np.array(jx.jax.random.rademacher(
                jx.jax.random.fold_in(key, i), (n,), jx.jnp.float32)))
    fn = tsteps.make_train_step(model_zoo.build_model(cfg, remat="none"),
                                topt, gns=tgns, sketch_signs=signs)
    state, tm = fn(state, {k: torch.from_numpy(v).long()
                           for k, v in batch.items()}, 1e-3, 1.0,
                   **{k: torch.from_numpy(np.asarray(v))
                      for k, v in extra.items()})
    return jstate, jm, state, tm, cfg


def jax_flat(tree):
    import jax
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_gns_step_matches_reference(jx, lm):
    gns_kw = dict(enabled=True, shards=4, precursor_window=12)
    jstate, jm, state, tm, cfg = _steps(jx, lm, gns_kw)
    assert (tm["gns_b_small"], tm["gns_b_big"]) == (2.0, 8.0)
    assert float(jm["gns_b_small"]) == 2.0
    for k in ("loss", "tokens", "gns_small_sq", "gns_big_sq", "grad_norm",
              "var_max"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    for k in ("leaf_gns_small_sq", "leaf_gns_big_sq"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-5, err_msg=k)
        assert tm[k].shape == (len(leaf_groups(state["params"]).labels),)
    np.testing.assert_allclose(tm["leaf_gns_small_sq"].sum().item(),
                               float(tm["gns_small_sq"]), rtol=1e-6)
    # the sketch fed the reference's signs
    got, ref = tm["leaf_gns_sketch"].numpy(), np.asarray(jm["leaf_gns_sketch"])
    assert got.shape == ref.shape == (16, 16)
    err = np.max(np.abs(got - ref), axis=1)
    assert np.all(err <= 1e-4 * np.max(np.abs(ref), axis=1)), err
    # the full-batch gradient: m = (1 - b1) g after one unclipped step
    host_m = bridge.params_to_numpy(state["opt"]["adam"]["m"], cfg)
    ref_m = jx.jax.tree_util.tree_map(np.asarray, jstate["opt"]["adam"]["m"])
    for (path, r), (_, g) in zip(jax_flat(ref_m), jax_flat(host_m)):
        scale = float(np.max(np.abs(r)))
        assert float(np.max(np.abs(g - r))) <= 1e-4 * scale, path


def test_sharded_gradient_equals_the_single_pass(jx, lm):
    """The token-weighted shard mean is the full batch's gradient."""
    _, _, sharded, _, cfg = _steps(jx, lm, dict(enabled=True, shards=4,
                                                precursor_window=0))
    _, _, single, _, _ = _steps(jx, lm, None)
    for g, s in zip(tree_leaves(sharded["opt"]["adam"]["m"]),
                    tree_leaves(single["opt"]["adam"]["m"])):
        assert float((g - s).abs().max()) <= 1e-5 * float(s.abs().max())


def test_one_shard_rows_emit_no_pair(jx, lm):
    _, jm, _, tm, _ = _steps(jx, lm, dict(enabled=True, shards=4), rows=13)
    assert not any(k.startswith(("gns", "leaf_gns")) for k in tm)
    assert not any(k.startswith(("gns", "leaf_gns")) for k in jm)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)


def test_gns_off_step_is_bit_equal_to_the_plain_step(lm):
    _, cfg, jparams, batch = lm
    import jax
    host = jax.tree_util.tree_map(np.asarray, jparams)
    tb = {k: torch.from_numpy(v[:8]).long() for k, v in batch.items()}
    model = model_zoo.build_model(cfg, remat="none")
    opt = OptimizerConfig(lr=1e-3, schedule="constant")

    def plain_step(state):
        """The step as it was before GNS: loss, gradient, chain, apply."""
        tx = tsteps.optim_tx.build_optimizer(opt)
        leaves = tree_leaves(state["params"])
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = model.loss(state["params"], tb)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            updates, new_opt, tel = tx.update(
                tsteps.optim_tx.tree_unflatten(state["params"], list(grads)),
                state["opt"], state["params"], {"lr": 1e-3,
                                                "clip_scale": 1.0})
            params = tsteps.optim_tx.apply_updates(state["params"], updates)
        return params, {**{k: v.detach() for k, v in metrics.items()}, **tel}

    def fresh():
        params = bridge.params_from_numpy(host, cfg, CPU)
        return {"params": params,
                "opt": tsteps.optim_tx.build_optimizer(opt).init(params),
                "step": torch.zeros((), dtype=torch.int32)}
    want_p, want_m = plain_step(fresh())
    for gns in (None, GNSConfig(enabled=False)):
        state, m = tsteps.make_train_step(model, opt, gns=gns)(
            fresh(), tb, 1e-3, 1.0)
        assert sorted(m) == sorted(list(want_m) + ["lr"])
        for k, v in want_m.items():
            assert torch.equal(m[k], v), k
        for a, b in zip(tree_leaves(state["params"]), tree_leaves(want_p)):
            assert torch.equal(a, b)


def test_grad_scale_and_leaf_lr_match_reference(jx, lm):
    rng = np.random.default_rng(4)
    n = 16
    extra = {"grad_scale": rng.uniform(0.5, 4.0, n).astype(np.float32),
             "leaf_lr": rng.uniform(0.1, 1.0, n).astype(np.float32)}
    for gns_kw in (None, dict(enabled=True, shards=2, precursor_window=0)):
        jstate, jm, state, tm, cfg = _steps(
            jx, lm, gns_kw, opt_kw=dict(telemetry_level="per_leaf"), **extra)
        np.testing.assert_allclose(tm["leaf_grad_norm"].numpy(),
                                   np.asarray(jm["leaf_grad_norm"]),
                                   rtol=1e-5)
        got = bridge.params_to_numpy(state["params"], cfg)
        ref = jx.jax.tree_util.tree_map(np.asarray, jstate["params"])
        for (path, r), (_, g) in zip(jax_flat(ref), jax_flat(got)):
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6,
                                       err_msg=str(path))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_critical_batch_composes_with_slw_through_resume(tmp_path):
    gns = GNSConfig(enabled=True, shards=4, precursor_window=4,
                    precursor_dim=8, warmup_obs=2, ema_window=8)
    regs = (RegulatorSpec(kind="seqlen"), RegulatorSpec(kind="lr"),
            RegulatorSpec(kind="critical_batch"))
    cfg = reduced(get_arch("gpt2-117m")).replace(vocab_size=128)

    def tc(d):
        return TrainConfig(
            model=cfg, optimizer=OptimizerConfig(
                lr=1e-3, schedule="token_cosine", warmup_steps=4,
                warmup_tokens=4 * 8 * 64, total_steps=20,
                total_tokens=20 * 8 * 64, telemetry_level="per_leaf"),
            slw=SLWConfig(enabled=True, start_seq_len=8, duration_steps=10,
                          round_multiple=8, max_buckets=4),
            regulators=regs, gns=gns, seq_len=64, global_batch=8,
            remat="none", eval_interval=0, checkpoint_interval=6,
            checkpoint_dir=str(tmp_path / d))

    full = train(tc("full"), device="cpu")
    assert full.steps == 20 and not full.diverged
    assert full.batch_history[0] == 2 and full.batch_history[-1] > 2
    assert all(b2 >= b1 for b1, b2 in zip(full.batch_history,
                                          full.batch_history[1:]))
    part = train(tc("part"), max_steps=12, device="cpu")
    resumed = train(tc("part"), resume=True, device="cpu")
    assert resumed.restored_from_step == 12 and resumed.steps == 20
    assert part.batch_history == full.batch_history[:12]
    assert resumed.batch_history == full.batch_history[12:]
    assert resumed.seqlen_history == full.seqlen_history[12:]
    assert resumed.lr_history == full.lr_history[12:]
