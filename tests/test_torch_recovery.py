"""The port's divergence recovery against the JAX package's, on the CPU.

* Host side, exactly: ``DivergenceDetector`` fed the same telemetry
  streams (NaN, a spike under grace and cooldown, a sustained variance
  excursion, per-leaf blame) gives the same event strings and ``blamed``;
  ``RecoveryRegulator`` driven through the same ladder gives the same
  plans and ``state_dict``; a ``ControllerState`` carrying ``"recovery"``
  restores across the packages both ways.
* End to end on reduced gpt2 (vocab 128, seq 64, batch 4, the reference's
  ``_tc``), both trainers from one transferred state under the same fault
  spec: ``nan_grad@8,spike@14:64.0`` gives equal ``recovery_events``,
  ``faults_fired`` and ``rollbacks`` and exactly equal seqlen, batch and
  LR histories; losses within 1e-4 relative (fp32 Adam steps through the
  same arithmetic in another order, ``tests/test_torch_train.py``), with
  the non-finite losses at the same positions.  ``grad_spike@8:1000|
  layers/attn`` with per-leaf telemetry gives the same ``blamed`` label
  and ``leaf_lr_scales``.
* The ring in the JAX checkpoint format: a ring spilled by the port loads
  in the reference's ``StateRing.load`` bit for bit, and the other way
  round.
* The port alone, as the reference's ``tests/test_recovery.py`` runs it:
  the ladder, an exhausted budget, ``escalate="raise"`` under
  ``TrainSupervisor``, an exact replay (bit-equal on one thread), ring
  capacity and isolation, a corrupt ring entry, the ring through a drain
  and a resume, and the precursor handing its event to the controller
  (a snapshot at its step, the LR scaled for ``ttl`` steps).
"""
import dataclasses
import json
import math
import os
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import GNSConfig, get_arch, reduced
from repro_torch.core.recovery import (DivergenceDetector, DivergenceError,
                                       RecoveryConfig, RecoveryRegulator,
                                       StateRing)
from repro_torch.core.regulators import (ControllerState, StepPlan,
                                         StepTelemetry, predict_trajectory)
from repro_torch.distributed.fault_injection import (FaultInjectionHook,
                                                     FaultInjector,
                                                     parse_faults)
from repro_torch.distributed.fault_tolerance import (RetryPolicy,
                                                     TrainSupervisor)
from repro_torch.gns.precursor import PrecursorEvent, PrecursorHook
from repro_torch.launch.train import Trainer, TrainerHook, train
from repro_torch.optim.transforms import tree_leaves

CPU = torch.device("cpu")
# losses of the two trainers from one transferred state (fp32, the same
# arithmetic in another order, a few Adam steps): relative
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one intra-op thread keeps them cheap where
    test workers share the cores, and makes reruns bit-identical."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's recovery, trainer, configs and fault injector
    (skips where JAX is absent)."""
    jax = pytest.importorskip("jax")
    from repro.configs import base, get_arch as jget_arch, reduced as jreduced
    from repro.core import recovery, regulators
    from repro.distributed import fault_injection, fault_tolerance
    from repro.launch import steps, train as jtrain
    return types.SimpleNamespace(
        jax=jax, base=base, get_arch=jget_arch, reduced=jreduced,
        recovery=recovery, regulators=regulators, fi=fault_injection,
        ft=fault_tolerance, steps=steps, train=jtrain)


def _tc(base, model, steps=20, seq=64, batch=4, lr=2e-3, ckpt_dir="",
        interval=0, telemetry_level="scalar", clip=1.0, slw=True):
    """The reference's ``tests/test_recovery.py:_tc`` in either package."""
    return base.TrainConfig(
        model=model,
        optimizer=base.OptimizerConfig(
            lr=lr, min_lr=1e-5, schedule="token_cosine",
            warmup_steps=4, warmup_tokens=4 * batch * seq,
            total_steps=steps, total_tokens=steps * batch * seq,
            grad_clip=clip, telemetry_level=telemetry_level),
        slw=base.SLWConfig(enabled=slw, pacing="linear", start_seq_len=8,
                           duration_steps=steps // 2, round_multiple=8,
                           max_buckets=4),
        seq_len=seq, global_batch=batch, remat="none",
        eval_interval=0, checkpoint_interval=interval,
        checkpoint_dir=ckpt_dir)


def _cfg():
    return reduced(get_arch("gpt2-117m")).replace(vocab_size=128)


def _ttc(**kw):
    from repro_torch.configs import base
    return _tc(base, _cfg(), **kw)


def _jtc(jx, **kw):
    return _tc(jx.base, jx.reduced(jx.get_arch("gpt2-117m").model).replace(
        vocab_size=128), **kw)


def _pair(jx, spec, seed=0, recovery=None, **kw):
    """A JAX and a port trainer from one transferred state, each with its
    own injector of ``spec`` and recovery config."""
    rc = recovery or {}
    jtr = jx.train.Trainer(
        _jtc(jx, **kw), recovery=jx.recovery.RecoveryConfig(**rc),
        fault_injector=jx.fi.FaultInjector(jx.fi.parse_faults(spec),
                                           seed=seed))
    ttc = _ttc(**kw)
    ttr = Trainer(ttc, recovery=RecoveryConfig(**rc),
                  fault_injector=FaultInjector(parse_faults(spec), seed=seed),
                  device="cpu")
    ttr.state = bridge.train_state_from_numpy(
        jx.jax.tree_util.tree_map(np.asarray, jtr.state), ttc.model,
        ttc.optimizer, CPU)
    return jtr, ttr


def _assert_same_run(got, ref):
    assert got.steps == ref.steps
    assert got.diverged == ref.diverged
    assert got.rollbacks == ref.rollbacks
    assert got.recovery_events == ref.recovery_events
    assert got.faults_fired == ref.faults_fired
    assert got.seqlen_history == ref.seqlen_history
    assert got.batch_history == ref.batch_history
    assert got.lr_history == ref.lr_history
    g, r = np.asarray(got.loss_history), np.asarray(ref.loss_history)
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(r))
    fin = np.isfinite(r)
    np.testing.assert_allclose(g[fin], r[fin], rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# host side against the reference
# ---------------------------------------------------------------------------

def _stream(kind):
    """(step, loss, ratio, grad, var, per_leaf) rows of one scenario."""
    nan, inf = float("nan"), float("inf")
    calm = [(i, 2.0, 1.0, 1.0, 1e-6 * (1 + 0.1 * i), None) for i in range(8)]
    if kind == "nan":
        return calm + [(8, nan, 1.0, 1.0, 1e-6, None),
                       (9, 2.0, 1.0, inf, 1e-6, None),
                       (10, inf, inf, inf, nan, None)]
    if kind == "spike":
        return ([(i, 2.0, 50.0, 1.0, 1e-6, None) for i in range(7)]
                + [(7 + i, 2.0, r, 1.0, 1e-6, None) for i, r in
                   enumerate((3.5, 50.0, 50.0, 2.9, 4.0, 1.0))])
    if kind == "var":
        return (calm[:6] + [(6 + i, 2.0, 1.0, 1.0, v, None) for i, v in
                            enumerate((1e-4, 1e-4, 1e-6, 1e-4, 1e-4, 1e-4,
                                       1e-4, 1e-4, nan, 1e-4))])
    # per-leaf blame: 4 groups; group 2's raw grad norm and var jump
    rng = np.random.default_rng(5)
    rows = []
    for i in range(14):
        g = rng.uniform(0.9, 1.1, 4)
        v = rng.uniform(0.9, 1.1, 4) * 1e-6
        if i >= 8:
            g[2] *= 100.0
            v[2] *= 1e4
        ratio = 5.0 if i == 9 else 1.0
        rows.append((i, 2.0, ratio, float(np.sqrt((g ** 2).sum())),
                     float(v.max()) * (1e4 if i >= 10 else 1.0),
                     {"grad_norm": g.astype(np.float32),
                      "var_max": v.astype(np.float32)}))
    return rows


@pytest.mark.parametrize("kind,n_events",
                         [("nan", 3), ("spike", 3), ("var", 1), ("blame", 1)])
def test_detector_matches_reference(jx, kind, n_events):
    labels = ("embed", "layers/attn/wq", "layers/attn/wo", "pos_embed")
    cfgs = dict(spike_ratio=3.0, grace_steps=3, cooldown_steps=2,
                var_gate=8.0, var_sustain=3)
    ours = DivergenceDetector(RecoveryConfig(**cfgs))
    theirs = jx.recovery.DivergenceDetector(
        jx.recovery.RecoveryConfig(**cfgs))
    fired = 0
    for step, loss, ratio, grad, var, per_leaf in _stream(kind):
        kw = dict(step=step, loss=loss, loss_ratio=ratio, grad_norm=grad,
                  var_max=var, per_leaf=per_leaf,
                  leaf_labels=labels if per_leaf else ())
        got = ours.update(StepTelemetry(**kw))
        want = theirs.update(jx.regulators.StepTelemetry(**kw))
        assert (str(got) if got else None) == (str(want) if want else None)
        assert ours.blamed == theirs.blamed
        assert ours.var_trailing == theirs.var_trailing
        assert ours.var_streak == theirs.var_streak
        if want is not None:
            fired += 1
            ours.begin_cooldown()
            theirs.begin_cooldown()
    assert fired == n_events
    if kind == "blame":
        assert ours.blamed == "layers/attn/wo"


def test_detector_nan_fires_through_grace_and_cooldown():
    det = DivergenceDetector(RecoveryConfig(grace_steps=100,
                                            cooldown_steps=100))
    nan, inf = float("nan"), float("inf")
    assert det.update(StepTelemetry(step=0, loss=nan)).kind == "nan_loss"
    assert det.update(StepTelemetry(step=1, loss=2.0,
                                    grad_norm=inf)).kind == "nan_grad"
    det.begin_cooldown()
    assert str(det.update(StepTelemetry(step=2, loss=inf))) == \
        "nan_loss@2(loss=inf)"


def _ladder_ops(reg, tele, plan_cls):
    """Plans, the leaf-LR vector and the state of one regulator driven
    through every rung, the cool-down and the floors."""
    def plan(s):
        p = reg.plan(tele(), plan_cls(seq_len=s, batch_size=8, lr=1e-3))
        return (p.seq_len, p.batch_size, p.lr, p.grad_clip_scale)
    out = [plan(64)]
    reg.deepen_lr("layers/attn/wq")
    out.append(reg.leaf_lr_vector(("embed", "layers/attn/wq")).tolist())
    reg.deepen_lr()
    reg.clamp_seq()
    out += [plan(64), plan(16), plan(8)]
    reg.precursor_cooldown(0.5, 3)
    reg.precursor_cooldown(0.8, 2)
    for _ in range(2):
        out.append(plan(32))
        reg.observe(tele(), 0)
    for _ in range(3):
        reg.clamp_seq()
    reg.skip_data()
    for _ in range(12):
        reg.deepen_lr()
        reg.deepen_lr("layers/attn/wq")
    out += [plan(64), plan(32)]
    reg.observe(tele(), 0)
    out.append(plan(64))
    return out, reg.state_dict()


def test_recovery_regulator_matches_reference(jx):
    ladder = (8, 16, 32, 64)
    cfg = dict(lr_backoff=0.5, lr_floor=0.1, skip_window_steps=4)
    got = _ladder_ops(RecoveryRegulator(ladder, RecoveryConfig(**cfg)),
                      StepTelemetry, StepPlan)
    want = _ladder_ops(
        jx.recovery.RecoveryRegulator(ladder,
                                      jx.recovery.RecoveryConfig(**cfg)),
        jx.regulators.StepTelemetry, jx.regulators.StepPlan)
    assert got == want
    assert got[1]["seq_drop"] == 3 and got[1]["data_offset"] == 4


def test_controller_state_with_recovery_crosses_both_ways(jx):
    ttr = Trainer(_ttc(steps=10), recovery=RecoveryConfig(), device="cpu")
    jtr = jx.train.Trainer(_jtc(jx, steps=10),
                           recovery=jx.recovery.RecoveryConfig())
    for src, dst in ((ttr, jtr), (jtr, ttr)):
        reg = src.stack["recovery"]
        reg.deepen_lr("layers/attn/wq")
        reg.deepen_lr()
        reg.clamp_seq()
        reg.skip_data()
        reg.precursor_cooldown(0.25, 5)
        src.step, src.tokens_seen = 5, 1234
        host = json.loads(json.dumps(src.controller_state().to_host()))
        cs = (ControllerState if dst is ttr
              else jx.regulators.ControllerState).from_host(host)
        dst.load_controller_state(cs)
        assert dst.stack["recovery"].state_dict() == reg.state_dict()
        assert (dst.step, dst.tokens_seen) == (5, 1234)
        assert dst.controller_state().to_host() == host


# ---------------------------------------------------------------------------
# end to end against the reference
# ---------------------------------------------------------------------------

def test_nan_and_spike_recover_as_the_reference(jx):
    jtr, ttr = _pair(jx, "nan_grad@8,spike@14:64.0")
    ref, got = jtr.run(), ttr.run()
    _assert_same_run(got, ref)
    assert got.steps == 20 and not got.diverged and got.rollbacks == 2
    assert got.faults_fired == ["nan_grad@8", "spike@14:64.0"]
    assert got.recovery_events[:2] == ["nan_loss@8(loss=nan)", "restored@5"]
    assert got.recovery_events[3] == "restored@10"
    assert ttr.stack["recovery"].state_dict() == \
        jtr.stack["recovery"].state_dict()


def test_grad_spike_blames_as_the_reference(jx):
    """A one-block gradient spike with clipping off (a clipped spike moves
    no gate): the Adam variance of the attention groups excurses, the
    detector names the same group in both packages, and the per-leaf LR
    backoff lands on it and rides every later step."""
    jtr, ttr = _pair(jx, "grad_spike@8:1000|layers/attn", steps=14,
                     telemetry_level="per_leaf", clip=0.0, slw=False)
    seen = []

    class LeafLR(TrainerHook):
        """Records the leaf_lr vector each step is given."""

        def on_step_start(self, tr):
            seen.append(tr.stack["recovery"].leaf_lr_vector(tr.leaf_labels))

    ttr.hooks.append(LeafLR())
    ref, got = jtr.run(), ttr.run()
    _assert_same_run(got, ref)
    assert got.faults_fired == ["grad_spike@8:1000|layers/attn"]
    assert got.rollbacks == 1
    assert got.recovery_events[0].startswith("var_excursion@")
    blamed = ttr.recovery.detector.blamed
    assert blamed == jtr.recovery.detector.blamed
    assert blamed.startswith("layers/attn"), blamed
    assert f"leaf={blamed}" in got.recovery_events[0]
    scales = ttr.stack["recovery"].leaf_lr_scales
    assert scales == jtr.stack["recovery"].leaf_lr_scales == {blamed: 0.5}
    i = [j for j, v in enumerate(seen) if v is not None][0]
    assert all(v is not None for v in seen[i:])
    want = np.where(np.asarray(ttr.leaf_labels) == blamed, 0.5, 1.0)
    np.testing.assert_array_equal(seen[i], want.astype(np.float32))


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_ring_spill_loads_across_packages(jx, tmp_path, direction):
    """Two snapshots after two steps, spilled by one package and loaded by
    the other: every leaf bit for bit in the JAX layout, and the host
    payload (tokens, controller, telemetry) equal."""
    d = str(tmp_path / "ring")
    jtr = jx.train.Trainer(_jtc(jx, steps=4))
    ttc = _ttc(steps=4)
    ttr = Trainer(ttc, device="cpu")
    ttr.state = bridge.train_state_from_numpy(
        jx.jax.tree_util.tree_map(np.asarray, jtr.state), ttc.model,
        ttc.optimizer, CPU)
    port_side = direction == "port_to_ref"
    src_tr = ttr if port_side else jtr
    src = StateRing(3) if port_side else jx.recovery.StateRing(3)
    src_tr.run(max_steps=2)
    for s in (2, 4):
        src_tr.step = s
        src.push(s, s * 10, src_tr.state, src_tr.controller_state(),
                 src_tr._last)
    like = jx.steps.abstract_train_state(jtr.tc.model, jtr.tc.optimizer)
    if port_side:
        assert src.save(d, ttc.model) == [2, 4]
        dst = jx.recovery.StateRing(3)
        assert dst.load(d, like) == 2
        pairs = [(bridge.train_state_to_numpy(a.state, ttc.model), b.state)
                 for a, b in zip(src, dst._ring)]
    else:
        assert src.save(d) == [2, 4]
        dst = StateRing(3)
        assert dst.load(d, ttc.model, ttc.optimizer) == 2
        pairs = [(a.state, bridge.train_state_to_numpy(b.state, ttc.model))
                 for a, b in zip(src._ring, dst)]
    assert dst.steps == [2, 4]
    for want, got in pairs:
        lw = jx.jax.tree_util.tree_leaves(want)
        lg = jx.jax.tree_util.tree_leaves(got)
        assert len(lw) == len(lg) > 0
        for x, y in zip(lw, lg):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    for a, b in zip(list(src._ring), list(dst._ring)):
        assert b.tokens_seen == a.tokens_seen
        assert b.controller == json.loads(json.dumps(a.controller))
        assert b.telemetry.step == a.telemetry.step
        assert b.telemetry.loss == a.telemetry.loss


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def test_escalation_ladder_engages_in_order():
    inj = FaultInjector(parse_faults("nan_grad@6,nan_grad@9,nan_grad@12"))
    tr = Trainer(_ttc(), recovery=RecoveryConfig(
        policy=RetryPolicy(max_retries=5)), fault_injector=inj, device="cpu")
    res = tr.run()
    assert res.steps == 20 and not res.diverged and res.rollbacks == 3
    assert len(res.faults_fired) == 3
    reg = tr.stack["recovery"]
    assert reg.lr_scale == pytest.approx(0.125)
    assert reg.seq_drop == 2
    assert reg.data_offset == RecoveryConfig().skip_window_steps
    assert math.isfinite(res.loss_history[-1])


def test_persistent_divergence_exhausts_budget_and_stops():
    res = train(_ttc(lr=2000.0), device="cpu",
                recovery=RecoveryConfig(policy=RetryPolicy(max_retries=2)))
    assert res.diverged and res.rollbacks == 2
    assert any(e.startswith("gave_up@") for e in res.recovery_events)


def test_escalate_raise_pairs_with_supervisor(tmp_path):
    d = str(tmp_path / "ck")
    pol = RetryPolicy(max_retries=1)
    sup = TrainSupervisor(policy=pol)

    def run(resume):
        train(_ttc(lr=2000.0, ckpt_dir=d, interval=5), resume=resume,
              device="cpu",
              recovery=RecoveryConfig(policy=pol, escalate="raise"))
        return "ok"

    with pytest.raises(DivergenceError):
        sup.run(run)
    assert sup.restarts == 2
    assert all("DivergenceError" in f["error"] for f in sup.failures)


def test_spike_rollback_replays_exactly():
    """With a no-op intervention the replayed steps are the clean run's,
    bit for bit (one intra-op thread)."""
    clean = train(_ttc(), device="cpu")
    res = train(_ttc(), device="cpu",
                recovery=RecoveryConfig(lr_backoff=1.0, lr_floor=1.0),
                fault_injector=FaultInjector(parse_faults("spike@10:64.0")))
    assert res.steps == 20 and not res.diverged and res.rollbacks == 1
    assert "restored@10" in res.recovery_events
    assert len(res.seqlen_history) == 21
    assert res.seqlen_history[-10:] == clean.seqlen_history[10:]
    assert res.batch_history[-10:] == clean.batch_history[10:]
    assert res.lr_history[-10:] == clean.lr_history[10:]
    np.testing.assert_array_equal(res.loss_history[-10:],
                                  clean.loss_history[10:])


def test_state_ring_capacity_and_isolation():
    ring = StateRing(capacity=2)
    tr = Trainer(_ttc(steps=2), device="cpu")
    for s in (0, 5, 10):
        tr.step = s
        ring.push(s, s * 100, tr.state, tr.controller_state(), tr._last)
    assert ring.steps == [5, 10]
    snap = ring.newest()
    live = tree_leaves(tr.state["params"])
    restored = ring.materialize(snap, CPU)
    again = ring.materialize(snap, CPU)
    for a, b, x in zip(tree_leaves(restored["params"]),
                       tree_leaves(again["params"]), live):
        assert a.data_ptr() != b.data_ptr() != x.data_ptr()
        assert torch.equal(a, b) and torch.equal(a, x)
    # the live state moves on in place; the snapshot does not
    with torch.no_grad():
        torch._foreach_mul_(live, 2.0)
        torch._foreach_mul_(tree_leaves(restored["params"]), 3.0)
    for a, x in zip(tree_leaves(ring.materialize(snap, CPU)["params"]),
                    tree_leaves(again["params"])):
        assert torch.equal(a, x)
    ring.drop_newest()
    assert ring.steps == [5]


def test_state_ring_load_skips_corrupt_entry(tmp_path):
    d = str(tmp_path / "ring")
    tc = _ttc(steps=4)
    tr = Trainer(tc, device="cpu")
    ring = StateRing(capacity=3)
    for s in (2, 4):
        ring.push(s, s * 10, tr.state, tr.controller_state(), tr._last)
    ring.save(d, tc.model)
    FaultInjector(seed=0).corrupt_checkpoint(d, step=4)
    ring2 = StateRing(capacity=3)
    assert ring2.load(d, tc.model, tc.optimizer) == 1
    assert ring2.steps == [2]


def test_state_ring_survives_drain_and_resume(tmp_path):
    d = str(tmp_path / "ck")
    tc = _ttc(steps=30, ckpt_dir=d)

    class StopAt(TrainerHook):
        def on_step_start(self, tr):
            if tr.step >= 9:
                tr.request_drain()

    tr = Trainer(tc, recovery=RecoveryConfig(snapshot_interval=3),
                 hooks=[StopAt()], device="cpu")
    assert tr.run().drained
    assert sorted(os.listdir(os.path.join(d, "ring"))) == [
        f"step_{s:012d}" for s in tr.recovery.ring.steps]
    tr2 = Trainer(tc, recovery=RecoveryConfig(snapshot_interval=3),
                  device="cpu")
    assert tr2.resume() == 9
    assert tr2.recovery.ring.steps == tr.recovery.ring.steps == [3, 6, 9]
    for a, b in zip(tr.recovery.ring, tr2.recovery.ring):
        assert b.tokens_seen == a.tokens_seen
        assert b.telemetry.step == a.telemetry.step
        assert b.telemetry.loss == a.telemetry.loss
        assert b.controller == json.loads(json.dumps(a.controller))
        for x, y in zip(tree_leaves(a.state["params"])
                        + tree_leaves(a.state["opt"]),
                        tree_leaves(b.state["params"])
                        + tree_leaves(b.state["opt"])):
            assert torch.equal(x, y)
    # a NaN after the resume restores from a refilled snapshot
    tr2.fault_injector = inj = FaultInjector(parse_faults("nan_grad@11"))
    tr2.hooks.append(FaultInjectionHook(inj))
    res = tr2.run()
    assert res.steps == 30 and not res.diverged and res.rollbacks == 1
    assert res.recovery_events[:2] == ["nan_loss@11(loss=nan)",
                                       "restored@9"]


def test_precursor_event_snapshots_and_cools_the_lr():
    tr = Trainer(_ttc(steps=12), recovery=RecoveryConfig(), device="cpu")
    ttl, factor = 3, 0.5
    hook = PrecursorHook(precursor=None, controller=tr.recovery,
                         cool=(factor, ttl))

    class Fire:
        def observe(self, step, sketch, labels):
            return (PrecursorEvent(step=step, leaf="pos_embed", score=0.9,
                                   baseline=0.1) if step == 6 else None)

    hook.precursor = Fire()

    class Sketch(TrainerHook):
        """Hands the precursor hook a sketch and records ring steps."""

        def on_step_end(self, tr, tele, plan, metrics):
            hook.on_step_end(tr, dataclasses.replace(
                tele, per_leaf={"gns_sketch": np.ones((16, 4))}), plan,
                metrics)

    tr.hooks.append(Sketch())
    res = tr.run()
    assert res.precursor_events == [
        "precursor@6(leaf=pos_embed corr=0.90 trail=0.10)"]
    assert res.recovery_events == res.precursor_events  # no rollback
    assert 7 in tr.recovery.ring.steps  # the snapshot at the event's step
    planned = [p.lr for p in predict_trajectory(_ttc(steps=12), 12)]
    for i, (got, want) in enumerate(zip(res.lr_history, planned)):
        scale = factor if 7 <= i < 7 + ttl else 1.0
        assert got == want * scale, i


def test_gns_precursor_reaches_the_controller():
    """The trainer wires its precursor to the controller: every event is a
    recovery event with a ring snapshot at the step after it."""
    tc = dataclasses.replace(
        _ttc(steps=16, telemetry_level="per_leaf"),
        gns=GNSConfig(enabled=True, shards=2, precursor_window=4,
                      precursor_dim=8, precursor_grace=1,
                      precursor_gate=-1.0, precursor_rise=-1.0))
    tr = Trainer(tc, recovery=RecoveryConfig(ring=16), device="cpu")
    res = tr.run()
    assert res.precursor_events
    assert all(e in res.recovery_events for e in res.precursor_events)
    steps = [int(e.split("@")[1].split("(")[0]) for e in res.precursor_events]
    assert {s + 1 for s in steps} <= set(tr.recovery.ring.steps)
