"""The paper's experiment machinery on the port against the JAX package, on
the CPU.

* The low-cost tuner (``core/tuning.py``): ``significant_fluctuation`` and
  ``tune_slw`` give the reference's trials and choice, exactly, on five
  deterministic synthetic probes (the three of ``tests/test_tuning.py``
  among them).
* ``pearson`` (Table 3): r within 1e-12 of the reference's; p within 1e-4
  relative of the reference's, whose regularized incomplete beta is
  ``jax.scipy``'s in float32 (up to 3.6e-5 relative off
  ``scipy.stats.pearsonr`` at n = 200), and within 1e-10 relative of
  ``scipy.stats.pearsonr``; the edge cases (n < 3, a constant series,
  |r| = 1) as the reference.
* ``VarianceLRThrottle``: the same scale and trailing mean after every
  step of the reference test's sequences, the same LR in a stack, and its
  state through ``ControllerState`` both ways between the packages.
* The port's Trainer with the throttle on reduced gpt2 against the
  reference's, 20 steps from one transferred state: plans equal, losses
  within 1e-5 relative.  The recipe (LR 0.05, gate 1.3) backs the LR off
  four times and keeps every gate decision at least 1e-4 from its
  threshold, so a ~1e-7 difference in var_max cannot flip one.
* ``launch/paper.py``: its ``bench_config`` is ``benchmarks/common.py``'s
  field by field, and the port alone reproduces Table 1's verdict at the
  bench recipe.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.core import regulators as tregulators
from repro_torch.core import stability as tstability
from repro_torch.core import tuning as ttuning
from repro_torch.launch import paper

ROOT = Path(__file__).resolve().parents[1]
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
    """The JAX package's modules (skips where JAX is absent)."""
    pytest.importorskip("jax")
    sys.path.insert(0, str(ROOT))
    import types
    import benchmarks.common
    from repro.configs import base, get_arch, reduced
    from repro.core import regulators, stability, tuning
    from repro.launch import train
    return types.SimpleNamespace(base=base, get_arch=get_arch,
                                 reduced=reduced, regulators=regulators,
                                 stability=stability, tuning=tuning,
                                 train=train, common=benchmarks.common)


# ---------------------------------------------------------------------------
# the low-cost tuner
# ---------------------------------------------------------------------------

def test_significant_fluctuation_matches_reference(jx):
    cases = ([10.0, 9.0, 8.5, 8.0], [10.0, 9.0, 12.0], [10.0, 9.0, 11.0],
             [], [5.0], [9.0, 8.0, 10.4, 10.41], [1.0, float("inf")],
             [3.0, 2.0, 2.6, 2.61])
    for ppls in cases:
        for threshold in (1.3, 1.1, 2.0):
            assert ttuning.significant_fluctuation(ppls, threshold) == \
                jx.tuning.significant_fluctuation(ppls, threshold), ppls


def _calm(ok):
    return [10.0, 9.0, 8.0] if ok else [10.0, 9.0, 14.0]


# (name, probe(start_seq_len, duration_steps) -> ppls, base kwargs, tuner
# kwargs): the three cases of tests/test_tuning.py first
PROBES = [
    ("largest_calm_duration",
     lambda s0, t: _calm(s0 >= 16 and t <= 6 * 100),
     dict(warmup_steps=100, seqlen_s_grid=(8, 16, 32),
          t_multiple_range=(1, 16))),
    ("always_calm", lambda s0, t: _calm(True),
     dict(warmup_steps=10, seqlen_s_grid=(8, 16), t_multiple_range=(1, 4))),
    ("always_fluctuates", lambda s0, t: _calm(False),
     dict(warmup_steps=15, seqlen_s_grid=(8, 16, 32),
          t_multiple_range=(1, 8))),
    ("calm_only_between", lambda s0, t: _calm(s0 == 32 and 6 <= t <= 27),
     dict(warmup_steps=3, seqlen_s_grid=(8, 32, 128),
          t_multiple_range=(1, 9))),
    ("ppl_trace_by_ratio",
     lambda s0, t: [100.0, 80.0, 80.0 * (1.0 + t / (40.0 * s0))],
     dict(warmup_steps=5, seqlen_s_grid=(8, 16, 64),
          t_multiple_range=(2, 12), fluctuation_threshold=1.2)),
]


@pytest.mark.parametrize("name,fn,kw", PROBES, ids=[p[0] for p in PROBES])
def test_tune_slw_matches_reference(jx, name, fn, kw):
    probe = lambda cfg: fn(cfg.start_seq_len, cfg.duration_steps)
    got = ttuning.tune_slw(probe, tbase.SLWConfig(round_multiple=8,
                                                  max_buckets=12), **kw)
    ref = jx.tuning.tune_slw(probe, jx.base.SLWConfig(round_multiple=8,
                                                       max_buckets=12), **kw)
    assert got.trials == ref.trials
    assert (got.seqlen_s, got.duration, got.probe_runs) == \
        (ref.seqlen_s, ref.duration, ref.probe_runs)
    if name == "largest_calm_duration":  # tests/test_tuning.py's reading
        assert (got.seqlen_s, got.duration) == (16, 600)
        assert got.probe_runs <= 3 + 5


def test_tuner_hands_the_probe_an_enabled_slw_config():
    seen = []
    base = tbase.SLWConfig(enabled=False, pacing="root", round_multiple=16)
    ttuning.tune_slw(lambda cfg: seen.append(cfg) or [1.0], base,
                     warmup_steps=4, seqlen_s_grid=(8,),
                     t_multiple_range=(1, 2))
    assert [(c.start_seq_len, c.duration_steps) for c in seen] == \
        [(8, 4), (8, 4), (8, 8)]
    assert all(c.enabled and c.pacing == "root" and c.round_multiple == 16
               for c in seen)


# ---------------------------------------------------------------------------
# pearson
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed,coupling", [(5, 0, 0.5), (30, 1, 0.3),
                                             (80, 2, 0.1), (200, 3, 0.2),
                                             (200, 4, -0.9), (30, 5, 0.0)])
def test_pearson_matches_reference_and_scipy(jx, n, seed, coupling):
    from scipy import stats
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    y = coupling * x + rng.standard_normal(n)
    r, p = tstability.pearson(x, y)
    r_ref, p_ref = jx.stability.pearson(x, y)
    sp = stats.pearsonr(x, y)
    assert abs(r - r_ref) <= 1e-12
    assert abs(p - p_ref) <= 1e-4 * p_ref
    assert abs(p - sp.pvalue) <= 1e-10 * sp.pvalue
    assert abs(r - sp.statistic) <= 1e-12


def test_pearson_edge_cases_match_reference(jx):
    line = np.arange(6.0)
    for x, y in (([1.0, 2.0], [2.0, 1.0]), ([], []),
                 (line, np.full(6, 3.0)), (line, 2 * line + 1),
                 (line, -line)):
        got = tstability.pearson(np.asarray(x), np.asarray(y))
        ref = jx.stability.pearson(np.asarray(x), np.asarray(y))
        for a, b in zip(got, ref):
            assert (math.isnan(a) and math.isnan(b)) or a == b, (x, y)
    assert tstability.pearson(line, -line) == (-1.0, 0.0)


def test_loss_ratio_tracker_state_round_trips_with_reference(jx):
    t, ref = tstability.LossRatioTracker(), jx.stability.LossRatioTracker()
    assert t.state_dict() == ref.state_dict()  # fresh: min_loss inf
    for loss in (5.0, 4.0, 6.5, 3.0, 3.1):
        t.update(loss)
        ref.update(loss)
    state = t.state_dict()
    assert state == ref.state_dict()
    assert sorted(state) == ["max_ratio", "min_loss", "n_spikes", "n_steps",
                             "spike_threshold"]
    back = jx.stability.LossRatioTracker()
    back.load_state_dict(json.loads(json.dumps(state)))
    again = tstability.LossRatioTracker()
    again.load_state_dict(json.loads(json.dumps(back.state_dict())))
    assert again.state_dict() == state
    assert again.update(3.3) == ref.update(3.3)


# ---------------------------------------------------------------------------
# the variance-gated LR throttle
# ---------------------------------------------------------------------------

def _throttle_sequence():
    """The var_max sequence of tests/test_regulators.py:157: a seed, a
    spike, 20 escalating spikes (the floor holds), then calm."""
    seq = [1.0, 100.0] + [100.0 * 10.0 ** i for i in range(20)]
    return seq + [float("nan")] + ["trailing"] * 50


def test_var_lr_throttle_steps_match_reference(jx):
    kw = dict(kind="var_lr_throttle", gate=2.0, floor=0.1, backoff=0.5,
              recovery=1.5)
    got = tregulators.VarianceLRThrottle(tbase.RegulatorSpec(**kw))
    ref = jx.regulators.VarianceLRThrottle(jx.base.RegulatorSpec(**kw))
    trailing = None
    scales = []
    for v in _throttle_sequence():
        if v == "trailing":
            trailing = ref.trailing if trailing is None else trailing
            v = trailing
        got.observe(tregulators.StepTelemetry(var_max=v), 0)
        ref.observe(jx.regulators.StepTelemetry(var_max=v), 0)
        assert (got.scale, got.trailing) == (ref.scale, ref.trailing)
        for lr in (1.0, 2.0, 3e-4):
            p = got.plan(tregulators.StepTelemetry(),
                         tregulators.StepPlan(seq_len=8, batch_size=8, lr=lr))
            q = ref.plan(jx.regulators.StepTelemetry(),
                         jx.regulators.StepPlan(seq_len=8, batch_size=8,
                                                lr=lr))
            assert (p.lr, p.grad_clip_scale) == (q.lr, q.grad_clip_scale)
        scales.append(got.scale)
    assert scales[1] == 0.5 and min(scales) == pytest.approx(0.1)
    assert scales[-1] == 1.0


def _tc(base, regulators):
    return base.TrainConfig(
        model=None, optimizer=base.OptimizerConfig(
            lr=6e-4, warmup_steps=10, warmup_tokens=10 * 8 * 256,
            total_steps=100, total_tokens=100 * 8 * 256),
        slw=base.SLWConfig(enabled=True, start_seq_len=8, duration_steps=40,
                           pacing="variance_gated"),
        batch_warmup=base.BatchWarmupConfig(enabled=True, start_batch=2,
                                            warmup_tokens=50_000),
        regulators=regulators, seq_len=256, global_batch=8)


def _specs(base):
    return (base.RegulatorSpec(kind="seqlen"),
            base.RegulatorSpec(kind="batch_warmup"),
            base.RegulatorSpec(kind="lr"),
            base.RegulatorSpec(kind="var_lr_throttle", backoff=0.5))


def test_throttle_multiplies_the_scheduled_lr_as_the_reference(jx):
    got = tregulators.build_stack(_tc(tbase, _specs(tbase)))
    ref = jx.regulators.build_stack(_tc(jx.base, _specs(jx.base)))
    got["var_lr_throttle"].scale = ref["var_lr_throttle"].scale = 0.5
    for step, tokens in ((0, 0), (5, 4096), (100, 10**6)):
        p = got.plan(tregulators.StepTelemetry(step=step, tokens_seen=tokens))
        q = ref.plan(jx.regulators.StepTelemetry(step=step,
                                                 tokens_seen=tokens))
        assert (p.seq_len, p.batch_size, p.lr, p.grad_clip_scale) == \
            (q.seq_len, q.batch_size, q.lr, q.grad_clip_scale)
    assert p.grad_clip_scale == 0.5


def _drive(stack, telemetry, steps):
    for step in range(steps):
        stack.observe(telemetry(step=step, tokens_seen=step * 256,
                                grad_norm=1.0,
                                var_max=50.0 if step == 10 else 1.0), 256)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_controller_state_crosses_between_packages(jx, direction):
    """The whole control plane's state (seqlen, batch warmup, lr and the
    throttle, the tracker's state and the counters) written by one package
    and loaded by the other through JSON resumes the same plans."""
    pkgs = {"port": (tbase, tregulators), "ref": (jx.base, jx.regulators)}
    src, dst = (("port", "ref") if direction == "port_to_reference"
                else ("ref", "port"))
    sbase, sreg = pkgs[src]
    dbase, dreg = pkgs[dst]
    stack = sreg.build_stack(_tc(sbase, _specs(sbase)))
    _drive(stack, sreg.StepTelemetry, 12)
    tracker = {"min_loss": 3.0, "max_ratio": 1.4, "n_steps": 12,
               "n_spikes": 2, "spike_threshold": 1.2}
    host = json.loads(json.dumps(
        stack.controller_state(12, 12 * 256, tracker).to_host()))
    cs = dreg.ControllerState.from_host(host)
    assert (cs.step, cs.tokens_seen, cs.tracker) == (12, 12 * 256, tracker)
    loaded = dreg.build_stack(_tc(dbase, _specs(dbase)))
    loaded.load_controller_state(cs)
    throttle = loaded["var_lr_throttle"]
    assert (throttle.scale, throttle.trailing) == (
        stack["var_lr_throttle"].scale, stack["var_lr_throttle"].trailing)
    assert throttle.scale < 1.0
    if dst == "ref":
        assert throttle.leaf_trailing == {} and throttle.blamed == ""
    for name in ("seqlen", "batch_warmup", "lr", "var_lr_throttle"):
        a = loaded[name].state_dict()
        b = stack[name].state_dict()
        assert a == b, name
    tele = dict(step=12, tokens_seen=12 * 256)
    p = loaded.plan(dreg.StepTelemetry(**tele))
    q = stack.plan(sreg.StepTelemetry(**tele))
    assert (p.seq_len, p.batch_size, p.lr, p.grad_clip_scale) == \
        (q.seq_len, q.batch_size, q.lr, q.grad_clip_scale)


THROTTLE_LR, THROTTLE_GATE, THROTTLE_STEPS = 0.05, 1.3, 20


def _throttle_trainer_config(base, model):
    seq, batch = 32, 4
    tc = base.TrainConfig(
        model=model, optimizer=base.OptimizerConfig(
            lr=THROTTLE_LR, min_lr=THROTTLE_LR / 30, warmup_steps=3,
            warmup_tokens=3 * batch * seq, total_steps=THROTTLE_STEPS,
            total_tokens=THROTTLE_STEPS * batch * seq),
        slw=base.SLWConfig(enabled=False), seq_len=seq, global_batch=batch,
        eval_interval=10, remat="none")
    return dataclasses.replace(tc, regulators=(
        base.RegulatorSpec(kind="lr"),
        base.RegulatorSpec(kind="var_lr_throttle", gate=THROTTLE_GATE)))


def test_trainer_with_throttle_matches_reference(jx):
    import jax
    from repro_torch import configs as tconfigs
    from repro_torch.bridge import train_state_from_numpy
    from repro_torch.launch.train import Trainer
    jtc = _throttle_trainer_config(
        jx.base, jx.reduced(jx.get_arch("gpt2-117m").model))
    ttc = _throttle_trainer_config(
        tbase, tconfigs.reduced(tconfigs.get_arch("gpt2-117m")))
    jtr = jx.train.Trainer(jtc, eval_batch=4)
    ttr = Trainer(ttc, eval_batch=4, device="cpu")
    ttr.state = train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtr.state), ttc.model,
        ttc.optimizer, CPU)
    ref, got = jtr.run(), ttr.run()
    assert got.steps == ref.steps == THROTTLE_STEPS
    plans = lambda r: list(zip(r.seqlen_history, r.batch_history,
                               r.lr_history))
    assert plans(got) == plans(ref)
    # the gate decisions, replayed from the reference's var_max: the
    # throttle backed off, and no decision sat within 1e-4 of the gate
    trailing, margins = 0.0, []
    for v in ref.var_max_history:
        trailing = trailing or v
        margins.append(abs(v / trailing - THROTTLE_GATE))
        trailing = 0.9 * trailing + 0.1 * v
    assert min(margins) > 1e-4, f"closest gate decision {min(margins)}"
    sched = [jx.regulators.lr_at(jtc.optimizer, i, i * 4 * 32)
             for i in range(THROTTLE_STEPS)]
    assert sum(lr < s for lr, s in zip(ref.lr_history, sched)) >= 4
    np.testing.assert_allclose(got.loss_history, ref.loss_history,
                               rtol=1e-5)
    assert got.tracker_summary["spikes"] == ref.tracker_summary["spikes"]


# ---------------------------------------------------------------------------
# launch/paper.py
# ---------------------------------------------------------------------------

def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_same_fields(got, ref, path=""):
    a, b = _fields(got), _fields(ref)
    shared = sorted(set(a) & set(b))
    assert set(a) <= set(b), (path, sorted(set(a) - set(b)))
    for k in shared:
        if dataclasses.is_dataclass(a[k]):
            _assert_same_fields(a[k], b[k], f"{path}.{k}")
        elif isinstance(a[k], tuple) and a[k] and \
                dataclasses.is_dataclass(a[k][0]):
            assert len(a[k]) == len(b[k])
            for i, (x, y) in enumerate(zip(a[k], b[k])):
                _assert_same_fields(x, y, f"{path}.{k}[{i}]")
        else:
            assert a[k] == b[k], f"{path}.{k}: {a[k]!r} != {b[k]!r}"


@pytest.mark.parametrize("kw", [
    {}, dict(slw=True, lr=0.5, steps=60, duration=30),
    dict(slw=True, batch_warmup=True, lr=6e-2, steps=120, duration=40),
    dict(slw=True, lr=6e-2, steps=45, warmup_steps=15, pacing="two_stage",
         mode="repack", grad_clip=0.25, seq=128, batch=4, seed=7,
         total_tokens=9999)], ids=["default", "table1_slw", "joint",
                                   "options"])
def test_bench_config_is_the_benchmarks(jx, kw):
    _assert_same_fields(paper.bench_config(**kw), jx.common.bench_config(**kw))


def test_bench_config_with_the_throttle_is_the_benchmarks(jx):
    sys.path.insert(0, str(ROOT))
    from benchmarks import bench_table1_stability as jtable1
    got = paper.with_throttle(paper.bench_config(lr=0.5, steps=80))
    ref = jtable1._with_throttle(jx.common.bench_config(lr=0.5, steps=80))
    _assert_same_fields(got, ref)
    names = [n for n, _ in paper.table1_arms(80)]
    assert len(names) == 8 and names[-1] == "table1/baseline_var_lr_throttle"


def test_table1_verdict_on_the_port():
    """Table 1 at the bench recipe (LR 0.5, 60 steps), the port alone:
    the SLW arm has fewer than half the baseline's loss-ratio spikes.  The
    reference read 28 spikes (max ratio 2.13) for the baseline and 3 (1.31)
    for SLW over duration 30, with Pearson(loss ratio, var_max) r = -0.39,
    p = 1.8e-3 for the baseline."""
    _, base, _ = paper.run_arm(
        "baseline", paper.bench_config(lr=0.5, steps=60), "cpu")
    _, slw, _ = paper.run_arm(
        "slw", paper.bench_config(slw=True, lr=0.5, steps=60, duration=30),
        "cpu")
    spikes = (base.tracker_summary["spikes"], slw.tracker_summary["spikes"])
    assert spikes[1] < spikes[0] / 2, spikes
    r, p = paper.correlation(base)["var_max"]
    assert math.isfinite(r) and 0.0 <= p <= 1.0
    stats = paper.arm_stats(base, 1.0)
    assert stats["tokens"] == 60 * 8 * 192 and stats["spikes"] == spikes[0]
