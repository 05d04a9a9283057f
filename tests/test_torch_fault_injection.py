"""The port's fault injection against the JAX package's, on the CPU.

* ``parse_faults`` accepts and rejects what the reference does, with the
  same specs and the same messages.
* From one transferred train state of reduced gpt2 (vocab 128), for
  several ``(seed, step)``: ``poison_params`` NaNs the same element of the
  same reference leaf (NaN masks compared through
  ``bridge.train_state_to_numpy``), ``scale_params`` gives the
  reference's params bit for bit and leaves the optimizer state alone,
  ``grad_scale_vector`` gives the same vector, and ``corrupt_checkpoint``
  flips the same bit of the same payload file of one checkpoint.
* The port's own drills, as the reference's ``tests/test_fault_injection.py``
  runs them: fire-once, the crash points (``post_tmp`` resumes exactly
  from the checkpoint before; ``post_rename`` leaves a valid one), a
  flipped bit quarantined with a fallback, and per-leaf blame of an
  injected one-block gradient spike (``tests/test_optim_chain.py:328``).
"""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import latest_step, save
from repro_torch.configs import (OptimizerConfig, RegulatorSpec, SLWConfig,
                                 TrainConfig, get_arch, reduced)
from repro_torch.core.regulators import auto_specs
from repro_torch.core.telemetry import leaf_groups
from repro_torch.distributed.fault_injection import (FaultInjector,
                                                     InjectedCrash,
                                                     parse_faults)
from repro_torch.launch.train import Trainer, train

CPU = torch.device("cpu")
# (seed, step) draws: in the first layer's and the second layer's half of
# a stacked leaf (1, 6 and 13 at step 12 land in layer 1), and in unstacked
# leaves (embed, pos_embed)
SEED_STEPS = ((0, 12), (1, 12), (6, 12), (13, 12), (8, 12), (3, 0),
              (1234, 31), (5, 999))


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
    """The JAX package's fault injector, configs and train state (skips
    where JAX is absent)."""
    jax = pytest.importorskip("jax")
    from repro.configs import base, get_arch as jget_arch, reduced as jreduced
    from repro.distributed import fault_injection
    from repro.launch import steps
    return types.SimpleNamespace(jax=jax, fi=fault_injection, base=base,
                                 get_arch=jget_arch, reduced=jreduced,
                                 steps=steps)


def _cfg():
    return reduced(get_arch("gpt2-117m")).replace(vocab_size=128)


@pytest.fixture(scope="module")
def states(jx):
    """One reduced-gpt2 train state in both packages (the port's from the
    reference's by the bridge); fresh copies on each call."""
    jcfg = jx.reduced(jx.get_arch("gpt2-117m").model).replace(vocab_size=128)
    jstate = jx.steps.init_train_state(jx.jax.random.PRNGKey(0), jcfg,
                                       jx.base.OptimizerConfig())
    host = jx.jax.tree_util.tree_map(np.asarray, jstate)

    def fresh():
        return jstate, bridge.train_state_from_numpy(
            host, _cfg(), OptimizerConfig(), CPU)
    return fresh


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flat(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], np.asarray(tree))]


def bridge_leaves(state):
    from repro_torch.optim.transforms import tree_leaves
    return tree_leaves(state["params"])


def _port_params(state):
    return _flat(bridge.train_state_to_numpy(state, _cfg())["params"])


def _ref_params(jx, jstate):
    return _flat(jx.jax.tree_util.tree_map(np.asarray, jstate["params"]))


# ---------------------------------------------------------------------------
# spec parsing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "nan_grad@12, spike@20:8.0,crash@30:post_tmp,stall@8:0.25",
    "", " , ", "grad_spike@15:64|attn", "grad_spike@3", "crash@5",
    "crash@9:post_rename", "spike@0:1e3,spike@0:2",
    # rejected
    "bogus@3", "nan_grad@x", "nan_grad", "crash@5:mid_write", "Spike@3",
    "nan_grad@-1", "spike@4:", "nan_grad@3:a,b",
])
def test_parse_faults_matches_reference(jx, spec):
    def parse(fn):
        try:
            return [(s.kind, s.step, s.arg, str(s)) for s in fn(spec)]
        except ValueError as e:
            return f"ValueError: {e}"
    assert parse(parse_faults) == parse(jx.fi.parse_faults)


def test_parse_faults_roundtrip():
    specs = parse_faults("nan_grad@12, spike@20:8.0,crash@30:post_tmp,"
                         "stall@8:0.25")
    assert [s.kind for s in specs] == ["nan_grad", "spike", "crash", "stall"]
    assert parse_faults(",".join(str(s) for s in specs)) == specs
    assert parse_faults("") == ()


# ---------------------------------------------------------------------------
# placement against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", SEED_STEPS)
def test_poison_params_hits_the_reference_element(jx, states, seed, step):
    jstate, state = states()
    label, flat, leaf, offset = FaultInjector.poison_target(
        state["params"], FaultInjector(seed=seed)._rng(
            parse_faults(f"nan_grad@{step}")[0]))
    groups = leaf_groups(state["params"])
    g = groups.labels.index(label)
    layer = groups.members[g].index(leaf)
    assert flat == layer * bridge_leaves(state)[leaf].numel() + offset
    assert layer == (1 if (seed, step) in ((1, 12), (6, 12), (13, 12))
                     else 0)
    want = _ref_params(jx, jx.fi.FaultInjector(seed=seed).poison_params(
        jstate, step))
    before = [t.data_ptr() for t in bridge_leaves(state)]
    got = _port_params(FaultInjector(seed=seed).poison_params(state, step))
    assert [t.data_ptr() for t in bridge_leaves(state)] == before  # in place
    assert [k for k, _ in got] == [k for k, _ in want]
    hit = [k for k, a in want if np.isnan(a).any()]
    assert len(hit) == 1 and sum(np.isnan(a).sum() for _, a in want) == 1
    for (key, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=key)
        np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("factor", [8.0, 64.0, 0.1, 2.0])
def test_scale_params_matches_reference(jx, states, factor):
    jstate, state = states()
    opt_before = _flat(bridge.train_state_to_numpy(state, _cfg())["opt"])
    want = _ref_params(jx, jx.fi.FaultInjector().scale_params(
        jstate, 3, factor))
    out = FaultInjector().scale_params(state, 3, factor)
    for (key, g), (_, w) in zip(_port_params(out), want):
        np.testing.assert_array_equal(g, w, err_msg=key)  # bit for bit
    for (key, g), (_, w) in zip(
            _flat(bridge.train_state_to_numpy(out, _cfg())["opt"]),
            opt_before):
        np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("seed,step", SEED_STEPS)
def test_grad_scale_vector_matches_reference(jx, seed, step):
    tr = Trainer(TrainConfig(model=_cfg(), seq_len=16, global_batch=2),
                 device="cpu")
    assert len(tr.leaf_labels) == 16
    for factor, substr in ((1000.0, "layers/attn"), (64.0, ""),
                           (3.0, "no_such_leaf"), (2.0, "ln")):
        got = FaultInjector(seed=seed).grad_scale_vector(
            tr.leaf_labels, step, factor, substr)
        want = jx.fi.FaultInjector(seed=seed).grad_scale_vector(
            tr.leaf_labels, step, factor, substr)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3, 11, 2024])
def test_corrupt_checkpoint_flips_the_reference_bit(jx, states, tmp_path,
                                                    seed):
    _, state = states()
    tree = bridge.train_state_to_numpy(state, _cfg())
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    for d in (ours, theirs):
        save(d, 4, tree, {"step": 4})
        save(d, 8, tree, {"step": 8})
    port_inj, ref_inj = FaultInjector(seed=seed), jx.fi.FaultInjector(seed=seed)
    got = port_inj.corrupt_checkpoint(ours)
    want = ref_inj.corrupt_checkpoint(theirs)
    assert os.path.relpath(got, ours) == os.path.relpath(want, theirs)
    assert "step_000000000008" in got
    assert port_inj.fired == ref_inj.fired
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    for step in (4, 8):  # the other files are untouched
        d = f"step_{step:012d}"
        for name in sorted(os.listdir(os.path.join(ours, d))):
            if os.path.join(ours, d, name) == got:
                continue
            with open(os.path.join(ours, d, name), "rb") as a, \
                    open(os.path.join(theirs, d, name), "rb") as b:
                assert a.read() == b.read(), name
    got = port_inj.corrupt_checkpoint(ours, step=4)
    want = ref_inj.corrupt_checkpoint(theirs, step=4)
    assert os.path.relpath(got, ours) == os.path.relpath(want, theirs)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# fire-once and the crash points (the port alone)
# ---------------------------------------------------------------------------

def _tc(steps=12, seq=64, batch=4, ckpt_dir="", interval=4):
    return TrainConfig(
        model=_cfg(),
        optimizer=OptimizerConfig(
            lr=2e-3, min_lr=1e-5, schedule="token_cosine",
            warmup_steps=4, warmup_tokens=4 * batch * seq,
            total_steps=steps, total_tokens=steps * batch * seq),
        slw=SLWConfig(enabled=True, pacing="linear", start_seq_len=8,
                      duration_steps=steps // 2, round_multiple=8,
                      max_buckets=4),
        seq_len=seq, global_batch=batch, remat="none",
        eval_interval=0, checkpoint_interval=interval,
        checkpoint_dir=ckpt_dir)


def test_pre_step_fires_each_spec_once(states):
    _, state = states()
    tr = types.SimpleNamespace(step=5, state=state)
    inj = FaultInjector(parse_faults("spike@5:2.0,grad_spike@5:8|attn"))
    w0 = bridge_leaves(state)[0].clone()
    inj.pre_step(tr)
    assert inj.fired == ["spike@5:2.0", "grad_spike@5:8|attn"]
    assert tr._pending_grad_fault == (8.0, "attn")
    w1 = bridge_leaves(tr.state)[0].clone()
    assert torch.equal(w1, 2.0 * w0)
    inj.pre_step(tr)  # the step index again after a rollback: no re-fire
    assert inj.fired == ["spike@5:2.0", "grad_spike@5:8|attn"]
    assert torch.equal(bridge_leaves(tr.state)[0], w1)


def test_maybe_crash_matches_point_and_step():
    inj = FaultInjector(parse_faults("crash@30:post_rename,crash@7"))
    inj.maybe_crash("post_tmp", 30)     # wrong point: no-op
    inj.maybe_crash("post_rename", 29)  # wrong step: no-op
    with pytest.raises(InjectedCrash):
        inj.maybe_crash("post_rename", 30)
    inj.maybe_crash("post_rename", 30)  # fire-once
    with pytest.raises(InjectedCrash):  # no point given: post_tmp
        inj.maybe_crash("post_tmp", 7)
    assert inj.fired == ["crash@30:post_rename", "crash@7"]


def test_crash_between_tmp_and_rename_resumes_exactly(tmp_path):
    d_clean, d_crash = str(tmp_path / "clean"), str(tmp_path / "crash")
    clean = train(_tc(ckpt_dir=d_clean), device="cpu")
    assert clean.steps == 12
    inj = FaultInjector(parse_faults("crash@8:post_tmp"), seed=0)
    with pytest.raises(InjectedCrash):
        train(_tc(ckpt_dir=d_crash), fault_injector=inj, device="cpu")
    # the partial tmp dir is on disk but latest_step never trusts it
    assert os.path.isdir(os.path.join(d_crash, "tmp.8"))
    assert latest_step(d_crash) == 4
    res = train(_tc(ckpt_dir=d_crash), resume=True, device="cpu")
    assert res.restored_from_step == 4 and res.steps == 12
    assert res.seqlen_history == clean.seqlen_history[4:]
    assert res.batch_history == clean.batch_history[4:]
    assert res.lr_history == clean.lr_history[4:]
    # one intra-op thread: the resumed steps are the clean run's bits
    np.testing.assert_array_equal(res.loss_history, clean.loss_history[4:])


def test_crash_after_rename_leaves_valid_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    inj = FaultInjector(parse_faults("crash@8:post_rename"), seed=0)
    with pytest.raises(InjectedCrash):
        train(_tc(ckpt_dir=d), fault_injector=inj, device="cpu")
    assert latest_step(d) == 8  # the rename completed
    assert Trainer(_tc(ckpt_dir=d), device="cpu").resume() == 8


def test_bitflip_quarantines_and_falls_back(tmp_path):
    d = str(tmp_path / "ck")
    assert train(_tc(ckpt_dir=d), device="cpu").steps == 12
    assert sorted(n for n in os.listdir(d) if n.startswith("step_")) == [
        f"step_{s:012d}" for s in (4, 8, 12)]
    inj = FaultInjector(seed=3)
    assert "step_000000000012" in inj.corrupt_checkpoint(d)
    assert any(f.startswith("bitflip@12") for f in inj.fired)
    tr = Trainer(_tc(ckpt_dir=d), device="cpu")
    assert tr.resume() == 8  # fell back past the corrupt newest
    assert [q[0] for q in tr.ckpt.quarantined] == [12]
    assert os.path.isdir(os.path.join(d, "corrupt.step_000000000012"))


def test_corrupt_checkpoint_requires_a_checkpoint(tmp_path):
    with pytest.raises(ValueError):
        FaultInjector().corrupt_checkpoint(str(tmp_path))


def test_per_leaf_blame_identifies_injected_layer():
    """A gradient spike on one block's groups through the injector: the
    per-leaf-fed throttle names that block."""
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=12,
                          total_tokens=10 ** 9, schedule="constant",
                          telemetry_level="per_leaf")
    tc = TrainConfig(model=_cfg(), optimizer=opt, seq_len=32, global_batch=4,
                     seed=0, eval_interval=0, checkpoint_interval=0)
    tc = dataclasses.replace(tc, regulators=auto_specs(tc) + (
        RegulatorSpec(kind="var_lr_throttle"),))
    inj = FaultInjector.from_cli("grad_spike@8:1000|layers/attn", seed=0)
    tr = Trainer(tc, fault_injector=inj, device="cpu")
    res = tr.run()
    assert res.faults_fired == ["grad_spike@8:1000|layers/attn"]
    throttle = tr.stack["var_lr_throttle"]
    assert throttle.blamed.startswith("layers/attn"), throttle.blamed
    assert throttle.scale < 1.0
