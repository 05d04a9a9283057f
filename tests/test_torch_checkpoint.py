"""Checkpoints, resume and restart supervision on the port, on the CPU.

* The reference's ``tests/test_checkpoint.py`` cases against the port's
  ``repro_torch.checkpoint``: round trip, an incomplete directory, keep-N,
  a missing leaf, the crc32 in the manifest, a flipped byte, a shape
  mismatch, an unreadable manifest, a legacy manifest without crc32, and
  ``restore_latest``'s quarantine and fallback (and all corrupt).
* The format is the JAX package's: a checkpoint of reduced gpt2, zamba2
  and deepseek-moe-16b written by the port restores in ``repro.checkpoint`` with
  the JAX tree as ``like``, and the reverse, every leaf bit-equal; the
  port's Trainer resumes a checkpoint the JAX Trainer wrote from the
  port's, with the same controller state.
* Resume (as ``tests/test_train_loop.py:58``, ``:70`` and ``:154``): a
  final checkpoint leaves nothing to do, and a restart mid-warmup (the
  joint recipe; variance-gated pacing) gives the uninterrupted run's plans
  exactly and its losses within 1e-6 relative.
* ``TrainSupervisor`` recovers from ``fail_at_step``, ``RetryPolicy``
  backs off, and the drain path saves a checkpoint.
"""
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import (CheckpointCorruption, CheckpointManager,
                                    available_steps, latest_step,
                                    migrate_host_state, restore, save)
from repro_torch.configs import (BatchWarmupConfig, OptimizerConfig,
                                 SLWConfig, TrainConfig, get_arch, reduced)
from repro_torch.distributed.fault_tolerance import (DrainSignal,
                                                     RetryPolicy,
                                                     TrainSupervisor)
from repro_torch.launch.train import Trainer, train

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
    """The JAX package's checkpoint, steps and trainer (skips where JAX is
    absent)."""
    jax = pytest.importorskip("jax")
    import types
    from repro import checkpoint
    from repro.configs import base, get_arch as jget_arch, reduced as jreduced
    from repro.launch import steps, train as jtrain
    return types.SimpleNamespace(jax=jax, checkpoint=checkpoint, base=base,
                                 get_arch=jget_arch, reduced=jreduced,
                                 steps=steps, train=jtrain)


# ---------------------------------------------------------------------------
# the reference's checkpoint cases against the port
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((4, 8)).astype(np.float32),
                       "b": np.zeros(8, np.float32)},
            "opt": {"m": {"w": np.ones((4, 8), np.float32),
                          "b": np.zeros(8, np.float32)},
                    "count": np.asarray(7, np.int32)},
            "step": np.asarray(7, np.int32)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _assert_equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _flip_payload_byte(d, step, which=0):
    path = os.path.join(d, f"step_{step:012d}")
    payloads = sorted(n for n in os.listdir(path) if n.endswith(".npy"))
    target = os.path.join(path, payloads[which])
    with open(target, "r+b") as f:
        data = bytearray(f.read())
        data[-1] ^= 0xFF  # inside the array payload, past the .npy header
        f.seek(0)
        f.write(data)
    return target


def test_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _tree()
    torch_tree = {"params": {k: torch.from_numpy(v)
                             for k, v in tree["params"].items()},
                  "opt": tree["opt"], "step": torch.tensor(7, dtype=torch.int32)}
    save(d, 7, torch_tree, {"tokens_seen": 12345, "curriculum": {"step": 7}})
    got, host = restore(d, 7, tree)
    _assert_equal_trees(got, tree)
    assert host["tokens_seen"] == 12345


def test_latest_skips_incomplete(tmp_path):
    d = str(tmp_path / "ckpt")
    save(d, 3, _tree())
    save(d, 9, _tree())
    os.makedirs(os.path.join(d, "step_000000000012"))  # crashed mid-write
    assert latest_step(d) == 9


def test_keep_n_gc(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    steps = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert len(steps) == 2
    assert mgr.latest_step() == 4


def test_restore_latest_roundtrip_manager(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, keep=3)
    mgr.save(11, _tree(), {"step": 11})
    step, got, host = mgr.restore_latest(_tree(1))
    assert step == 11 and host["step"] == 11
    _assert_equal_trees(got, _tree())


def test_restore_missing_leaf_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    save(d, 1, {"a": np.zeros(3)})
    with pytest.raises(ValueError, match="missing"):
        restore(d, 1, {"a": np.zeros(3), "b": np.zeros(3)})


def test_manifest_carries_crc32_per_leaf(tmp_path):
    d = str(tmp_path / "ckpt")
    save(d, 2, _tree())
    with open(os.path.join(d, "step_000000000002", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 2 and manifest["n_leaves"] == 6
    assert sorted(manifest["leaves"]) == [
        "opt/count", "opt/m/b", "opt/m/w", "params/b", "params/w", "step"]
    for meta in manifest["leaves"].values():
        assert isinstance(meta["crc32"], int)
        assert sorted(meta) == ["crc32", "dtype", "file", "shape"]


def test_bitflip_fails_checksum(tmp_path):
    d = str(tmp_path / "ckpt")
    save(d, 2, _tree())
    _flip_payload_byte(d, 2)
    with pytest.raises(CheckpointCorruption, match="crc32"):
        restore(d, 2, _tree())


def test_shape_mismatch_is_corruption(tmp_path):
    d = str(tmp_path / "ckpt")
    save(d, 2, _tree())
    path = os.path.join(d, "step_000000000002")
    payloads = sorted(n for n in os.listdir(path) if n.endswith(".npy"))
    np.save(os.path.join(path, payloads[0]), np.zeros((2, 2)))
    with pytest.raises(CheckpointCorruption):
        restore(d, 2, _tree())


def test_unreadable_manifest_is_corruption(tmp_path):
    d = str(tmp_path / "ckpt")
    save(d, 2, _tree())
    with open(os.path.join(d, "step_000000000002", "manifest.json"),
              "w") as f:
        f.write("{not json")
    with pytest.raises(CheckpointCorruption):
        restore(d, 2, _tree())


def test_legacy_manifest_without_crc_still_restores(tmp_path):
    d = str(tmp_path / "ckpt")
    save(d, 2, _tree())
    mpath = os.path.join(d, "step_000000000002", "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    for meta in manifest["leaves"].values():
        del meta["crc32"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    got, _ = restore(d, 2, _tree())
    _assert_equal_trees(got, _tree())


def test_legacy_flat_opt_payload_restores_into_the_chain(tmp_path):
    d = str(tmp_path / "ckpt")
    legacy = _tree()
    legacy["opt"]["v"] = {"w": np.full((4, 8), 2.0, np.float32),
                          "b": np.ones(8, np.float32)}
    save(d, 5, legacy)
    like = {"params": legacy["params"], "step": legacy["step"],
            "opt": migrate_host_state({"opt": legacy["opt"]})["opt"]}
    got, _ = restore(d, 5, like)
    np.testing.assert_array_equal(got["opt"]["adam"]["v"]["w"], 2.0)
    assert int(got["opt"]["adam"]["count"]) == 7
    host = migrate_host_state({"step": 5, "tokens_seen": 9,
                               "curriculum": {"step": 5}})
    assert host["controller"] == {"step": 5, "tokens_seen": 9,
                                  "regulators": {"seqlen": {"step": 5}},
                                  "tracker": {}}


def test_restore_latest_quarantines_and_falls_back(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, keep=3)
    for s in (3, 6, 9):
        mgr.save(s, _tree(), {"step": s})
    _flip_payload_byte(d, 9)
    step, got, host = mgr.restore_latest(_tree())
    assert step == 6 and host["step"] == 6
    assert [q[0] for q in mgr.quarantined] == [9]
    assert "crc32" in mgr.quarantined[0][2]
    assert os.path.isdir(os.path.join(d, "corrupt.step_000000000009"))
    assert latest_step(d) == 6
    assert available_steps(d) == [6, 3]


def test_restore_latest_all_corrupt_cold_starts(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, keep=3)
    for s in (3, 6):
        mgr.save(s, _tree())
    _flip_payload_byte(d, 3)
    _flip_payload_byte(d, 6)
    step, got, host = mgr.restore_latest(_tree())
    assert step is None and got is None and host is None
    assert sorted(q[0] for q in mgr.quarantined) == [3, 6]


# ---------------------------------------------------------------------------
# the JAX package's format, both ways
# ---------------------------------------------------------------------------

def _jax_state(jx, arch, seed):
    """The reference's initial train state on the host, its Adam moments
    and counters filled with random values so that every leaf says
    something."""
    cfg = jx.reduced(jx.get_arch(arch).model)
    state = jx.jax.tree_util.tree_map(np.asarray, jx.steps.init_train_state(
        jx.jax.random.PRNGKey(seed), cfg, jx.base.OptimizerConfig()))
    rng = np.random.default_rng(seed)
    rand = lambda a: rng.standard_normal(a.shape).astype(a.dtype)
    adam = state["opt"]["adam"]
    adam["m"] = jx.jax.tree_util.tree_map(rand, adam["m"])
    adam["v"] = jx.jax.tree_util.tree_map(lambda a: np.abs(rand(a)),
                                          adam["v"])
    adam["count"] = np.asarray(11, np.int32)
    state["step"] = np.asarray(11, np.int32)
    return state


@pytest.mark.parametrize("arch", ["gpt2-117m", "zamba2-2.7b",
                                  "deepseek-moe-16b"])
def test_port_checkpoint_restores_in_the_reference(jx, tmp_path, arch):
    ref_state = _jax_state(jx, arch, 3)
    cfg = reduced(get_arch(arch))
    port_state = bridge.train_state_from_numpy(ref_state, cfg,
                                               OptimizerConfig(), CPU)
    d = str(tmp_path / "ck")
    save(d, 11, bridge.train_state_to_numpy(port_state, cfg), {"step": 11})
    like = jx.steps.abstract_train_state(
        jx.reduced(jx.get_arch(arch).model), jx.base.OptimizerConfig())
    got, host = jx.checkpoint.restore(d, 11, like)
    got = jx.jax.tree_util.tree_map(np.asarray, got)
    _assert_equal_trees(got, ref_state)
    assert host == {"step": 11}


@pytest.mark.parametrize("arch", ["gpt2-117m", "zamba2-2.7b",
                                  "deepseek-moe-16b"])
def test_reference_checkpoint_restores_in_the_port(jx, tmp_path, arch):
    ref_state = _jax_state(jx, arch, 4)
    d = str(tmp_path / "ck")
    jx.checkpoint.save(d, 11, ref_state, {"step": 11})
    cfg = reduced(get_arch(arch))
    like = bridge.abstract_train_state(cfg, OptimizerConfig())
    got, host = restore(d, 11, like)
    _assert_equal_trees(got, ref_state)
    port_state = bridge.train_state_from_numpy(got, cfg, OptimizerConfig(),
                                               CPU)
    _assert_equal_trees(bridge.train_state_to_numpy(port_state, cfg),
                        ref_state)


def _tc(total_steps=32, ckpt_dir="", pacing="linear", joint=True,
        interval=4, seq=32, batch=4):
    """Reduced gpt2 on the joint recipe.  The token-wise LR schedule and the
    warmups do not depend on ``total_steps``, so runs of different lengths
    share a trajectory."""
    cfg = reduced(get_arch("gpt2-117m")).replace(vocab_size=256)
    return TrainConfig(
        model=cfg,
        optimizer=OptimizerConfig(
            lr=2e-3, min_lr=1e-5, warmup_steps=4,
            warmup_tokens=4 * batch * seq, total_steps=total_steps,
            total_tokens=32 * batch * seq),
        slw=SLWConfig(enabled=True, pacing=pacing, start_seq_len=8,
                      duration_steps=12, round_multiple=8, max_buckets=4),
        batch_warmup=BatchWarmupConfig(enabled=joint, start_batch=2,
                                       warmup_tokens=600),
        seq_len=seq, global_batch=batch, remat="none", eval_interval=0,
        checkpoint_interval=interval, checkpoint_dir=ckpt_dir)


def test_trainer_checkpoints_cross_between_packages(jx, tmp_path):
    """The port's Trainer writes a checkpoint mid-warmup; the JAX Trainer
    resumes it (the same params and controller state) and writes its own;
    the port's Trainer resumes that one to the same state again."""
    d_port, d_ref = str(tmp_path / "port"), str(tmp_path / "ref")
    tr = Trainer(_tc(ckpt_dir=d_port), device="cpu")
    tr.run(max_steps=6)
    assert latest_step(d_port) == 6
    want = bridge.train_state_to_numpy(tr.state, tr.tc.model)
    cs = tr.controller_state().to_host()

    jcfg = jx.reduced(jx.get_arch("gpt2-117m").model).replace(vocab_size=256)
    jtc = jx.base.TrainConfig(
        model=jcfg, optimizer=jx.base.OptimizerConfig(
            lr=2e-3, min_lr=1e-5, warmup_steps=4, warmup_tokens=4 * 4 * 32,
            total_steps=32, total_tokens=32 * 4 * 32),
        slw=jx.base.SLWConfig(enabled=True, start_seq_len=8,
                              duration_steps=12, round_multiple=8,
                              max_buckets=4),
        batch_warmup=jx.base.BatchWarmupConfig(enabled=True, start_batch=2,
                                               warmup_tokens=600),
        seq_len=32, global_batch=4, remat="none", eval_interval=0,
        checkpoint_interval=4, checkpoint_dir=d_port)
    jtr = jx.train.Trainer(jtc)
    assert jtr.resume() == 6
    _assert_equal_trees(jx.jax.tree_util.tree_map(np.asarray, jtr.state),
                        want)
    assert json.loads(json.dumps(jtr.controller_state().to_host())) == \
        json.loads(json.dumps(cs))
    jtr.ckpt = jx.checkpoint.CheckpointManager(d_ref, 3)
    jtr.save_checkpoint()

    back = Trainer(_tc(ckpt_dir=d_ref), device="cpu")
    assert back.resume() == 6
    _assert_equal_trees(bridge.train_state_to_numpy(back.state,
                                                    back.tc.model), want)
    assert back.controller_state().to_host() == cs
    assert back.result.restored_from_step == 6


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

def _plans(res):
    return list(zip(res.seqlen_history, res.batch_history, res.lr_history))


def test_resume_from_the_final_checkpoint_has_nothing_left(tmp_path):
    d = str(tmp_path / "ck")
    full = train(_tc(total_steps=8, ckpt_dir=d), device="cpu")
    part = train(_tc(total_steps=8, ckpt_dir=d), resume=True, device="cpu")
    assert full.steps == 8 and available_steps(d) == [8, 4]
    assert part.restored_from_step == 8 and part.steps == 8


@pytest.mark.parametrize("pacing,joint", [("linear", True),
                                          ("variance_gated", False)])
def test_resume_mid_warmup_continues_the_uninterrupted_run(tmp_path, pacing,
                                                           joint):
    """8 steps, a checkpoint, a fresh Trainer resumed from it for 8 more:
    the plans of the uninterrupted 16 steps exactly, its losses within
    1e-6, and the curriculum's state (the variance gate's level) as it
    was."""
    whole = Trainer(_tc(pacing=pacing, joint=joint), device="cpu")
    ref = whole.run(max_steps=16)
    d = str(tmp_path / "ck")
    first = Trainer(_tc(pacing=pacing, joint=joint, ckpt_dir=d,
                        interval=8), device="cpu")
    r1 = first.run(max_steps=8)
    assert latest_step(d) == 8
    saved = dataclasses.asdict(first.stack["seqlen"].curriculum.state)
    second = Trainer(_tc(pacing=pacing, joint=joint, ckpt_dir=d),
                     device="cpu")
    assert second.resume() == 8
    assert dataclasses.asdict(second.stack["seqlen"].curriculum.state) == \
        saved
    r2 = second.run(max_steps=8)
    assert r2.steps == 16 and r2.restored_from_step == 8
    assert _plans(r1) + _plans(r2) == _plans(ref)
    assert len(set(ref.seqlen_history[8:])) > 1  # still warming up
    if joint:
        assert r1.batch_history[-1] < 4
    else:
        assert saved["gate_level"] > 0 and saved["var_trailing"] > 0.0
    np.testing.assert_allclose(r1.loss_history + r2.loss_history,
                               ref.loss_history, rtol=1e-6)
    assert r2.tokens == ref.tokens
    assert second.tracker.state_dict()["n_steps"] == 16


def test_supervisor_recovers_from_injected_failure(tmp_path):
    d = str(tmp_path / "ck")
    sup = TrainSupervisor(policy=RetryPolicy(max_retries=1))
    resumed = []

    def run(resume: bool) -> str:
        res = train(_tc(total_steps=12, ckpt_dir=d), resume=resume,
                    fail_at_step=None if resume else 7, device="cpu")
        resumed.append(res.restored_from_step)
        return f"ok:{res.steps}"

    assert sup.run(run) == "ok:12"
    assert sup.restarts == 1 and resumed == [4]
    assert [f["error"] for f in sup.failures] == [
        "RuntimeError: injected failure at step 7"]


def test_supervisor_gives_up_after_its_retries():
    sup = TrainSupervisor(policy=RetryPolicy(max_retries=2))
    with pytest.raises(RuntimeError, match="boom 3"):
        sup.run(lambda resume: (_ for _ in ()).throw(
            RuntimeError(f"boom {sup.restarts + 1}")))
    assert sup.restarts == 3 and len(sup.failures) == 3


def test_retry_policy_exponential_backoff_with_cap():
    pol = RetryPolicy(max_retries=5, backoff_s=0.5, backoff_factor=2.0,
                      backoff_cap_s=3.0)
    assert [pol.delay(a) for a in (1, 2, 3, 4, 5)] == \
        [0.5, 1.0, 2.0, 3.0, 3.0]
    assert RetryPolicy(backoff_s=0.0).delay(3) == 0.0


def test_supervisor_records_failures_and_backs_off():
    sup = TrainSupervisor(policy=RetryPolicy(max_retries=2, backoff_s=0.05,
                                             backoff_factor=2.0))
    attempts = []

    def run(resume):
        attempts.append(resume)
        if len(attempts) < 3:
            raise RuntimeError(f"boom {len(attempts)}")
        return "ok"

    t0 = time.time()
    assert sup.run(run) == "ok"
    assert time.time() - t0 >= 0.05 + 0.1
    assert attempts == [False, True, True]
    assert [f["attempt"] for f in sup.failures] == [1, 2]
    assert all(f["error"].startswith("RuntimeError: boom")
               for f in sup.failures)


def test_custom_hooks_extend_the_defaults_checkpoint_hook_included():
    from repro_torch.launch.train import (CheckpointHook, DrainHook,
                                          EvalHook, TelemetryHook,
                                          TrainerHook, WatchdogHook)

    class Extra(TrainerHook):
        pass

    extra = Extra()
    tr = Trainer(_tc(), hooks=[extra], device="cpu")
    assert [type(h) for h in tr.hooks] == [DrainHook, WatchdogHook,
                                           TelemetryHook, EvalHook,
                                           CheckpointHook, Extra]
    assert tr.ckpt is None and tr.resume() is None


def test_drain_checkpoints_and_exits(tmp_path):
    d = str(tmp_path / "ck")
    drain = DrainSignal(install=False)

    def cb(step, metrics):
        if step == 4:
            drain.trigger()

    res = train(_tc(ckpt_dir=d, interval=0), drain=drain, callback=cb,
                device="cpu")
    assert res.drained and res.steps == 5
    assert latest_step(d) == 5  # checkpointed on the way out


def test_train_cli_checkpoints_resumes_and_throttles(tmp_path, capsys):
    from repro_torch.launch import train as cli
    d = str(tmp_path / "ck")
    flags = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
             "--slw", "--duration", "4", "--eval-interval", "0",
             "--ckpt-dir", d, "--ckpt-interval", "2", "--var-lr-throttle"]
    assert cli.main(flags + ["--steps", "4"]) == 0
    assert available_steps(d) == [4, 2]
    with open(os.path.join(d, "step_000000000004", "manifest.json")) as f:
        regulators = json.load(f)["host"]["controller"]["regulators"]
    assert sorted(regulators) == ["lr", "seqlen", "var_lr_throttle"]
    assert cli.main(flags + ["--steps", "6", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from the step-4 checkpoint" in out
    assert "done: steps=6" in out
