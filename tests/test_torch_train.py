"""The port's training path against the JAX package, on the CPU.

* Control plane, exactly: ``predict_trajectory`` gives the same list of
  (seq_len, batch_size, lr, grad_clip_scale) bit for bit, and
  ``apply_seqlen`` the same arrays.  The control plane's state, through
  JSON and back mid-warmup, resumes the uninterrupted plans exactly.
* Optimizer chain: a 50-step fp32 trajectory of the default chain on a
  small tree, gradients from numpy.  Params, ``grad_norm``,
  ``grad_norm_clipped``, ``var_max``, ``var_l1`` and ``mom_l1`` within
  1e-6 relative (plus 1e-7 absolute on params near zero) at every step:
  the same fp32 arithmetic, reduced in another order.
* Loss and every gradient of reduced gpt2 (2 layers, d 64, vocab 512)
  from transferred params: loss within 1e-5 absolute; each gradient leaf
  within 1e-4 x its own largest entry, fp32 through two layers and a
  512-wide tied unembedding summed in another order (the leaves' largest
  entries are 2e-3 to 3e-1, so an absolute floor of 1e-4 would let errors
  of a few percent of a leaf through).  The JAX side runs "flash" as
  its CPU dispatch does (blockwise), the port its ``FlashAttention``
  Function with the plain versions.  The port's remat="full" gives the
  gradients of "none" within 1e-6.
* Trainer: 8 steps of both trainers from one transferred state, with SLW
  and batch warmup: plans and ``n_compiles`` equal; losses, ``var_max``
  and validation perplexities within 1e-4 relative (fp32 Adam steps
  amplify the gradients' last-digit differences a little per step).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.configs import base as jbase
from repro.core import curriculum as jcurriculum
from repro.core import regulators as jregulators
from repro.launch.train import Trainer as JaxTrainer
from repro.models import build_model, init_params
from repro.optim import transforms as jtx
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy, train_state_from_numpy
from repro_torch.configs import base as tbase
from repro_torch.core import curriculum as tcurriculum
from repro_torch.core import regulators as tregulators
from repro_torch.launch.train import Trainer
from repro_torch.models import model_zoo as tzoo
from repro_torch.optim import transforms as ttx

CPU = torch.device("cpu")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# control plane
# ---------------------------------------------------------------------------

def _train_configs(base, preset, pacing, mode, batch_warmup, steps=60):
    """The quickstart's two shapes (``examples/quickstart.py``) in one
    package's config classes."""
    if preset == "100m":
        seq, batch, model = 1024, 16, None
    else:
        seq, batch, model = 256, 8, None
    return base.TrainConfig(
        model=model,
        optimizer=base.OptimizerConfig(
            lr=6e-3, min_lr=2e-4, schedule="token_cosine", warmup_steps=15,
            warmup_tokens=15 * batch * seq, total_steps=steps,
            total_tokens=steps * batch * seq),
        slw=base.SLWConfig(enabled=pacing != "off", pacing=(
            "linear" if pacing == "off" else pacing), start_seq_len=8,
            duration_steps=steps // 3, round_multiple=8, max_buckets=12,
            mode=mode, two_stage_short_len=64),
        batch_warmup=base.BatchWarmupConfig(
            enabled=batch_warmup, start_batch=batch // 2,
            warmup_tokens=steps * batch * seq // 8),
        seq_len=seq, global_batch=batch, remat="none")


def _plans(plans):
    return [(p.seq_len, p.batch_size, p.lr, p.grad_clip_scale) for p in plans]


@pytest.mark.parametrize("pacing", ["linear", "root", "two_stage", "constant",
                                    "variance_gated", "off"])
def test_predict_trajectory_matches_reference_exactly(pacing):
    for preset in ("tiny", "100m"):
        for mode in ("truncate", "repack"):
            for bw in (False, True):
                args = (preset, pacing, mode, bw)
                ref = jregulators.predict_trajectory(
                    _train_configs(jbase, *args), 60)
                got = tregulators.predict_trajectory(
                    _train_configs(tbase, *args), 60)
                assert _plans(got) == _plans(ref), args


def test_apply_seqlen_matches_reference():
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 512, (4, 64), dtype=np.int32),
             "labels": rng.integers(0, 512, (4, 64), dtype=np.int32)}
    for mode in ("truncate", "repack"):
        for s_t in (8, 24, 64, 100):
            got, n = tcurriculum.apply_seqlen(batch, s_t, mode)
            ref, rn = jcurriculum.apply_seqlen(batch, s_t, mode)
            assert n == rn and sorted(got) == sorted(ref)
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k])


def _drive(stack, steps, tokens=0):
    """Plans of ``steps`` calm steps of ``stack`` from ``steps[0]``."""
    plans = []
    for step in steps:
        tele = tregulators.StepTelemetry(step=step, tokens_seen=tokens,
                                         var_max=1.0, grad_norm=1.0)
        plan = stack.plan(tele)
        batch = {"tokens": np.zeros((plan.batch_size, 256), np.int32)}
        _, n = stack.apply(batch, plan)
        stack.observe(tele, n)
        tokens += n
        plans.append(plan)
    return plans, tokens


def test_controller_state_round_trip_resumes_the_plans():
    """The control plane's state, taken to JSON mid-warmup and loaded into a
    fresh stack, continues the uninterrupted run's plans exactly."""
    tc = _train_configs(tbase, "tiny", "variance_gated", "truncate", True)
    whole, _ = _drive(tregulators.build_stack(tc), range(40))
    first = tregulators.build_stack(tc)
    _, tokens = _drive(first, range(15))
    saved = json.loads(json.dumps(first.controller_state(15, tokens).to_host()))
    resumed = tregulators.build_stack(tc)
    resumed.load_controller_state(tregulators.ControllerState.from_host(saved))
    rest, _ = _drive(resumed, range(15, 40), tokens)
    assert _plans(rest) == _plans(whole[15:])
    assert len({p.seq_len for p in rest}) > 1


def test_refused_regulator_kinds_raise():
    tc = dataclasses.replace(
        _train_configs(tbase, "tiny", "linear", "truncate", False),
        regulators=(tbase.RegulatorSpec(kind="var_lr_throttle"),))
    with pytest.raises(NotImplementedError, match="not ported"):
        tregulators.build_stack(tc)


# ---------------------------------------------------------------------------
# optimizer chain
# ---------------------------------------------------------------------------

def _toy_params(rng):
    """JAX tree with scan-stacked ``layers`` leaves, a matrix, a bias and a
    scalar; the port's tree is the same with ``layers`` unstacked."""
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


@pytest.mark.parametrize("decay_mask", ["all", "std"])
def test_optimizer_chain_trajectory_matches_reference(decay_mask):
    rng = np.random.default_rng(7)
    jparams = jax.tree_util.tree_map(jnp.asarray, _toy_params(rng))
    tparams = _unstack(jax.tree_util.tree_map(np.asarray, jparams))
    jtx_ = jtx.build_optimizer(jbase.OptimizerConfig(decay_mask=decay_mask))
    ttx_ = ttx.build_optimizer(tbase.OptimizerConfig(decay_mask=decay_mask))
    jopt, topt = jtx_.init(jparams), ttx_.init(tparams)
    jupdate = jax.jit(jtx_.update)
    for step in range(50):
        # clipped steps (norm ~ 20) and unclipped ones (norm ~ 0.2)
        grads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(np.shape(p)) *
                       (1.0 if step % 3 else 0.01)).astype(np.float32),
            jax.tree_util.tree_map(np.asarray, jparams))
        lr, clip = np.float32(1e-2 * (1 + step % 4)), np.float32(1.0)
        hyper = {"lr": lr, "clip_scale": clip}
        ju, jopt, jtel = jupdate(jax.tree_util.tree_map(jnp.asarray, grads),
                                 jopt, jparams, hyper)
        jparams = jtx.apply_updates(jparams, ju)
        with torch.no_grad():
            tu, topt, ttel = ttx_.update(_unstack(grads), topt, tparams,
                                         {"lr": float(lr),
                                          "clip_scale": float(clip)})
            tparams = ttx.apply_updates(tparams, tu)
        for key in ("grad_norm", "grad_norm_clipped", "var_max", "var_l1",
                    "mom_l1"):
            np.testing.assert_allclose(float(ttel[key]), float(jtel[key]),
                                       rtol=1e-6, err_msg=f"{key} @ {step}")
        ref = _unstack(jax.tree_util.tree_map(np.asarray, jparams))
        for a, r in zip(ttx.tree_leaves(tparams), ttx.tree_leaves(ref)):
            np.testing.assert_allclose(_np(a), _np(r), rtol=1e-6, atol=1e-7,
                                       err_msg=f"params @ {step}")
    assert int(topt["adam"]["count"]) == 50


def test_decay_mask_std_matches_reference_on_the_model_tree():
    cfg = reduced(get_arch("gpt2-117m").model)
    jparams = init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tconfigs.reduced(tconfigs.get_arch("gpt2-117m"))
    ref = jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), m),
        jtx.decay_mask_tree(jparams, "std"), jparams)
    tref = params_from_numpy(ref, tcfg, CPU)  # the reference mask, unstacked
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, CPU)
    got = ttx.tree_leaves(ttx.decay_mask_tree(tparams, "std"))
    want = [bool(m.flatten()[0]) for m in ttx.tree_leaves(tref)]
    assert got == want and 0 < sum(got) < len(got)


# ---------------------------------------------------------------------------
# loss and gradients of reduced gpt2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    cfg = reduced(get_arch("gpt2-117m").model)
    params = init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tconfigs.reduced(tconfigs.get_arch("gpt2-117m"))
    return cfg, params, tcfg


def _port_grads(tcfg, jparams, batch, remat):
    model = tzoo.build_model(tcfg, remat=remat)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               tcfg, CPU)
    leaves = ttx.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = model.loss(params, {k: torch.from_numpy(v).long()
                                        for k, v in batch.items()})
    return loss, metrics, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("s", [8, 40])
def test_loss_and_every_gradient_match_reference(lm, s):
    cfg, jparams, tcfg = lm
    rng = np.random.default_rng(s)
    seqs = rng.integers(0, cfg.vocab_size, (3, s + 1), dtype=np.int32)
    batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
    jmodel = build_model(cfg, dtype=jnp.float32, remat="none")
    (jloss, jm), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    loss, metrics, grads = _port_grads(tcfg, jparams, batch, "none")
    assert abs(loss.item() - float(jloss)) <= 1e-5
    assert metrics["tokens"].item() == float(jm["tokens"]) == 3 * s
    ref = ttx.tree_leaves(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jgrads), tcfg, CPU))
    assert len(ref) == len(grads)
    for g, r in zip(grads, ref):
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item()
    _, _, remat_grads = _port_grads(tcfg, jparams, batch, "full")
    for a, b in zip(remat_grads, grads):
        assert (a - b).abs().max().item() <= 1e-6


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _trainer_config(base, model):
    steps, seq, batch = 8, 64, 4
    return base.TrainConfig(
        model=model,
        optimizer=base.OptimizerConfig(
            lr=3e-3, min_lr=1e-4, warmup_steps=3,
            warmup_tokens=3 * batch * seq, total_steps=steps,
            total_tokens=steps * batch * seq),
        slw=base.SLWConfig(enabled=True, start_seq_len=8, duration_steps=5,
                           round_multiple=8, max_buckets=4),
        batch_warmup=base.BatchWarmupConfig(enabled=True, start_batch=2,
                                            warmup_tokens=600),
        seq_len=seq, global_batch=batch, eval_interval=4)


def test_trainer_matches_reference():
    jtc = _trainer_config(jbase, reduced(get_arch("gpt2-117m").model))
    ttc = _trainer_config(tbase, tconfigs.reduced(
        tconfigs.get_arch("gpt2-117m")))
    jtr = JaxTrainer(jtc, eval_batch=4)
    ttr = Trainer(ttc, eval_batch=4, device="cpu")
    ttr.state = train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtr.state), ttc.model,
        ttc.optimizer, CPU)
    ref, got = jtr.run(), ttr.run()
    assert got.steps == ref.steps == 8
    plans = lambda r: list(zip(r.seqlen_history, r.batch_history,
                               r.lr_history))
    assert plans(got) == plans(ref)
    assert len(set(ref.seqlen_history)) >= 3 and min(ref.batch_history) < 4
    assert got.n_compiles == ref.n_compiles
    for key in ("loss_history", "var_max_history"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   rtol=1e-4, err_msg=key)
    assert [s for s, _ in got.val_ppl_history] == [4, 8]
    np.testing.assert_allclose([p for _, p in got.val_ppl_history],
                               [p for _, p in ref.val_ppl_history], rtol=1e-4)
