"""The port's sharded step, sequence-sharded flash decode, compressed
all-reduce and migration onto a mesh, on gloo ranks on the CPU, against
the JAX package.

Ranks are spawned processes (``torch.multiprocessing``) meeting through a
``FileStore`` in the test's temporary directory, each on one intra-op
thread; their entry points are ``tests/torch_dist_ranks.py``, which pulls
in no JAX.  The JAX side runs here and the two exchange ``.npz`` files.
Eight ranks run (a), (b) and (d), four ranks (e) and (f):

* (a) the default AdamW chain on reduced gpt2's params sharded by the
  ``fsdp`` rules on a (4, 2) mesh, fed the reference's gradients for 6
  steps, clipped and unclipped: params within rtol 1e-6 / atol 1e-7 and
  ``grad_norm``, ``grad_norm_clipped``, ``var_max``, ``var_l1`` and
  ``mom_l1`` within rtol 1e-6 of the reference's chain, as
  ``tests/test_torch_train.py`` holds the unsharded chain (the global norm
  and the variance statistics reduce over every shard; one rank's own
  norm or maximum is off by far more).
* (b) one sharded step of reduced gpt2 under ``fsdp`` and ``baseline``
  from the reference's params: loss within rtol 1e-5 of the JAX loss,
  every gradient leaf within 1e-5 of the leaf's largest entry, the
  gradients on their params' placements, the whole step's loss,
  ``grad_norm`` and ``var_max`` within rtol 1e-5 of the JAX step's, and
  its updated params as ``torch_dist_ranks.step_params_close`` holds
  them.  (The other families' sharded steps, and the sharded prefill and
  serve steps, are ``tests/test_torch_distributed_models.py``.)
* (d) ``flash_decode_sharded`` over an (8,) sequence mesh against JAX's
  ``reference_decode`` at the reference test's shapes
  (``tests/test_distributed.py:79-102``), pos 41 and the edge cases 0, 7,
  8 and 64 (empty, ragged and full shards), both backends, within 1e-5.
* (e) ``compressed_allreduce`` on 4 ranks with different gradients and
  errors: the mean and each rank's new error equal the values the
  reference's ``ef_compress_tree`` gives per rank (the signs summed, the
  scales averaged) within 1e-6 relative and absolute (values near 1; the
  l1 scale's fp32 mean, summed in another order, moves the error by an
  ulp); and 40 syncs of a replicated gradient average to it within 0.05
  (the reference's slow test).
* (f) ``migrate_row`` with a ``placement``: the row reaches the
  destination slot whole after being placed on a 4-rank mesh.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_dist_ranks as ranks
from repro.configs import get_arch, reduced
from repro.configs import base as jbase
from repro.distributed.collectives import reference_decode
from repro.launch import steps as jsteps
from repro.models import build_model, init_params
from repro.optim import transforms as jtx
from repro.optim.compression import ef_compress_tree

SPAWN_TIMEOUT_S = 300


def _spawn(fn, world, tmp):
    """Run ``fn(rank, world, tmp)`` on ``world`` spawned ranks; kill them
    and fail if they outlast the deadline."""
    ctx = mp.start_processes(fn, args=(world, str(tmp)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.time() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} ranks outlasted "
                               f"{SPAWN_TIMEOUT_S} s")


def _np(x):
    return np.asarray(x)


def _jflat(tree, prefix):
    return ranks.flat(jax.tree_util.tree_map(np.asarray, tree), prefix)


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist8")
    cfg = reduced(get_arch("gpt2-117m").model)
    jparams = init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(11)
    inp, ref = {}, {}
    # (a) the chain fed numpy gradients: clipped steps (norm ~ 300) and
    # unclipped ones (norm ~ 0.3)
    n_steps = 6
    inp.update(_jflat(jparams, "a_params"))
    inp["a_steps"] = np.array(n_steps)
    inp["a_lr"] = np.array([1e-2 * (1 + i % 3) for i in range(n_steps)],
                           np.float32)
    tx = jtx.build_optimizer(jbase.OptimizerConfig())
    update = jax.jit(tx.update)
    p, opt = jparams, tx.init(jparams)
    for i in range(n_steps):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(np.shape(x))
                       * (1.0 if i % 2 == 0 else 1e-3)).astype(np.float32),
            jparams)
        inp.update(_jflat(grads, f"a_grads{i}"))
        u, opt, tel = update(jax.tree_util.tree_map(jnp.asarray, grads), opt,
                             p, {"lr": inp["a_lr"][i],
                                 "clip_scale": np.float32(1.0)})
        p = jtx.apply_updates(p, u)
        for key in ("grad_norm", "grad_norm_clipped", "var_max", "var_l1",
                    "mom_l1"):
            ref[f"a_{key}{i}"] = float(tel[key])
        ref.update(_jflat(p, f"a_params{i}"))
    # (b) loss, gradients and one step of the JAX model from its params
    seqs = rng.integers(0, cfg.vocab_size, (8, 33), dtype=np.int32)
    batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
    inp.update(_jflat(jparams, "b_params"))
    inp["b_tokens"], inp["b_labels"] = batch["tokens"], batch["labels"]
    jmodel = build_model(cfg, dtype=jnp.float32, remat="none")
    (loss, _), grads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    ref["b_loss"] = float(loss)
    ref.update(_jflat(grads, "b_grads"))
    opt_cfg = jbase.OptimizerConfig()
    state = {"params": jparams,
             "opt": jtx.build_optimizer(opt_cfg).init(jparams),
             "step": jnp.zeros((), jnp.int32)}
    state, metrics = jax.jit(jsteps.make_train_step(jmodel, opt_cfg))(
        state, jax.tree_util.tree_map(jnp.asarray, batch), 1e-3)
    for key in ("loss", "grad_norm", "var_max"):
        ref[f"b_step_{key}"] = float(metrics[key])
    ref.update(_jflat(state["params"], "b_step_params"))
    # (d) the reference test's decode shapes
    b, s, h, kv, d = 2, 64, 4, 2, 16
    inp["d_q"] = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    inp["d_k"] = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    inp["d_v"] = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    inp["d_pos"] = np.array([41, 0, 7, 8, 64])
    for pos in inp["d_pos"]:
        ref[f"d_{pos}"] = _np(reference_decode(
            jnp.asarray(inp["d_q"]), jnp.asarray(inp["d_k"]),
            jnp.asarray(inp["d_v"]), jnp.int32(pos)))
    np.savez(tmp / "in8.npz", **inp)
    _spawn(ranks.run8, 8, tmp)
    outs = [np.load(tmp / f"out8_r{r}.npz") for r in range(8)]
    return outs, ref, inp


def test_sharded_adamw_update_matches_reference(eight):
    outs, ref, inp = eight
    out = outs[0]
    # fsdp shards the params over both mesh axes
    assert any("Shard" in p and "Replicate" not in p
               for p in out["a_placements"])
    for i in range(int(inp["a_steps"])):
        for key in ("grad_norm", "grad_norm_clipped", "var_max", "var_l1",
                    "mom_l1"):
            np.testing.assert_allclose(float(out[f"a_{key}{i}"]),
                                       ref[f"a_{key}{i}"], rtol=1e-6,
                                       err_msg=f"{key} @ {i}")
        for key in ref:
            if key.startswith(f"a_params{i}/"):
                np.testing.assert_allclose(out[key], ref[key], rtol=1e-6,
                                           atol=1e-7, err_msg=key)
    # the clip engaged on the even steps only
    assert ref["a_grad_norm0"] > 1.0 > ref["a_grad_norm1"]


@pytest.mark.parametrize("rule_set", ["fsdp", "baseline"])
def test_sharded_step_matches_reference(eight, rule_set):
    outs, ref, inp = eight
    out = outs[0]
    tag = f"b_{rule_set}"
    np.testing.assert_allclose(float(out[f"{tag}_loss"]), ref["b_loss"],
                               rtol=1e-5)
    assert bool(out[f"{tag}_grads_on_param_placements"])
    keys = [k for k in ref if k.startswith("b_grads/")]
    assert len(keys) >= 10
    for key in keys:
        got = out[key.replace("b_grads", f"{tag}_grads")]
        want = ref[key]
        assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want)), key
    for key in ("loss", "grad_norm", "var_max"):
        np.testing.assert_allclose(float(out[f"{tag}_step_{key}"]),
                                   ref[f"b_step_{key}"], rtol=1e-5,
                                   err_msg=key)
    sfx = [k[len("b_step_params"):] for k in ref
           if k.startswith("b_step_params/")]
    tight = ranks.step_params_close(
        {s: out[f"{tag}_step_params{s}"] for s in sfx},
        {s: ref[f"b_step_params{s}"] for s in sfx},
        {s: ref[f"b_grads{s}"] for s in sfx},
        {s: inp[f"b_params{s}"] for s in sfx},
        ref["b_step_grad_norm"], jbase.OptimizerConfig(), 1e-3)
    assert tight >= 0.75 * sum(ref[f"b_step_params{s}"].size for s in sfx)
    # every rank saw the same whole metrics
    for other in outs[1:]:
        assert float(other[f"{tag}_step_loss"]) == float(
            out[f"{tag}_step_loss"])


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_flash_decode_sharded_matches_reference(eight, backend):
    outs, ref, inp = eight
    for pos in inp["d_pos"]:
        for out in outs:
            np.testing.assert_allclose(out[f"d_{backend}_{pos}"],
                                       ref[f"d_{pos}"], atol=1e-5,
                                       rtol=1e-5, err_msg=f"pos {pos}")


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist4")
    rng = np.random.default_rng(5)
    inp, ref = {}, {}
    comps = []
    for r in range(4):
        g = {"w": rng.standard_normal(4).astype(np.float32),
             "b": rng.standard_normal((3, 5)).astype(np.float32)}
        e = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in g.items()}
        inp.update(ranks.flat(g, f"e_grads{r}"))
        inp.update(ranks.flat(e, f"e_err{r}"))
        comp, _, new_err = ef_compress_tree(
            jax.tree_util.tree_map(jnp.asarray, g),
            jax.tree_util.tree_map(jnp.asarray, e))
        comps.append(comp)
        ref.update(_jflat(new_err, f"e_newerr{r}"))
    for k in ("w", "b"):
        signs = sum(np.asarray(c["signs"][k]).astype(np.int32) for c in comps)
        scale = sum(np.float32(c["scales"][k]) for c in comps) / 4
        ref[f"e_mean/{k}"] = signs.astype(np.float32) * scale / 4
    np.savez(tmp / "in4.npz", **inp)
    _spawn(ranks.run4, 4, tmp)
    return [np.load(tmp / f"out4_r{r}.npz") for r in range(4)], ref


def test_compressed_allreduce_matches_reference_and_converges(four):
    outs, ref = four
    for r, out in enumerate(outs):
        for k in ("w", "b"):
            np.testing.assert_allclose(out[f"e_mean/{k}"], ref[f"e_mean/{k}"],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(out[f"e_newerr/{k}"],
                                       ref[f"e_newerr{r}/{k}"], rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_allclose(out["e_running_mean"],
                                   [0.5, -0.02, 0.3, -0.7], atol=0.05)


def test_migrate_row_onto_a_mesh(four):
    outs, _ = four
    for out in outs:
        assert bool(out["f_equal"])
        # every leaf was placed replicated on the 4-rank mesh, and met the
        # plain destination cache whole
        assert list(out["f_placed"]) == [
            f"{k}=(Replicate(),)" for k in ("k", "pos", "v")]
        assert bool(out["f_plain_insert"])
        assert list(out["f_src_active"]) == [False, False]
        assert list(out["f_dst_active"]) == [False, False, True]
