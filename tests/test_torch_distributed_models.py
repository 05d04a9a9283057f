"""The port's sharded steps of every model family, and its sharded prefill
and serve steps, on four gloo ranks on the CPU, against the JAX package.

Ranks are spawned processes meeting through a ``FileStore`` in the test's
temporary directory, each on one intra-op thread; their entry point is
``run_models`` in ``tests/torch_dist_ranks.py``, which pulls in no JAX.
The JAX side runs here, from the same params and batches, and the two
exchange ``.npz`` files.  The mesh is (2, 2) ``("data", "model")``:

* One training step of reduced zamba2 (the SSD kernel's Function and
  flash attention under ``local_call``), reduced rwkv6 (the WKV-6
  Function under ``local_call``) and reduced deepseek-moe (the row-local
  dispatch under ``local_call``, the expert buffers constrained to
  ``("batch", "experts", ...)``), params and optimizer state sharded by
  the ``fsdp`` rules, from the JAX package's params (its zero-initialised
  leaves redrawn):
  - the sharded loss within rtol 1e-5 of ``jax.value_and_grad`` of the
    JAX model, and every gradient leaf within ``GRAD_TOL`` of the leaf's
    largest entry (1e-5; 1e-4 for rwkv6, as its unsharded family test
    holds the port's WKV-6 to the JAX oracle);
  - the whole step's loss, ``grad_norm`` and ``var_max`` within rtol 1e-5
    of the JAX package's ``make_train_step`` (the default AdamW chain,
    the clip engaged), and its updated params as
    ``torch_dist_ranks.step_params_close`` holds them.
* The same step of reduced gpt2 and reduced deepseek-moe under remat
  "dots" (selective checkpointing replays the block's ops in order, so
  ``constrain`` and ``local_call`` must issue the same ones when the
  backward recomputes it), against the JAX package's "dots" step, held
  as above.
* Reduced gpt2 under ``fsdp`` and ``serve_tp``: the sharded prefill
  step's logits and KV cache, and two serve steps (flash decode under
  ``local_call``, heads on ``"model"`` and slots on ``"data"``) from the
  JAX prefill's cache, their logits and the cache after them, within
  1e-5 of the JAX package's.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_dist_ranks as ranks
from repro.configs import base as jbase
from repro.configs import get_arch, reduced
from repro.launch import steps as jsteps
from repro.models import build_model, init_params
from repro.optim import transforms as jtx

SPAWN_TIMEOUT_S = 300
ARCHS = ("zamba2-2.7b", "rwkv6-7b", "deepseek-moe-16b")
DOTS_ARCHS = ("gpt2-117m", "deepseek-moe-16b")  # also stepped under "dots"
GRAD_TOL = {"zamba2-2.7b": 1e-5, "rwkv6-7b": 1e-4, "deepseek-moe-16b": 1e-5,
            "gpt2-117m": 1e-5}
# zero-initialised leaves, redrawn so that every gradient is non-trivial
REDRAWN = {"zamba2-2.7b": ("a_log", "dt_bias", "'b'"),
           "rwkv6-7b": ("mix", "w_base", "w_lora_b"),
           "deepseek-moe-16b": (), "gpt2-117m": ()}
LR = 1e-3


def _spawn(fn, world, tmp):
    ctx = mp.start_processes(fn, args=(world, str(tmp)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.time() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} ranks outlasted "
                               f"{SPAWN_TIMEOUT_S} s")


def _jflat(tree, prefix):
    return ranks.flat(jax.tree_util.tree_map(np.asarray, tree), prefix)


def _params(arch, cfg, rng):
    def redraw(path, x):
        if any(n in jax.tree_util.keystr(path) for n in REDRAWN[arch]):
            return jnp.asarray(
                (0.5 * rng.standard_normal(x.shape)).astype(np.float32))
        return x
    return jax.tree_util.tree_map_with_path(
        redraw, init_params(jax.random.PRNGKey(0), cfg))


def _reference_step(cfg, params, jbatch, remat, ref, prefix):
    """The JAX package's loss and gradients, and one whole train step,
    under ``remat``, into ``ref`` under ``prefix``."""
    opt = jbase.OptimizerConfig()
    model = build_model(cfg, dtype=jnp.float32, remat=remat)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(params, jbatch)
    ref[f"{prefix}_loss"] = float(loss)
    ref.update(_jflat(grads, f"{prefix}_grads"))
    state = {"params": params,
             "opt": jtx.build_optimizer(opt).init(params),
             "step": jnp.zeros((), jnp.int32)}
    state, metrics = jax.jit(jsteps.make_train_step(model, opt))(
        state, jbatch, LR)
    for key in ("loss", "grad_norm", "var_max"):
        ref[f"{prefix}_step_{key}"] = float(metrics[key])
    ref.update(_jflat(state["params"], f"{prefix}_step_params"))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_models")
    rng = np.random.default_rng(7)
    dots_rng = np.random.default_rng(8)  # leaves the other draws as they were
    inp, ref = {"m_archs": np.array(ARCHS),
                "m_dots_archs": np.array(DOTS_ARCHS)}, {}
    jbatches, cfgs = {}, {}
    for arch in dict.fromkeys(ARCHS + DOTS_ARCHS):
        cfg = reduced(get_arch(arch).model)
        if cfg.family == "hybrid":  # the JAX side at its oracle backends
            cfg = cfg.replace(ssm_backend="reference",
                              decode_backend="reference")
        draw = rng if arch in ARCHS else dots_rng
        params = _params(arch, cfg, draw)
        seqs = draw.integers(0, cfg.vocab_size, (4, 41), dtype=np.int32)
        batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
        inp.update(_jflat(params, f"{arch}_params"))
        inp[f"{arch}_tokens"] = batch["tokens"]
        inp[f"{arch}_labels"] = batch["labels"]
        jbatches[arch] = jax.tree_util.tree_map(jnp.asarray, batch)
        cfgs[arch] = (cfg, params)
        if arch in ARCHS:
            _reference_step(cfg, params, jbatches[arch], "none", ref, arch)
    # the reference's maybe_checkpoint names XLA's dots policy by its old
    # name, which the installed JAX may call checkpoint_dots_with_no_batch_dims
    pol = jax.checkpoint_policies
    with pytest.MonkeyPatch.context() as mpatch:
        if not hasattr(pol, "checkpoint_dots_no_batch_dims"):
            mpatch.setattr(pol, "checkpoint_dots_no_batch_dims",
                           pol.checkpoint_dots_with_no_batch_dims,
                           raising=False)
        for arch in DOTS_ARCHS:
            _reference_step(*cfgs[arch], jbatches[arch], "dots", ref,
                            f"{arch}_dots")
    # reduced gpt2's prefill, and two decode steps from a longer cache
    cfg = reduced(get_arch("gpt2-117m").model)
    params = init_params(jax.random.PRNGKey(1), cfg)
    model = build_model(cfg, dtype=jnp.float32, remat="none")
    inp.update(_jflat(params, "s_params"))
    toks = rng.integers(0, cfg.vocab_size, (4, 11), dtype=np.int32)
    inp["s_tokens"] = toks
    logits, cache = jsteps.make_prefill_step(model)(
        params, {"tokens": jnp.asarray(toks)})
    ref["s_prefill_logits"] = np.asarray(logits)
    ref["s_prefill_k"], ref["s_prefill_v"] = (np.asarray(cache["k"]),
                                              np.asarray(cache["v"]))
    _, cache = model.prefill(params, {"tokens": jnp.asarray(toks)},
                             cache_len=16)
    inp["s_cache_k"], inp["s_cache_v"] = (np.asarray(cache["k"]),
                                          np.asarray(cache["v"]))
    inp["s_cache_pos"] = np.asarray(cache["pos"])
    inp["s_next"] = rng.integers(0, cfg.vocab_size, (2, 4, 1), dtype=np.int32)
    serve = jsteps.make_serve_step(model)
    for i, nxt in enumerate(inp["s_next"]):
        logits, cache = serve(params, cache, jnp.asarray(nxt))
        ref[f"s_decode_logits{i}"] = np.asarray(logits)
    for k in ("k", "v", "pos"):
        ref[f"s_decode_{k}"] = np.asarray(cache[k])
    np.savez(tmp / "in_models.npz", **inp)
    _spawn(ranks.run_models, 4, tmp)
    return [np.load(tmp / f"out_models_r{r}.npz") for r in range(4)], ref, inp


def _check_step(models, arch, tag, want):
    """The ranks' step under ``tag`` against the reference's under
    ``want``."""
    outs, ref, inp = models
    out = outs[0]
    np.testing.assert_allclose(float(out[f"{tag}_loss"]), ref[f"{want}_loss"],
                               rtol=1e-5)
    assert bool(out[f"{tag}_grads_on_param_placements"])
    keys = [k for k in ref if k.startswith(f"{want}_grads/")]
    assert len(keys) >= 10
    for key in keys:
        got = out[key.replace(f"{want}_grads", f"{tag}_grads")]
        wanted = ref[key]
        assert np.max(np.abs(wanted)) > 0, key
        assert np.max(np.abs(got - wanted)) <= \
            GRAD_TOL[arch] * np.max(np.abs(wanted)), key
    for key in ("loss", "grad_norm", "var_max"):
        np.testing.assert_allclose(float(out[f"{tag}_step_{key}"]),
                                   ref[f"{want}_step_{key}"], rtol=1e-5,
                                   err_msg=key)
    assert ref[f"{want}_step_grad_norm"] > 1.0  # the clip engaged
    sfx = [k[len(f"{want}_step_params"):] for k in ref
           if k.startswith(f"{want}_step_params/")]
    tight = ranks.step_params_close(
        {s: out[f"{tag}_step_params{s}"] for s in sfx},
        {s: ref[f"{want}_step_params{s}"] for s in sfx},
        {s: ref[f"{want}_grads{s}"] for s in sfx},
        {s: inp[f"{arch}_params{s}"] for s in sfx},
        ref[f"{want}_step_grad_norm"], jbase.OptimizerConfig(), LR)
    total = sum(ref[f"{want}_step_params{s}"].size for s in sfx)
    assert tight >= 0.75 * total, (tight, total)
    # every rank saw the same whole metrics
    for other in outs[1:]:
        assert float(other[f"{tag}_step_loss"]) == float(
            out[f"{tag}_step_loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_model_step_matches_reference(models, arch):
    _check_step(models, arch, f"{arch}_fsdp", arch)


@pytest.mark.parametrize("arch", DOTS_ARCHS)
def test_sharded_dots_step_matches_reference(models, arch):
    _check_step(models, arch, f"{arch}_dots", f"{arch}_dots")


@pytest.mark.parametrize("rule_set", ["fsdp", "serve_tp"])
def test_sharded_prefill_and_serve_steps_match_reference(models, rule_set):
    outs, ref, _ = models
    for out in outs:
        tag = f"s_{rule_set}"
        for key in ("prefill_logits", "prefill_k", "prefill_v",
                    "decode_logits0", "decode_logits1", "decode_k",
                    "decode_v"):
            np.testing.assert_allclose(out[f"{tag}_{key}"], ref[f"s_{key}"],
                                       rtol=1e-5, atol=1e-5, err_msg=key)
        assert int(out[f"{tag}_decode_pos"]) == int(ref["s_decode_pos"]) == 13
        # the prefill cache came back sharded (slots on "data")
        assert bool(out[f"{tag}_prefill_k_sharded"])
