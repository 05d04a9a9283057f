"""The eight presets the port registered last, against the JAX package.

deepseek-moe-16b, moonshot-v1-16b-a3b, qwen2-1.5b, qwen3-32b, smollm-360m,
phi3-mini-3.8b, musicgen-large and llava-next-mistral-7b, one parametrised
test per property:

* every ``ModelConfig`` field equals the reference's;
* ``param_count`` and ``active_param_count``, full and reduced;
* on the reduced configs (fp32, the JAX parameters through the bridge, a
  numpy-seeded batch in each preset's layout): the loss and every
  gradient, the prefill logits and greedy decode.  This holds rope,
  RMSNorm, SwiGLU, GQA, ``qk_norm``, ``qkv_bias``, learned positions with
  LayerNorm and GELU, and the two frontends (frames replacing the token
  embedding, a patch prefix prepended to it and left out of the loss);
* ``DataPipeline``'s frontend batches, bit for bit;
* ``apply_seqlen`` on those batches in both SLW modes, and the planned
  trajectory with the patch prefix left out of the pacing.

Tolerance: 1e-4 absolute on values, 1e-4 of each leaf's largest entry on
gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.configs.base import (OptimizerConfig as JOptimizerConfig,
                                SLWConfig as JSLWConfig,
                                TrainConfig as JTrainConfig)
from repro.core.curriculum import apply_seqlen as japply_seqlen
from repro.core.regulators import predict_trajectory as jpredict
from repro.data import DataPipeline as JDataPipeline
from repro.data import SyntheticCorpus as JSyntheticCorpus
from repro.models import build_model as jbuild_model
from repro.models import init_params as jinit_params
from repro.models import model_zoo as jzoo
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.configs import OptimizerConfig, SLWConfig, TrainConfig
from repro_torch.core.curriculum import apply_seqlen
from repro_torch.core.regulators import predict_trajectory
from repro_torch.data import DataPipeline, SyntheticCorpus
from repro_torch.models import model_zoo as tzoo

CPU = torch.device("cpu")
TOL = 1e-4
PRESETS = ("deepseek-moe-16b", "moonshot-v1-16b-a3b", "qwen2-1.5b",
           "qwen3-32b", "smollm-360m", "phi3-mini-3.8b", "musicgen-large",
           "llava-next-mistral-7b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one intra-op thread keeps them cheap where
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(preset, small=True):
    jcfg, tcfg = jget_arch(preset).model, tconfigs.get_arch(preset)
    return (jreduced(jcfg), tconfigs.reduced(tcfg)) if small else (jcfg, tcfg)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, np.asarray(tree))]


def _torch_batch(batch):
    return {k: torch.from_numpy(v).float() if v.dtype == np.float32
            else torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("preset", PRESETS)
def test_config_fields_equal_the_reference(preset, small):
    jcfg, tcfg = _cfgs(preset, small)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("preset", PRESETS)
def test_param_counts_equal_the_reference(preset, small):
    jcfg, tcfg = _cfgs(preset, small)
    assert tzoo.param_count(tcfg) == jzoo.param_count(jcfg)
    assert tzoo.active_param_count(tcfg) == jzoo.active_param_count(jcfg)
    if jcfg.family == "moe":
        assert tzoo.active_param_count(tcfg) < tzoo.param_count(tcfg)


@pytest.fixture(scope="module", params=PRESETS)
def weights(request):
    jcfg, tcfg = _cfgs(request.param)
    params = jax.jit(jinit_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, CPU)
    return jcfg, params, tcfg, tparams


def test_loss_and_grads_match_the_reference(weights):
    jcfg, params, tcfg, tparams = weights
    batch = tzoo.make_train_batch(7, tcfg, 2, 24)
    jmodel = jbuild_model(jcfg, dtype=jnp.float32, remat="none")
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [p.detach().clone().requires_grad_(True)
              for p in jax.tree_util.tree_leaves(tparams)]
    treedef = jax.tree_util.tree_structure(tparams)
    loss, m = tzoo.build_model(tcfg, remat="full").loss(
        jax.tree_util.tree_unflatten(treedef, leaves), _torch_batch(batch))
    _close(loss, jloss)
    _close(m["tokens"], jm["tokens"])
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    got = _leaves(bridge.params_to_numpy(
        jax.tree_util.tree_unflatten(treedef, grads), tcfg))
    ref = _leaves(jax.tree_util.tree_map(np.asarray, jg))
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (name, g), (_, r) in zip(got, ref):
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(g - r).max()) <= TOL * scale, name


def test_prefill_and_greedy_decode_match_the_reference(weights):
    jcfg, params, tcfg, tparams = weights
    jmodel = jbuild_model(jcfg, dtype=jnp.float32, remat="none")
    tmodel = tzoo.build_model(tcfg)
    batch = tzoo.make_train_batch(8, tcfg, 2, 16)
    batch.pop("labels")
    lg, c = jmodel.prefill(params, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, cache_len=24)
    tlg, tc = tmodel.prefill(tparams, _torch_batch(batch), cache_len=24)
    _close(tlg, lg)
    _close(tc["k"], c["k"])
    assert int(tc["pos"]) == int(c["pos"]) == 16
    toks, ttoks = [], []
    for _ in range(4):
        nxt = jnp.argmax(lg[:, :jcfg.vocab_size], -1)[:, None]
        tnxt = torch.argmax(tlg[:, :tcfg.vocab_size], -1)[:, None]
        toks.append(np.asarray(nxt))
        ttoks.append(_np(tnxt))
        lg, c = jmodel.decode(params, c, nxt.astype(jnp.int32))
        tlg, tc = tmodel.decode(tparams, tc, tnxt)
        _close(tlg, lg)
    np.testing.assert_array_equal(np.concatenate(ttoks, 1),
                                  np.concatenate(toks, 1))


def _pipelines(preset, seq=32, batch=3):
    jcfg, tcfg = _cfgs(preset)
    return (JDataPipeline(JSyntheticCorpus(jcfg.vocab_size, seq, seed=5),
                          batch, model_cfg=jcfg),
            DataPipeline(SyntheticCorpus(tcfg.vocab_size, seq, seed=5),
                         batch, model_cfg=tcfg))


@pytest.mark.parametrize("preset", PRESETS)
def test_pipeline_frontend_batches_are_bit_equal(preset):
    jpipe, tpipe = _pipelines(preset)
    for step in (0, 3):
        ref, got = jpipe.batch_at(step), tpipe.batch_at(step)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("mode", ["truncate", "repack"])
@pytest.mark.parametrize("preset", PRESETS)
def test_apply_seqlen_matches_the_reference(preset, mode):
    jpipe, tpipe = _pipelines(preset)
    for s_t in (8, 16, 32):
        ref, ref_tokens = japply_seqlen(jpipe.batch_at(1), s_t, mode)
        got, tokens = apply_seqlen(tpipe.batch_at(1), s_t, mode)
        assert tokens == ref_tokens
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("preset", PRESETS)
def test_trajectory_paces_the_text_only(preset):
    jcfg, tcfg = _cfgs(preset)
    kw = dict(seq_len=64, global_batch=4)
    jtc = JTrainConfig(model=jcfg, optimizer=JOptimizerConfig(
        warmup_steps=4, total_steps=20), slw=JSLWConfig(
            start_seq_len=8, duration_steps=10), **kw)
    ttc = TrainConfig(model=tcfg, optimizer=OptimizerConfig(
        warmup_steps=4, total_steps=20), slw=SLWConfig(
            start_seq_len=8, duration_steps=10), **kw)
    ref = jpredict(jtc, 14, prefix_tokens=jcfg.prefix_tokens)
    got = predict_trajectory(ttc, 14, prefix_tokens=tcfg.prefix_tokens)
    assert [dataclasses.astuple(p) for p in got] == \
        [dataclasses.astuple(p) for p in ref]
    assert max(p.seq_len for p in got) == 64 - tcfg.prefix_tokens
