"""The port's RWKV-6 serving and training paths against the JAX package.

Reduced rwkv6 (2 layers, d 64, 4 heads of 16), fp32, on the CPU, with the
JAX package's parameters (zero-initialised leaves redrawn, so decays are
data-dependent) carried over by ``bridge``:

* the continuous-batching engine's greedy streams equal the JAX engine's,
  token for token, over ragged prompts that exercise two prefill buckets
  and the replay of sub-bucket remainders;
* through the router (a dense and a paged replica, where paging is a
  structural no-op: RWKV-6 has no "seq" leaf) the streams are the same,
  every page comes back, and a request migrated mid-flight in either
  direction finishes as it would have in place;
* an 8-step trainer run with SLW and batch warmup from one transferred
  state: plans and distinct batch shapes (the reference's ``n_compiles``)
  equal, losses and ``var_max`` within
  1e-4 relative (fp32 Adam steps amplify last-digit gradient differences
  a little per step);
* the serving and training CLIs run ``--arch rwkv6-7b`` on the CPU.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy, train_state_from_numpy
from repro_torch.configs import base as tbase
from repro_torch.launch.train import Trainer
from repro_torch.models import model_zoo as tzoo
from repro_torch.serve import (InferenceEngine, Replica, Request, Router,
                               SchedulerConfig, cache_nbytes, prefill_split)

CPU = torch.device("cpu")
SHAPES = [(7, 5), (20, 9), (33, 3), (12, 7), (40, 4), (9, 8), (25, 6),
          (16, 2)]  # (prompt_len, max_tokens), tests/test_serve_engine.py:65
BASE = dict(n_slots=3, cache_len=64, min_prompt_bucket=8, round_multiple=16,
            max_buckets=4)
REDRAWN = ("mix", "w_base", "w_lora_b")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side (skips where JAX is absent)."""
    jnp = pytest.importorskip("jax.numpy")
    import jax
    from repro.configs import base as jbase
    from repro.configs import get_arch, reduced
    from repro.launch.train import Trainer as JaxTrainer
    from repro.models import build_model, init_params
    from repro.serve import InferenceEngine as JaxEngine
    from repro.serve import Request as JaxRequest
    from repro.serve import SchedulerConfig as JaxSchedulerConfig
    return types.SimpleNamespace(**locals())


def _redraw(jx, params, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if any(n in jx.jax.tree_util.keystr(path) for n in REDRAWN):
            return jx.jnp.asarray(
                (rng.standard_normal(x.shape) * 0.5).astype(np.float32))
        return x
    return jx.jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def weights(jx):
    cfg = jx.reduced(jx.get_arch("rwkv6-7b").model)
    params = _redraw(jx, jx.init_params(jx.jax.random.PRNGKey(0), cfg))
    tcfg = tconfigs.reduced(tconfigs.get_arch("rwkv6-7b"))
    tparams = params_from_numpy(jx.jax.tree_util.tree_map(np.asarray, params),
                                tcfg, CPU)
    return cfg, params, tzoo.build_model(tcfg), tparams


def _requests(cls, n=8, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, tokens=tuple(int(t) for t in
                                    rng.integers(0, 512, size=plen)),
                max_tokens=mt)
            for i, (plen, mt) in enumerate(SHAPES[:n])]


@pytest.fixture(scope="module")
def oracle(jx, weights):
    """The port's single dense engine's greedy streams, checked against the
    JAX engine's on the same weights."""
    cfg, params, tmodel, tparams = weights
    jeng = jx.JaxEngine(jx.build_model(cfg, dtype=jx.jnp.float32,
                                       remat="none"), params,
                        jx.JaxSchedulerConfig(**BASE))
    jres = jeng.run(_requests(jx.JaxRequest))
    teng = InferenceEngine(tmodel, tparams, SchedulerConfig(**BASE),
                           device="cpu")
    tres = teng.run(_requests(Request))
    splits = {prefill_split(len(r.tokens), teng.scheduler.ladder)
              for r in _requests(Request)}
    assert len(splits) >= 2  # two buckets
    assert any(len(r.tokens) > prefill_split(len(r.tokens),
                                             teng.scheduler.ladder)
               for r in _requests(Request))  # and replayed remainders
    for t, j in zip(tres, jres):
        assert t.tokens == j.tokens, f"uid {t.uid}"
        assert t.finish_reason == j.finish_reason
    assert sorted(teng.scheduler.free) == [0, 1, 2]
    return {r.uid: r for r in tres}


def test_engine_greedy_streams_match_jax(oracle):
    assert len(oracle) == len(SHAPES)
    assert all(len(r.tokens) == mt for r, (_, mt) in
               zip(oracle.values(), SHAPES))


def _replica(weights, name="", **kw):
    _, _, tmodel, tparams = weights
    return Replica(tmodel, tparams, SchedulerConfig(**dict(BASE, **kw)),
                   device="cpu", name=name)


def test_router_with_a_paged_replica_matches(weights, oracle):
    """A dense and a paged replica behind the router: the paged state holds
    no pool (no leaf has a "seq" axis) and the same state bytes as the
    dense one, and every stream is the single engine's."""
    dense = _replica(weights, "dense")
    paged = _replica(weights, "paged", paged=True, page_size=16, n_pages=7)
    assert sorted(paged.cache) == sorted(list(dense.cache) + ["page_table"])
    assert cache_nbytes({k: v for k, v in paged.cache.items()
                         if k != "page_table"}) == cache_nbytes(dense.cache)
    router = Router([dense, paged], route="round-robin")
    for r in router.run(_requests(Request)):
        assert r.tokens == oracle[r.uid].tokens, f"uid {r.uid}"
    assert router.stats.routed == {"dense": 4, "paged": 4}
    paged.state.alloc.check()
    assert paged.state.alloc.pages_in_use == 0


@pytest.mark.parametrize("paged_src,paged_dst", [(False, True),
                                                 (True, False)])
def test_slot_migration_mid_flight(weights, oracle, paged_src, paged_dst):
    src = _replica(weights, paged=paged_src, page_size=16)
    dst = _replica(weights, paged=paged_dst, page_size=16,
                   cache_len=48 if paged_dst else 80)  # other geometry
    req = _requests(Request, n=2)[1]  # 20-token prompt, 9 generations
    src.scheduler.submit(req)
    src.pump()  # admit and one fused step
    src.pump()  # one more step mid-flight
    [slot] = list(src.scheduler.active)
    src.migrate_slot_to(slot, dst)
    assert not src.scheduler.busy
    while dst.scheduler.busy:
        dst.pump()
    [res] = dst.take_finished()
    assert res.tokens == oracle[req.uid].tokens
    for rep in (src, dst):
        if rep.cfg.paged:
            rep.state.alloc.check()
            assert rep.state.alloc.pages_in_use == 0


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
        seq_len=seq, global_batch=batch, remat="none", eval_interval=4)


def test_trainer_matches_reference(jx):
    jtc = _trainer_config(jx.jbase, jx.reduced(jx.get_arch("rwkv6-7b").model))
    ttc = _trainer_config(tbase, tconfigs.reduced(
        tconfigs.get_arch("rwkv6-7b")))
    jtr = jx.JaxTrainer(jtc, eval_batch=4)
    jtr.state = dict(jtr.state, params=_redraw(jx, jtr.state["params"], 1))
    ttr = Trainer(ttc, eval_batch=4, device="cpu")
    ttr.state = train_state_from_numpy(
        jx.jax.tree_util.tree_map(np.asarray, jtr.state), ttc.model,
        ttc.optimizer, CPU)
    ref, got = jtr.run(), ttr.run()
    assert got.steps == ref.steps == 8
    plans = lambda r: list(zip(r.seqlen_history, r.batch_history,
                               r.lr_history))
    assert plans(got) == plans(ref)
    assert len(set(ref.seqlen_history)) >= 3 and min(ref.batch_history) < 4
    # the reference's jit compiles: one a distinct (batch, seq_len) shape
    assert len(set(zip(got.batch_history, got.seqlen_history))) \
        == ref.n_compiles
    for key in ("loss_history", "var_max_history"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   rtol=1e-4, err_msg=key)
    np.testing.assert_allclose([p for _, p in got.val_ppl_history],
                               [p for _, p in ref.val_ppl_history], rtol=1e-4)


@pytest.mark.parametrize("flags", [[], ["--paged", "--page-size", "16"],
                                   ["--replicas", "2"], ["--legacy"]])
def test_serve_cli_runs_rwkv_on_cpu(flags, capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                 "--batch", "2", "--requests", "4", "--prompt-len", "24",
                 "--gen", "4", *flags]) == 0
    assert "sample:" in capsys.readouterr().out


def test_train_cli_runs_rwkv_on_cpu(capsys):
    from repro_torch.launch.train import main
    assert main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                 "--steps", "3", "--batch", "2", "--seq", "32", "--slw",
                 "--duration", "2", "--eval-interval", "3"]) == 0
    assert "done: steps=3" in capsys.readouterr().out
