"""The last pieces of the reference's surface, held against the JAX package.

* gpt2-1.5b: every ``ModelConfig`` field, its shape cells, source and
  notes as the reference's; 1,559,017,600 parameters; ``--arch gpt2-1.5b
  --reduced`` trains on the CPU.
* ``make_policy``'s aliases "spf" and "budget".
* ``Scheduler.submit_all`` (all-or-nothing on validation and on the
  bounded queue, generators read once) and ``Replica.try_submit`` (sheds
  on a full queue, counted in the replica's metrics row and the router's
  summary, raises on an invalid request), each on the same script as the
  reference.
* ``Router.telemetry``, ``PageAllocator.occupancy`` and
  ``PagedDecodeState.insert`` (one slot through the paged scatter).
* ``SLWCurriculum.apply`` / ``at_full_length`` and ``BatchWarmup.apply``
  step by step, and ``ModelConfig.is_attention_free`` for every preset.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import BatchWarmupConfig as JBatchWarmupConfig
from repro.configs import SLWConfig as JSLWConfig
from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.core.batch_warmup import BatchWarmup as JBatchWarmup
from repro.core.curriculum import SLWCurriculum as JSLWCurriculum
from repro.models import build_model as jbuild_model
from repro.models import init_params as jinit_params
from repro.models import model_zoo as jzoo
from repro.serve import InferenceEngine as JInferenceEngine
from repro.serve import PageAllocator as JPageAllocator
from repro.serve import PagedDecodeState as JPagedDecodeState
from repro.serve import QueueFull as JQueueFull
from repro.serve import Replica as JReplica
from repro.serve import Request as JRequest
from repro.serve import Router as JRouter
from repro.serve import Scheduler as JScheduler
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve.policies import make_policy as jmake_policy
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.configs.base import BatchWarmupConfig, SLWConfig
from repro_torch.core.batch_warmup import BatchWarmup
from repro_torch.core.curriculum import SLWCurriculum
from repro_torch.launch import train as ttrain
from repro_torch.models import model_zoo as tzoo
from repro_torch.serve import (InferenceEngine, PageAllocator,
                               PagedDecodeState, QueueFull, Replica, Request,
                               Router, Scheduler, SchedulerConfig,
                               make_policy)

CPU = torch.device("cpu")
SCHED = dict(n_slots=2, cache_len=32, min_prompt_bucket=8, round_multiple=16,
             max_buckets=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gpt2():
    """Reduced gpt2 in both packages on the same weights: (JAX model, JAX
    params, port model, port params)."""
    jcfg = jreduced(jget_arch("gpt2-117m").model)
    params = jinit_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tconfigs.reduced(tconfigs.get_arch("gpt2-117m"))
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, CPU)
    return (jbuild_model(jcfg, dtype=jnp.float32, remat="none"), params,
            tzoo.build_model(tcfg, remat="none"), tparams)


# -- gpt2-1.5b ----------------------------------------------------------------
def test_gpt2_1p5b_config_matches_reference():
    jspec, tspec = JARCHS["gpt2-1.5b"], tconfigs.get_arch_spec("gpt2-1.5b")
    jfields = dataclasses.asdict(jspec.model)
    tfields = dataclasses.asdict(tspec.model)
    assert tfields == jfields
    assert (tspec.source, tspec.notes) == (jspec.source, jspec.notes)
    assert [dataclasses.astuple(s) for s in tspec.shapes] == \
        [dataclasses.astuple(s) for s in jspec.shapes]
    cfg = tconfigs.get_arch("gpt2-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim,
            cfg.d_ff) == (48, 1600, 25, 64, 6400)
    assert "gpt2-1.5b" in tconfigs.PAPER


def test_gpt2_1p5b_param_count():
    cfg = tconfigs.get_arch("gpt2-1.5b")
    assert tzoo.param_count(cfg) == 1_559_017_600 == \
        jzoo.param_count(jget_arch("gpt2-1.5b").model)
    assert tzoo.active_param_count(cfg) == jzoo.active_param_count(
        jget_arch("gpt2-1.5b").model)


def test_train_cli_takes_gpt2_1p5b(capsys):
    assert ttrain.main(["--arch", "gpt2-1.5b", "--reduced", "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "16",
                        "--eval-interval", "0", "--remat", "dots"]) == 0
    assert "done: steps=2" in capsys.readouterr().out


# -- admission ----------------------------------------------------------------
@pytest.mark.parametrize("name", ["spf", "budget", "shortest-prompt-first",
                                  "budget-packing", "fcfs"])
def test_make_policy_aliases_as_reference(name):
    kw = dict(SCHED, policy=name, pack_budget=40)
    got = make_policy(SchedulerConfig(**kw))
    want = jmake_policy(JSchedulerConfig(**kw))
    assert type(got).__name__ == type(want).__name__
    assert getattr(got, "budget", None) == getattr(want, "budget", None)


def test_make_policy_refuses_unknown_as_reference():
    for make, cfg in ((make_policy, SchedulerConfig),
                      (jmake_policy, JSchedulerConfig)):
        with pytest.raises(ValueError, match="unknown admission policy"):
            make(cfg(**dict(SCHED, policy="lifo")))


def _submit_all_script(sched_cls, cfg_cls, req_cls, full_cls):
    """The reference's scripts (tests/test_serve_engine.py:232-261 and
    :554-568), each outcome recorded."""
    out = []
    s = sched_cls(cfg_cls(**SCHED))
    s.submit_all(req_cls(uid=i, tokens=(1, 2, 3), max_tokens=4)
                 for i in range(5))
    out.append([r.uid for r in s.pending])
    for bad in ([req_cls(uid=5, tokens=(1, 2), max_tokens=4),
                 req_cls(uid=6, tokens=(1,) * 30, max_tokens=8)],
                (req_cls(uid=u, tokens=(1,) * 40, max_tokens=4)
                 for u in (7, 8)),
                [req_cls(uid=9, tokens=(1, 2), max_tokens=4),
                 req_cls(uid=0, tokens=(1, 2), max_tokens=4)]):
        with pytest.raises(ValueError):
            s.submit_all(bad)
        out.append(len(s.pending))
    s2 = sched_cls(cfg_cls(**dict(SCHED, max_pending=2)))
    s2.submit(req_cls(uid=0, tokens=(1, 2), max_tokens=4))
    with pytest.raises(full_cls):
        s2.submit_all([req_cls(uid=i, tokens=(1, 2), max_tokens=4)
                       for i in (1, 2)])
    out.append([r.uid for r in s2.pending])
    s2.submit_all([req_cls(uid=1, tokens=(1, 2), max_tokens=4)])
    out.append([r.uid for r in s2.pending])
    return out


def test_submit_all_is_all_or_nothing_as_reference():
    got = _submit_all_script(Scheduler, SchedulerConfig, Request, QueueFull)
    want = _submit_all_script(JScheduler, JSchedulerConfig, JRequest,
                              JQueueFull)
    assert got == want == [[0, 1, 2, 3, 4], 5, 5, 5, [0], [0, 1]]


def _try_submit_script(engine, bad_engine, req_cls):
    reqs = [req_cls(uid=i, tokens=(1, 2, 3), max_tokens=4) for i in range(3)]
    out = [engine.try_submit(r) for r in reqs] + [engine.stats.shed]
    with pytest.raises(ValueError):
        bad_engine.try_submit(req_cls(uid=9, tokens=(1,) * 40, max_tokens=8))
    # the shed reaches the operator's per-step row (nothing has run, so the
    # latency percentiles are left out)
    row = {k: v for k, v in engine.metrics_row(0.0).items()
           if k not in ("p50_s", "p95_s")}
    return out + [bad_engine.stats.shed, len(engine.scheduler.pending), row]


def test_try_submit_sheds_as_reference(gpt2):
    jmodel, params, tmodel, tparams = gpt2
    bounded = dict(SCHED, max_pending=2)
    got = _try_submit_script(
        InferenceEngine(tmodel, tparams, SchedulerConfig(**bounded),
                        device="cpu"),
        InferenceEngine(tmodel, tparams, SchedulerConfig(**bounded),
                        device="cpu"), Request)
    want = _try_submit_script(
        JInferenceEngine(jmodel, params, JSchedulerConfig(**bounded)),
        JInferenceEngine(jmodel, params, JSchedulerConfig(**bounded)),
        JRequest)
    assert got == want
    assert got[:6] == [True, True, False, 1, 0, 2] and got[6]["shed"] == 1


def test_router_telemetry_as_reference(gpt2):
    jmodel, params, tmodel, tparams = gpt2
    rows = []
    for rep_cls, router_cls, cfg_cls, req_cls, kw, m, p in (
            (Replica, Router, SchedulerConfig, Request, {"device": "cpu"},
             tmodel, tparams),
            (JReplica, JRouter, JSchedulerConfig, JRequest, {}, jmodel,
             params)):
        reps = [rep_cls(m, p, cfg_cls(**dict(SCHED, max_pending=2)),
                        name="dense", **kw),
                rep_cls(m, p, cfg_cls(**dict(SCHED, paged=True, page_size=8,
                                             max_pending=1)),
                        name="paged", **kw)]
        router = router_cls(reps)
        accepted = [router.submit(req_cls(uid=i, tokens=(1, 2, 3),
                                          max_tokens=4)) for i in range(4)]
        telemetry = [dataclasses.astuple(t) for t in router.telemetry()]
        assert router.telemetry() == [r.telemetry() for r in reps]
        # a streaming caller's shed at a full replica reaches the summary
        shed = reps[1].try_submit(req_cls(uid=9, tokens=(1, 2, 3),
                                          max_tokens=4))
        summary = router.summary()
        rows.append((accepted, router.stats.shed, telemetry, shed,
                     summary["shed"], summary["aggregate"]))
    assert rows[0] == rows[1]
    assert rows[0][0] == [True, True, True, False]
    assert rows[0][3] is False and rows[0][5]["replica_shed"] == 1


# -- paging -------------------------------------------------------------------
def test_page_allocator_occupancy_as_reference():
    seen = []
    for cls in (PageAllocator, JPageAllocator):
        a = cls(10, 4, 3, 4)
        trace = [a.occupancy()]
        for slot, n_tok in ((0, 5), (1, 16), (2, 3)):
            assert a.reserve(slot, -(-n_tok // 4))
            a.allocate(slot, n_tok)
            trace.append(a.occupancy())
        a.free_slot(1)
        trace.append(a.occupancy())
        seen.append(trace)
    assert seen[0] == seen[1] == [0.0, 0.2, 0.6, 0.7, 0.3]


def test_paged_insert_matches_reference(gpt2):
    """One slot through ``insert``: the same page table, pools and
    bookkeeping as the reference's, and the same as ``insert_many`` of
    one row."""
    jmodel, _, tmodel, tparams = gpt2
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 512,
                                                              (1, 13)))
    row = tmodel.prefill(tparams, {"tokens": toks}, cache_len=32)[1]
    state = PagedDecodeState(tmodel, page_size=8, n_pages=10)
    cache = state.init_slots(3, 32, torch.float32, CPU)
    twin = PagedDecodeState(tmodel, page_size=8, n_pages=10)
    tcache = twin.init_slots(3, 32, torch.float32, CPU)
    jstate = JPagedDecodeState(jmodel, 8, 10)
    jcache = jstate.init_slots(3, 32)
    for st in (state, twin, jstate):
        assert st.alloc.reserve(0, 2)
        st.alloc.allocate(0, 9)  # slot 1 starts past the first pages
        assert st.alloc.reserve(1, 4)
    cache = state.insert(cache, 1, row)
    tcache = twin.insert_many(tcache, torch.tensor([1]), row)
    jcache = jstate.insert(jcache, 1, {k: jnp.asarray(v.numpy())
                                       for k, v in row.items()})
    np.testing.assert_array_equal(state.alloc.table, jstate.alloc.table)
    np.testing.assert_array_equal(state.alloc.table, twin.alloc.table)
    for name in ("k", "v", "pos", "active"):
        np.testing.assert_array_equal(cache[name].numpy(),
                                      np.asarray(jcache[name]))
        assert torch.equal(cache[name], tcache[name])


# -- host-side regulators -----------------------------------------------------
@pytest.mark.parametrize("mode", ["truncate", "repack"])
def test_curriculum_apply_and_full_length_as_reference(mode):
    kw = dict(start_seq_len=8, duration_steps=5, mode=mode)
    batch = {"tokens": np.arange(4 * 64).reshape(4, 64),
             "labels": np.arange(4 * 64).reshape(4, 64) + 1}
    port = SLWCurriculum(SLWConfig(**kw), 64)
    ref = JSLWCurriculum(JSLWConfig(**kw), 64)
    for _ in range(8):
        (got, n), (want, m) = port.apply(batch), ref.apply(batch)
        assert n == m and got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        assert port.at_full_length == ref.at_full_length
        port.step_complete(n)
        ref.step_complete(m)
    assert port.at_full_length
    (got, n), (want, m) = port.apply(batch, 16), ref.apply(batch, 16)
    assert n == m and got["tokens"].shape == want["tokens"].shape


def test_batch_warmup_apply_as_reference():
    batch = {"tokens": np.arange(16 * 32).reshape(16, 32),
             "lengths": np.arange(16)}
    kw = dict(enabled=True, start_batch=4, warmup_tokens=4000)
    port = BatchWarmup(BatchWarmupConfig(**kw), 16, dp_size=2)
    ref = JBatchWarmup(JBatchWarmupConfig(**kw), 16, dp_size=2)
    sizes = []
    for seen in (0, 500, 1999, 3000, 4000, 10_000):
        (got, n), (want, m) = port.apply(batch, seen), ref.apply(batch, seen)
        assert n == m
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
        sizes.append(len(got["tokens"]))
    assert sizes == [4, 4, 8, 12, 16, 16]
    # a 1-d first leaf counts rows, as the reference does
    (_, n), (_, m) = (port.apply({"lengths": batch["lengths"]}, 0),
                      ref.apply({"lengths": batch["lengths"]}, 0))
    assert n == m == 4


@pytest.mark.parametrize("arch", sorted(tconfigs.SPECS))
def test_is_attention_free_as_reference(arch):
    assert tconfigs.get_arch(arch).is_attention_free == \
        jget_arch(arch).model.is_attention_free
