"""The port's admission policies, router, role split and slot migration
against the JAX package.

* policies: each of fcfs, shortest-prompt-first and budget-packing makes
  the same selections as the JAX policy of the same name on the same
  request sequences (with and without a page-budget gate); none starves a
  request under sustained load; a blocked head leaves the queue untouched;
* router parity: greedy streams through the Router (two replicas, either
  route; paged and dense replicas under mixed policies; a prefill/decode
  role split) equal the single dense engine's, which equal the JAX
  engine's on the same weights (``bridge.py``), token for token;
* rejection of a prefill-role target and of duplicate uids; spill and
  shed at bounded queues;
* a request migrated mid-flight between dense and paged replicas, all
  four ways, finishes with the tokens it would have produced in place;
* the ``--metrics-jsonl`` rows round-trip through the port's
  ``read_metrics_jsonl``;
* one sampled stream is the same single and routed (sampled streams
  cannot match ``jax.random``'s, so this holds within the port).

Tests marked ``gpu`` drive the router on the card and skip where there is
none:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_router.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.telemetry import read_metrics_jsonl
from repro_torch.launch.serve import serve_engine, serve_router
from repro_torch.models import model_zoo as tzoo
from repro_torch.serve import (POLICIES, BudgetPackingPolicy, FCFSPolicy,
                               InferenceEngine, Replica, Request, Router,
                               SamplingParams, Scheduler, SchedulerConfig,
                               ShortestPromptFirstPolicy, make_policy,
                               make_replicas)

CPU = torch.device("cpu")
SHAPES = [(7, 5), (20, 9), (33, 3), (12, 7), (40, 4), (9, 8), (25, 6),
          (16, 2)]  # (prompt_len, max_tokens), tests/test_router.py:48
BASE = dict(n_slots=2, cache_len=64, min_prompt_bucket=8, round_multiple=16,
            max_buckets=4)
ORACLE = dict(BASE, n_slots=3)  # the single engine (tests/test_router.py:57)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side (skips where JAX is absent, so the card tests
    also run there)."""
    jnp = pytest.importorskip("jax.numpy")
    import jax
    from repro.configs import get_arch, reduced
    from repro.models import build_model, init_params
    from repro.serve import (InferenceEngine, Request, Scheduler,
                             SchedulerConfig)
    from repro.serve.policies import make_policy
    return types.SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def weights(jx):
    cfg = jx.reduced(jx.get_arch("gpt2-117m").model)
    params = jx.init_params(jx.jax.random.PRNGKey(0), cfg)
    tcfg = tconfigs.reduced(tconfigs.get_arch("gpt2-117m"))
    tparams = params_from_numpy(jx.jax.tree_util.tree_map(np.asarray, params),
                                tcfg, CPU)
    return tzoo.build_model(tcfg), tparams


@pytest.fixture(scope="module")
def oracle(jx, weights):
    """The single dense engine's greedy streams, checked against the JAX
    engine's on the same weights."""
    tmodel, tparams = weights
    cfg = jx.reduced(jx.get_arch("gpt2-117m").model)
    jres = jx.InferenceEngine(jx.build_model(cfg, dtype=jx.jnp.float32, remat="none"),
                     jx.init_params(jx.jax.random.PRNGKey(0), cfg),
                     jx.SchedulerConfig(**ORACLE)).run(_requests(jx.Request))
    tres = InferenceEngine(tmodel, tparams, SchedulerConfig(**ORACLE),
                           device="cpu").run(_requests(Request))
    for t, j in zip(tres, jres):
        assert t.tokens == j.tokens and t.finish_reason == j.finish_reason
    return {r.uid: r for r in tres}


def _requests(cls, n=8, seed=3, sampling=None):
    rng = np.random.default_rng(seed)
    kw = {} if sampling is None else {"sampling": sampling}
    return [cls(uid=i, tokens=tuple(int(t) for t in
                                    rng.integers(0, 512, size=plen)),
                max_tokens=mt, **kw)
            for i, (plen, mt) in enumerate(SHAPES[:n])]


def _assert_parity(results, oracle):
    for r in results:
        assert r.tokens == oracle[r.uid].tokens, f"uid {r.uid}"
        assert r.finish_reason == oracle[r.uid].finish_reason


def _replica(weights, name="", **kw):
    tmodel, tparams = weights
    return Replica(tmodel, tparams, SchedulerConfig(**dict(BASE, **kw)),
                   device="cpu", name=name)


# -- admission policies ----------------------------------------------------------
def _req(cls, uid, plen, mt=4):
    return cls(uid=uid, tokens=(1,) * plen, max_tokens=mt)


def _drive(sched_cls, cfg_cls, req_cls, make, policy, gate, seed):
    """Selections of one policy over a sustained random arrival stream:
    each round admits what the policy picks (through a page-budget gate
    that refuses every third ask when ``gate``), then retires it."""
    cfg = cfg_cls(**dict(BASE, n_slots=3, prefill_batch=2, policy=policy,
                         pack_budget=64))
    sched, pol = sched_cls(cfg), make(cfg)
    rng = np.random.default_rng(seed)
    asks = [0]

    def reserve(slot, request):
        asks[0] += 1
        return asks[0] % 3 != 0

    trace, uid = [], 0
    for _ in range(60):
        for _ in range(int(rng.integers(0, 3))):
            sched.submit(_req(req_cls, uid, int(rng.integers(3, 40)),
                              int(rng.integers(1, 9))))
            uid += 1
        picked = pol.select(sched, cfg.prefill_batch,
                            reserve=reserve if gate else None)
        trace.append(([(s, r.uid) for s, r in picked],
                      [r.uid for r in sched.pending], list(sched.free)))
        for slot, _ in picked:
            sched.free.append(slot)
    return trace


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_policies_select_as_jax(jx, policy, gate):
    port = _drive(Scheduler, SchedulerConfig, Request, make_policy, policy,
                  gate, seed=7)
    ref = _drive(jx.Scheduler, jx.SchedulerConfig, jx.Request,
                 jx.make_policy, policy, gate, seed=7)
    assert port == ref
    assert sum(len(p) for p, _, _ in port) > 20


def test_fcfs_policy_is_next_admission():
    reqs = [_req(Request, 0, 20), _req(Request, 1, 7), _req(Request, 2, 23),
            _req(Request, 3, 9)]
    a, b = (Scheduler(SchedulerConfig(**dict(BASE, prefill_batch=2)))
            for _ in range(2))
    for r in reqs:
        a.submit(r)
        b.submit(r)
    assert FCFSPolicy().select(a, 2) == b.next_admission(2)
    assert list(a.pending) == list(b.pending) and a.free == b.free


def test_shortest_prompt_first_ages_long_prompts():
    pol = ShortestPromptFirstPolicy(age_limit=3)
    sch = Scheduler(SchedulerConfig(**BASE))
    sch.submit(_req(Request, 999, 40))
    uid, rounds, admitted = 0, 0, set()
    while 999 not in admitted:
        rounds += 1
        assert rounds < 20, "long prompt starved"
        for _ in range(2):
            sch.submit(_req(Request, uid, 6))
            uid += 1
        for slot, r in pol.select(sch, 1):
            admitted.add(r.uid)
            sch.free.append(slot)
    assert rounds <= pol.age_limit + 2


def test_budget_packing_caps_round_footprint():
    reqs = [_req(Request, i, 17 + i, 8) for i in range(4)]  # one split
    for budget, want in ((55, [0, 1]), (1000, [0, 1, 2, 3])):
        sch = Scheduler(SchedulerConfig(**dict(BASE, prefill_batch=4,
                                               n_slots=4)))
        for r in reqs:
            sch.submit(r)
        picked = BudgetPackingPolicy(budget=budget).select(sch, 4)
        assert [r.uid for _, r in picked] == want


@pytest.mark.parametrize("policy", POLICIES)
def test_no_starvation_under_sustained_load(policy):
    cfg = SchedulerConfig(**dict(BASE, prefill_batch=2, policy=policy,
                                 pack_budget=64))
    sch, pol = Scheduler(cfg), make_policy(cfg)
    rng = np.random.default_rng(0)
    watched = [_req(Request, 1000 + i, p) for i, p in enumerate([40, 6, 23,
                                                                 11])]
    for r in watched:
        sch.submit(r)
    admitted, uid, rounds = set(), 0, 0
    while not all(r.uid in admitted for r in watched):
        rounds += 1
        assert rounds < 300, f"{policy} starved a request"
        if rng.random() < 0.8:
            sch.submit(_req(Request, uid, int(rng.integers(5, 30))))
            uid += 1
        for slot, r in pol.select(sch, cfg.prefill_batch):
            admitted.add(r.uid)
            sch.free.append(slot)


@pytest.mark.parametrize("policy", POLICIES)
def test_blocked_head_leaves_queue_untouched(policy):
    cfg = SchedulerConfig(**dict(BASE, policy=policy, pack_budget=64))
    sch = Scheduler(cfg)
    for r in [_req(Request, 0, 20), _req(Request, 1, 7)]:
        sch.submit(r)
    before = ([r.uid for r in sch.pending], list(sch.free))
    assert make_policy(cfg).select(sch, 2, reserve=lambda s, r: False) == []
    assert ([r.uid for r in sch.pending], list(sch.free)) == before


# -- router ----------------------------------------------------------------------
@pytest.mark.parametrize("route", ["least-loaded", "round-robin"])
def test_router_parity_two_replicas(weights, oracle, route):
    tmodel, tparams = weights
    router = Router(make_replicas(tmodel, tparams, SchedulerConfig(**BASE),
                                  2, device="cpu"), route=route)
    _assert_parity(router.run(_requests(Request)), oracle)
    assert router.stats.total_routed == len(SHAPES)
    assert len(router.stats.routed) == 2
    assert router.stats.shed == 0 and not router.busy
    for rep in router.replicas:
        assert sorted(rep.scheduler.free) == [0, 1]


def test_router_mixed_policies_paged_and_dense_parity(weights, oracle):
    reps = [_replica(weights, "dense-fcfs"),
            _replica(weights, "paged-budget", paged=True, page_size=16,
                     policy="budget-packing", prefill_batch=2),
            _replica(weights, "dense-spf", policy="shortest-prompt-first",
                     prefill_batch=2),
            _replica(weights, "paged-spf", paged=True, page_size=16,
                     n_pages=5, policy="shortest-prompt-first")]
    router = Router(reps, route="round-robin")
    _assert_parity(router.run(_requests(Request)), oracle)
    assert router.stats.routed == {r.name: 2 for r in reps}
    for rep in (reps[1], reps[3]):
        rep.state.alloc.check()
        assert rep.state.alloc.pages_in_use == 0


@pytest.mark.parametrize("paged", [False, True])
def test_router_disaggregated_parity(weights, oracle, paged):
    tmodel, tparams = weights
    cfg = SchedulerConfig(**dict(BASE, paged=paged, page_size=16))
    reps = make_replicas(tmodel, tparams, cfg, 2, device="cpu",
                         disaggregate=True)
    for rep in reps:
        assert rep.role == "decode" and rep.prefill_replica is not None
        assert rep.prefill_core is rep.prefill_replica.core
        assert rep.prefill_core is not rep.core
        assert rep.prefill_core.cache is None  # the prefill side owns no slots
    router = Router(reps)
    _assert_parity(router.run(_requests(Request)), oracle)
    assert sum(r.prefill_replica.stats.prefill_tokens for r in reps) \
        == sum(plen for plen, _ in SHAPES)


def test_router_rejects_prefill_role_and_duplicate_uids(weights):
    tmodel, tparams = weights
    pre = Replica(tmodel, tparams, SchedulerConfig(**BASE), device="cpu",
                  role="prefill")
    with pytest.raises(ValueError, match="prefill"):
        Router([pre])
    with pytest.raises(ValueError):
        Replica(tmodel, tparams, SchedulerConfig(**BASE), device="cpu",
                role="decode")  # no prefill_source
    r = _requests(Request, n=1)[0]
    with pytest.raises(ValueError, match="duplicated"):
        Router([_replica(weights)]).run([r, r])


def test_router_spill_and_shed(weights):
    tmodel, tparams = weights
    reps = make_replicas(tmodel, tparams,
                         SchedulerConfig(**dict(BASE, max_pending=1)), 2,
                         device="cpu")
    router = Router(reps, route="round-robin")
    reqs = _requests(Request, n=4)
    reps[0].scheduler.submit(reqs[0])  # replica0's queue is now full
    assert router.submit(reqs[1])  # rr=0: bounces off replica0 -> spill
    assert router.stats.spilled == 1
    assert router.stats.routed == {"replica1": 1}
    assert router.submit(reqs[2]) is False  # rr=1: both queues full
    assert router.stats.shed == 1 and router.stats.total_routed == 1
    while router.busy:
        router.pump()
    assert {r.uid for r in router.take_finished()} == {0, 1}


# -- migration -------------------------------------------------------------------
@pytest.mark.parametrize("paged_src,paged_dst", [(False, False),
                                                 (False, True),
                                                 (True, False),
                                                 (True, True)])
def test_slot_migration_mid_flight(weights, oracle, paged_src, paged_dst):
    src = _replica(weights, paged=paged_src, page_size=16)
    dst = _replica(weights, paged=paged_dst, page_size=16,
                   cache_len=48 if paged_dst else 80)  # other geometry
    req = _requests(Request, n=2)[1]  # 20-token prompt, 9 generations
    src.scheduler.submit(req)
    src.pump()  # admit + first fused step
    src.pump()  # one more step mid-flight
    [slot] = list(src.scheduler.active)
    dst_slot = src.migrate_slot_to(slot, dst)
    assert not src.scheduler.busy and dst_slot in dst.scheduler.active
    if paged_src:
        assert src.state.alloc.pages_in_use == 0  # pages returned
    while dst.scheduler.busy:
        dst.pump()
    [res] = dst.take_finished()
    assert res.uid == req.uid
    _assert_parity([res], oracle)
    if paged_dst:
        dst.state.alloc.check()
        assert dst.state.alloc.pages_in_use == 0


def test_migration_to_a_full_paged_pool_raises(weights):
    src = _replica(weights)
    dst = _replica(weights, paged=True, page_size=16, n_pages=4)
    big = Request(uid=50, tokens=(3,) * 40, max_tokens=20)  # 4 pages
    dst.scheduler.submit(big)
    dst.pump()
    src.scheduler.submit(_requests(Request, n=2)[1])
    src.pump()
    [slot] = list(src.scheduler.active)
    with pytest.raises(RuntimeError, match="reserve"):
        src.migrate_slot_to(slot, dst)
    assert slot in src.scheduler.active  # nothing moved


# -- metrics and sampling --------------------------------------------------------
def test_metrics_jsonl_roundtrip(tmp_path):
    path = tmp_path / "serve_metrics.jsonl"
    out = serve_router("gpt2-117m", True, n_slots=2, prompt_len=24,
                       gen_tokens=6, n_requests=5, replicas=2,
                       policy="budget-packing", paged=True, page_size=8,
                       metrics_jsonl=str(path), quiet=True, device="cpu")
    labels, rows = read_metrics_jsonl(str(path))
    assert labels == ()
    step_rows = [r for r in rows if "decode_step" in r]
    assert len(step_rows) == sum(rep.stats.decode_steps
                                 for rep in out["router"].replicas) > 0
    for r in step_rows:
        assert {"replica", "step_s", "active", "queue_depth", "free_slots",
                "free_pages", "p95_s"} <= set(r)
        assert r["free_pages"] >= 0  # paged replicas report their pool
    [summary] = [r for r in rows if r.get("summary")]
    assert summary["aggregate"]["generated_tokens"] \
        == sum(len(res.tokens) for res in out["results"])


def test_engine_metrics_rows_are_dense_replicas_too(tmp_path):
    path = tmp_path / "engine.jsonl"
    out = serve_engine("gpt2-117m", True, n_slots=2, prompt_len=24,
                       gen_tokens=4, n_requests=3, metrics_jsonl=str(path),
                       quiet=True, device="cpu")
    _, rows = read_metrics_jsonl(str(path))
    steps = [r for r in rows if "decode_step" in r]
    assert len(steps) == out["stats"].decode_steps
    assert all(r["free_pages"] == -1 for r in steps)


def test_sampled_stream_same_single_and_routed(weights):
    tmodel, tparams = weights
    sp = SamplingParams(temperature=0.9, top_k=20, top_p=0.95, seed=7)
    reqs = _requests(Request, sampling=sp)
    single = InferenceEngine(tmodel, tparams, SchedulerConfig(**ORACLE),
                             device="cpu").run(reqs)
    reps = [_replica(weights, "a", paged=True, page_size=16,
                     policy="shortest-prompt-first"),
            _replica(weights, "b", policy="budget-packing", prefill_batch=2)]
    routed = Router(reps, route="round-robin").run(reqs)
    disagg = Router(make_replicas(tmodel, tparams, SchedulerConfig(**BASE),
                                  1, device="cpu", disaggregate=True)
                    ).run(reqs)
    for a, b, c in zip(single, routed, disagg):
        assert a.tokens == b.tokens == c.tokens, f"uid {a.uid}"
    assert len({tuple(r.tokens) for r in single}) == len(reqs)


def test_serve_router_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_router("gpt2-117m", True, n_slots=2, prompt_len=24,
                     gen_tokens=4, quiet=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_engine("gpt2-117m", True, n_slots=2, prompt_len=24,
                     gen_tokens=4, paged=True, quiet=True)


# -- on the card -----------------------------------------------------------------
@pytest.fixture
def cuda():
    """The CUDA device; skips where there is none (decided at run time, so
    every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_router_paged_and_dense_match_single_engine(cuda):
    """gpt2-117m cut to 2 layers on the card (head dim 64, kernel decode):
    a paged and a dense replica, and a role split, give the single dense
    engine's greedy streams."""
    tcfg = tconfigs.get_arch("gpt2-117m").replace(n_layers=2)
    tmodel = tzoo.build_model(tcfg)
    tparams = tzoo.init_params(tcfg, torch.Generator().manual_seed(0), cuda)
    base = dict(BASE, cache_len=128)
    single = InferenceEngine(tmodel, tparams, SchedulerConfig(**base),
                             device=cuda).run(_requests(Request))
    reps = [Replica(tmodel, tparams, SchedulerConfig(**dict(
                base, paged=True, page_size=16, n_pages=10,
                policy="shortest-prompt-first")), device=cuda, name="p"),
            Replica(tmodel, tparams, SchedulerConfig(**dict(
                base, policy="budget-packing")), device=cuda, name="d")]
    routed = Router(reps).run(_requests(Request))
    disagg = Router(make_replicas(
        tmodel, tparams, SchedulerConfig(**dict(base, paged=True,
                                                page_size=16)), 1,
        device=cuda, disaggregate=True)).run(_requests(Request))
    for a, b, c in zip(single, routed, disagg):
        assert a.tokens == b.tokens == c.tokens, f"uid {a.uid}"


# -- the CLI -------------------------------------------------------------------
@pytest.mark.parametrize("flags", [
    ["--paged", "--page-size", "16", "--n-pages", "7"],
    ["--replicas", "2", "--policy", "shortest-prompt-first",
     "--route", "round-robin"],
    ["--disaggregate", "--paged", "--page-size", "16"],
    ["--legacy"],
])
def test_cli_paths_run_on_cpu(flags, capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "gpt2-117m", "--reduced", "--device", "cpu",
                 "--batch", "3", "--requests", "6", "--prompt-len", "40",
                 "--gen", "8", *flags]) == 0
    assert "sample:" in capsys.readouterr().out


def test_legacy_static_batch_matches_engine():
    """The legacy path's greedy tokens equal the engine's on the same
    prompts and weights (reduced gpt2 has no padded vocab, so the legacy
    path's unmasked argmax is the engine's)."""
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.serve import serve
    out = serve("gpt2-117m", True, batch=3, prompt_len=24, gen_tokens=6,
                quiet=True, device="cpu")
    prompts = SyntheticCorpus(vocab_size=512, seq_len=24, seed=0).batch(
        0, 3)["tokens"]
    eng = InferenceEngine.from_arch("gpt2-117m", seed=0, device="cpu",
                                    cfg=SchedulerConfig(**dict(
                                        BASE, n_slots=3, cache_len=30)))
    res = eng.run([Request(uid=i, tokens=tuple(int(t) for t in p),
                           max_tokens=6) for i, p in enumerate(prompts)])
    assert out["generated"].tolist() == [r.tokens for r in res]
