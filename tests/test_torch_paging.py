"""The port's paged KV serving against the JAX package.

* the paged kernel's plain version (``flash_decode_paged_fwd`` on CPU
  tensors) against the JAX Pallas kernel run with ``interpret=True`` and
  against ``jx.paged_decode_partials_reference``, on the reference's
  ``_paged_fixture`` shape (tests/test_paging.py:281), with ``-1`` table
  entries and an empty slot.  Tolerance: fp32 max abs error 1e-5, as
  tests/test_torch_kernels.py states it (the reference's own
  kernel-vs-oracle error is 1.6e-7; the rest is summation order);
* the page allocator, step for step against the JAX allocator on the same
  random operations, and its invariants;
* the paged engine against the dense engine and against the JAX paged
  engine on the same weights (``bridge.py``), greedy token for token, on
  jx.reduced gpt2 with page size 16 and 7 pages (the reference's ``PAGED``);
* the state's gather/evict/insert round trip, admission under page
  exhaustion, the undersized-pool check, frozen free-slot positions, the
  write at capacity, and the shared-pool write collision.

Tests marked ``gpu`` hold the CUDA paged kernel against its plain version
on the card and skip where there is none:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_paging.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels.flash_decode import (flash_decode_paged,
                                              flash_decode_paged_fwd,
                                              flash_decode_paged_fwd_plain,
                                              flash_decode_paged_partials,
                                              gather_pages)
from repro_torch.models import model_zoo as tzoo
from repro_torch.serve import (InferenceEngine, PageAllocator,
                               PagedDecodeState, PageExhausted, Request,
                               SamplingParams, Scheduler, SchedulerConfig,
                               SlotDecodeState, cache_nbytes, pages_for)

CPU = torch.device("cpu")
TOL = 1e-5  # fp32 max abs error, see the module docstring
SHAPES = [(7, 5), (20, 9), (33, 3), (12, 7), (40, 4), (9, 8), (25, 6),
          (16, 2)]  # (prompt_len, max_tokens), tests/test_paging.py:45
DENSE = dict(n_slots=3, cache_len=64, min_prompt_bucket=8, round_multiple=16,
             max_buckets=4)
# 7 * 16 = 112 pool tokens < 3 * 64 dense, small enough that admissions
# wait on pages mid-run (tests/test_paging.py:59-62)
PAGED = dict(DENSE, paged=True, page_size=16, n_pages=7)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side (skips where JAX is absent, so the card tests
    also run there)."""
    jnp = pytest.importorskip("jax.numpy")
    import jax
    from repro.configs import get_arch, reduced
    from repro.kernels import flash_decode_paged, flash_decode_paged_partials
    from repro.kernels.flash_decode.ref import (
        gather_pages, paged_decode_partials_reference)
    from repro.models import build_model, init_params
    from repro.serve import (InferenceEngine, PageAllocator,
                             PagedDecodeState, Request, Scheduler,
                             SchedulerConfig)
    from repro.serve.paging import pages_for
    return types.SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def weights(jx):
    cfg = jx.reduced(jx.get_arch("gpt2-117m").model)
    params = jx.init_params(jx.jax.random.PRNGKey(0), cfg)
    tcfg = tconfigs.reduced(tconfigs.get_arch("gpt2-117m"))
    tparams = params_from_numpy(jx.jax.tree_util.tree_map(np.asarray, params),
                                tcfg, CPU)
    model = jx.build_model(cfg, dtype=jx.jnp.float32, remat="none")
    return cfg, model, params, tzoo.build_model(tcfg), tparams


def _requests(cls, seed=3, sampling=None):
    rng = np.random.default_rng(seed)
    kw = {} if sampling is None else {"sampling": sampling}
    return [cls(uid=i, tokens=tuple(int(t) for t in
                                    rng.integers(0, 512, size=plen)),
                max_tokens=mt, **kw)
            for i, (plen, mt) in enumerate(SHAPES)]


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port.detach().float()),
                               np.asarray(ref, np.float32), rtol=0, atol=tol)


# -- the paged kernel's plain version ----------------------------------------
def _paged_fixture(seed=0, shuffle=False, b=5, h=8, kvh=4, d=16, ps=8,
                   n_pages=12, mp=4):
    """tests/test_paging.py:281: ragged ownership with a full slot and an
    empty one, -1 tails; ``shuffle`` hands the pages out in random order."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k_pool = rng.normal(size=(n_pages, ps, kvh, d)).astype(np.float32)
    v_pool = rng.normal(size=(n_pages, ps, kvh, d)).astype(np.float32)
    table = np.full((b, mp), -1, np.int32)
    lengths = np.asarray([5, 8, 19, 32, 0], np.int32)
    free = list(range(n_pages))[::-1]
    if shuffle:
        rng.shuffle(free)
    for i, ln in enumerate(lengths):
        for j in range(pages_for(int(ln), ps)):
            table[i, j] = free.pop()
    return q, k_pool, v_pool, table, lengths


@pytest.mark.parametrize("shuffle", [False, True])
def test_paged_plain_matches_jax_kernel_and_oracle(jx, shuffle):
    args = _paged_fixture(seed=int(shuffle), shuffle=shuffle)
    targs = tuple(map(torch.from_numpy, args))
    jargs = tuple(map(jx.jnp.asarray, args))
    assert (args[3] == -1).any() and (args[4] == 0).any()
    before = flash_decode_paged_fwd.launches
    _close(flash_decode_paged(*targs),
           jx.flash_decode_paged(*jargs, interpret=True))
    o, m, l = flash_decode_paged_partials(*targs)
    jo, jm, jl = jx.flash_decode_paged_partials(*jargs, interpret=True)
    b, h, d = args[0].shape
    ro, rm, rl = jx.paged_decode_partials_reference(*jargs)
    for got, kern, ref in ((o, jo, ro), (m, jm, rm), (l, jl, rl)):
        _close(got, kern)
        _close(got, ref)
    assert (m[4] == -1e30).all() and (l[4] == 0).all() and (o[4] == 0).all()
    assert flash_decode_paged_fwd.launches == before  # CPU: no launch


def test_gather_pages_matches_jax_with_holes(jx):
    """A -1 inside a row as well as at its tail: zeroed, positions kept."""
    rng = np.random.default_rng(4)
    pool = rng.normal(size=(6, 4, 2, 8)).astype(np.float32)
    table = np.array([[3, -1, 0, -1], [-1, -1, -1, -1], [5, 1, 2, 4]],
                     np.int32)
    got = gather_pages(torch.from_numpy(pool), torch.from_numpy(table))
    assert got.shape == (3, 16, 2, 8)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jx.gather_pages(jx.jnp.asarray(pool),
                                                 jx.jnp.asarray(table))))


def test_paged_plain_is_the_dense_plain_over_gathered_pages():
    q, k_pool, v_pool, table, lengths = map(torch.from_numpy,
                                            _paged_fixture(seed=2))
    from repro_torch.kernels.flash_decode import flash_decode_fwd_plain
    qg = q.reshape(5, 4, 2, 16)
    dense = flash_decode_fwd_plain(qg, gather_pages(k_pool, table),
                                   gather_pages(v_pool, table), lengths)
    for a, b in zip(flash_decode_paged_fwd_plain(qg, k_pool, v_pool, table,
                                                 lengths), dense):
        assert torch.equal(a, b)


# -- allocator -----------------------------------------------------------------
def _allocator_state(a):
    return (a.table.tolist(), list(a.free_pages), a.owned.tolist(),
            a.reserved.tolist())


def test_allocator_random_ops_match_jax_and_never_leak(jx):
    """The reference's property test (tests/test_paging.py:121), each step
    applied to both allocators: same answers, same tables and free lists,
    and the ownership invariants after every step."""
    rng = np.random.default_rng(0)
    port = PageAllocator(n_pages=13, page_size=4, n_slots=5,
                         pages_per_slot=4)
    ref = jx.PageAllocator(n_pages=13, page_size=4, n_slots=5,
                           pages_per_slot=4)
    live = {}
    for _ in range(500):
        op = rng.integers(0, 4)
        slot = int(rng.integers(0, 5))
        if op == 0 and slot not in live:
            need = int(rng.integers(1, 5))
            ok = port.reserve(slot, need)
            assert ok == ref.reserve(slot, need)
            if ok:
                live[slot] = need
        elif op == 1 and slot in live:
            n_tok = int(rng.integers(1, live[slot] * 4 + 1))
            port.allocate(slot, n_tok)
            ref.allocate(slot, n_tok)
        elif op == 2 and slot in live:
            port.free_slot(slot)
            ref.free_slot(slot)
            del live[slot]
        elif op == 3 and slot in live:
            before = int(port.owned[slot])
            port.allocate(slot, before * 4)
            ref.allocate(slot, before * 4)
            assert int(port.owned[slot]) == before
        port.check()
        assert _allocator_state(port) == _allocator_state(ref)
        assert port.committed == ref.committed
    for slot in list(live):
        port.free_slot(slot)
    port.check()
    assert port.pages_in_use == 0


def test_allocator_exhaustion_is_explicit():
    alloc = PageAllocator(n_pages=3, page_size=4, n_slots=2, pages_per_slot=4)
    assert alloc.reserve(0, 3)
    alloc.allocate(0, 12)
    with pytest.raises(PageExhausted):
        alloc.allocate(1, 1)
    assert not alloc.reserve(1, 5)  # > pages_per_slot: never honored
    roomy = PageAllocator(n_pages=5, page_size=4, n_slots=2, pages_per_slot=2)
    assert roomy.reserve(0, 2)
    with pytest.raises(PageExhausted):
        roomy.allocate(0, 9)  # 3 pages, the table holds 2


@pytest.mark.parametrize("n,ps", [(0, 16), (1, 16), (16, 16), (17, 16),
                                  (576, 64), (289, 64), (3, 4)])
def test_pages_for_matches_jax(jx, n, ps):
    assert pages_for(n, ps) == jx.pages_for(n, ps)


# -- engine parity -------------------------------------------------------------
def test_paged_engine_matches_dense_and_jax_paged(jx, weights):
    _, model, params, tmodel, tparams = weights
    cfg = SchedulerConfig(**PAGED)
    assert cfg.resolved_n_pages * cfg.page_size < DENSE["n_slots"] \
        * DENSE["cache_len"]
    dense = InferenceEngine(tmodel, tparams, SchedulerConfig(**DENSE),
                            device="cpu")
    paged = InferenceEngine(tmodel, tparams, cfg, device="cpu")
    d_res = dense.run(_requests(Request))
    p_res = paged.run(_requests(Request))
    j_res = jx.InferenceEngine(model, params, jx.SchedulerConfig(**PAGED)).run(
        _requests(jx.Request))
    for d, p, j in zip(d_res, p_res, j_res):
        assert p.uid == d.uid == j.uid
        assert p.tokens == d.tokens == j.tokens, f"uid {d.uid}"
        assert p.finish_reason == d.finish_reason == j.finish_reason
    paged.state.alloc.check()
    assert paged.state.alloc.pages_in_use == 0
    assert sorted(paged.scheduler.free) == [0, 1, 2]
    kv = lambda c: {k: c[k] for k in ("k", "v")}
    assert cache_nbytes(kv(paged.cache)) < cache_nbytes(kv(dense.cache))
    # the device table was uploaded only when the host table changed
    assert 0 < paged.state.table_uploads < paged.stats.decode_steps


def test_paged_engine_oversubscribed_waits_and_completes(jx, weights):
    """A 3-page pool holds one 2-page request at a time: admission waits
    for pages with slots free, and every stream equals the dense engine's
    and the JAX paged engine's (tests/test_paging.py:245)."""
    _, model, params, tmodel, tparams = weights
    base = dict(n_slots=2, cache_len=32, min_prompt_bucket=8,
                round_multiple=8, max_buckets=2)
    tight = dict(base, paged=True, page_size=16, n_pages=3)
    reqs = lambda cls: [cls(uid=i, tokens=tuple(range(3 + i, 13 + i)),
                            max_tokens=9) for i in range(4)]
    paged = InferenceEngine(tmodel, tparams, SchedulerConfig(**tight),
                            device="cpu")
    refused = []
    reserve = paged.core.reserve

    def spy(slot, request):
        ok = reserve(slot, request)
        refused.extend([] if ok else [request.uid])
        return ok

    paged.core.reserve = spy
    p_res = paged.run(reqs(Request))
    d_res = InferenceEngine(tmodel, tparams, SchedulerConfig(**base),
                            device="cpu").run(reqs(Request))
    j_res = jx.InferenceEngine(model, params, jx.SchedulerConfig(**tight)).run(
        reqs(jx.Request))
    assert refused  # a slot was free, but the request waited for pages
    for p, d, j in zip(p_res, d_res, j_res):
        assert p.tokens == d.tokens == j.tokens and p.finish_reason == "length"
    paged.state.alloc.check()
    assert paged.state.alloc.pages_in_use == 0


def test_paged_engine_stop_token_and_reuse(weights):
    *_, tmodel, tparams = weights
    dense = InferenceEngine(tmodel, tparams, SchedulerConfig(**DENSE),
                            device="cpu")
    paged = InferenceEngine(tmodel, tparams, SchedulerConfig(**PAGED),
                            device="cpu")
    rng = np.random.default_rng(0)
    base = tuple(int(t) for t in rng.integers(0, 512, size=9))
    oracle = dense.run([Request(uid=0, tokens=base, max_tokens=6)])[0].tokens
    stop = oracle[1]
    res = paged.run([Request(uid=0, tokens=base, max_tokens=6,
                             sampling=SamplingParams(stop_token=stop)),
                     Request(uid=1, tokens=base[:5], max_tokens=1),
                     Request(uid=2, tokens=base, max_tokens=6)])
    assert res[0].tokens == oracle[:2] and res[0].finish_reason == "stop_token"
    assert res[1].n_generated == 1
    assert res[2].tokens == oracle
    paged.state.alloc.check()
    assert paged.state.alloc.pages_in_use == 0
    assert paged.run([Request(uid=7, tokens=base,
                              max_tokens=6)])[0].tokens == oracle


# -- state ---------------------------------------------------------------------
def _prefill_row(tmodel, tparams, n_tok, cache_len, seed=5):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 512, size=(1, n_tok)))
    return tmodel.prefill(tparams, {"tokens": toks}, cache_len=cache_len)[1]


def test_paged_gather_evict_insert_roundtrip(weights):
    """gather -> evict -> insert through the pool is bit-exact, also when
    the re-inserted slot lands on other pages (tests/test_paging.py:181)."""
    *_, tmodel, tparams = weights
    state = PagedDecodeState(tmodel, page_size=8, n_pages=10)
    cache = state.init_slots(3, 32, torch.float32, CPU)
    row = _prefill_row(tmodel, tparams, 13, 32)
    assert state.alloc.reserve(1, pages_for(32, 8))
    cache = state.insert(cache, 1, row)
    got = state.gather(cache, 1)
    assert set(got) == set(row)  # model format: no active leaf
    assert torch.equal(got["k"], row["k"]) and torch.equal(got["v"], row["v"])
    assert int(got["pos"]) == 13
    cache = state.evict(cache, 1)
    state.alloc.check()
    assert state.alloc.pages_in_use == 0
    assert (state.alloc.table == -1).all()
    assert state.alloc.reserve(0, 2)
    state.alloc.allocate(0, 16)  # churn: slot 1 lands on other pages
    assert state.alloc.reserve(1, pages_for(32, 8))
    cache = state.insert(cache, 1, got)
    assert state.alloc.table[1, 0] != 0
    again = state.gather(cache, 1)
    assert torch.equal(again["k"], row["k"]) and int(again["pos"]) == 13


def test_page_exhaustion_blocks_then_admits_as_jax(jx):
    """Strict FCFS under page pressure, both packages on the same script:
    a blocked head returns [] with the queue untouched; an evict that
    frees pages lets it in (tests/test_paging.py:215)."""
    kw = dict(n_slots=2, cache_len=32, page_size=16, n_pages=3, paged=True,
              min_prompt_bucket=8, round_multiple=8, max_buckets=2)
    tcfg = tconfigs.reduced(tconfigs.get_arch("gpt2-117m"))
    state = PagedDecodeState(tzoo.build_model(tcfg), 16, 3)
    state.init_slots(2, 32, torch.float32, CPU)
    jcfg = jx.reduced(jx.get_arch("gpt2-117m").model)
    jstate = jx.PagedDecodeState(jx.build_model(jcfg, dtype=jx.jnp.float32,
                                             remat="none"), 16, 3)
    jstate.init_slots(2, 32)
    trace = []
    for sched, st, req in ((Scheduler(SchedulerConfig(**kw)), state, Request),
                           (jx.Scheduler(jx.SchedulerConfig(**kw)), jstate,
                            jx.Request)):
        sched.submit(req(uid=0, tokens=(1,) * 10, max_tokens=10))
        sched.submit(req(uid=1, tokens=(2,) * 10, max_tokens=10))
        steps = []
        adm = sched.next_admission(reserve=st.try_reserve)
        steps.append([(s, r.uid) for s, r in adm])
        slot0 = adm[0][0]
        steps.append(sched.next_admission(reserve=st.try_reserve))
        steps.append([r.uid for r in sched.pending])
        assert sched.free  # a free slot, but no pages: it waits
        st.alloc.free_slot(slot0)
        sched.free.append(slot0)
        steps.append([(s, r.uid) for s, r in
                      sched.next_admission(reserve=st.try_reserve)])
        st.alloc.check()
        trace.append(steps)
    assert trace[0] == trace[1] == [[(0, 0)], [], [1], [(0, 1)]]


def test_scheduler_rejects_undersized_pool(jx):
    kw = dict(n_slots=2, cache_len=64, paged=True, page_size=16, n_pages=3)
    with pytest.raises(ValueError):
        Scheduler(SchedulerConfig(**kw))
    with pytest.raises(ValueError):
        jx.Scheduler(jx.SchedulerConfig(**kw))
    Scheduler(SchedulerConfig(**dict(kw, n_pages=4)))  # one maximal request


def _state(tmodel, paged):
    return (PagedDecodeState(tmodel, page_size=4, n_pages=12) if paged
            else SlotDecodeState(tmodel))


@pytest.mark.parametrize("paged", [False, True])
def test_free_slot_pos_frozen_during_fused_decode(weights, paged):
    """Only the occupied slot advances; free and evicted slots stay at 0
    (tests/test_paging.py:328), with dense rows or a page pool."""
    *_, tmodel, tparams = weights
    state = _state(tmodel, paged)
    cache = state.init_slots(3, 16, torch.float32, CPU)
    if paged:
        assert state.alloc.reserve(1, 4)
    cache = state.insert(cache, 1, _prefill_row(tmodel, tparams, 5, 16,
                                                seed=2))
    for _ in range(3):
        _, cache = state.decode(tparams, cache,
                                torch.zeros((3, 1), dtype=torch.long))
    assert cache["pos"].tolist() == [0, 8, 0]
    cache = state.evict(cache, 1)
    _, cache = state.decode(tparams, cache,
                            torch.zeros((3, 1), dtype=torch.long))
    assert cache["pos"].tolist() == [0, 0, 0]


@pytest.mark.parametrize("paged", [False, True])
def test_decode_write_clamped_at_cache_len(weights, paged):
    """A write past the capacity is dropped and ``pos`` saturates
    (tests/test_paging.py:352)."""
    *_, tmodel, tparams = weights
    state = _state(tmodel, paged)
    cache = state.init_slots(1, 8, torch.float32, CPU)
    if paged:
        assert state.alloc.reserve(0, 2)
    cache = state.insert(cache, 0, _prefill_row(tmodel, tparams, 6, 8,
                                                seed=4))
    step = torch.zeros((1, 1), dtype=torch.long)
    _, cache = state.decode(tparams, cache, step)  # pos 6 -> 7
    _, cache = state.decode(tparams, cache, step)  # pos 7 -> 8 (full)
    k_full = cache["k"].clone()
    _, cache = state.decode(tparams, cache, step)  # past capacity
    assert int(cache["pos"][0]) == 8
    assert torch.equal(cache["k"], k_full)


@pytest.mark.parametrize("writer", [0, 1])
def test_pool_write_collision_keeps_the_writing_slot(jx, weights, writer):
    """Slot ``writer`` writes its new k/v at page 0, offset 0; the other
    slot is inactive with an all-unowned table row at position 0, so a
    clamped index (page -1 -> 0) lands on the same entry in the same step.
    The write must survive, and the step must equal the JAX decode of the
    same cache."""
    cfg, model, params, tmodel, tparams = weights
    rng = np.random.default_rng(11)
    n_layers, kvh, hd = 2, tmodel.cfg.n_kv_heads, tmodel.cfg.resolved_head_dim
    pool = rng.normal(size=(2, n_layers, 6, 4, kvh, hd)).astype(np.float32)
    table = np.full((2, 3), -1, np.int32)
    table[writer] = [5, 0, -1]
    pos = np.zeros(2, np.int64)
    pos[writer] = 4  # logical page 1 = physical page 0, offset 0
    active = np.arange(2) == writer
    toks = rng.integers(0, 512, size=(2, 1))
    tcache = {"k": torch.from_numpy(pool[0].copy()),
              "v": torch.from_numpy(pool[1].copy()),
              "pos": torch.from_numpy(pos), "active": torch.from_numpy(active),
              "page_table": torch.from_numpy(table)}
    jcache = {"k": jx.jnp.asarray(pool[0]), "v": jx.jnp.asarray(pool[1]),
              "pos": jx.jnp.asarray(pos, jx.jnp.int32), "active": jx.jnp.asarray(active),
              "page_table": jx.jnp.asarray(table)}
    logits, tcache = tmodel.decode(tparams, tcache, torch.from_numpy(toks))
    jlogits, jcache = model.decode(params, jcache, jx.jnp.asarray(toks,
                                                               jx.jnp.int32))
    for name in ("k", "v"):
        new = tcache[name][:, 0, 0]
        assert not np.allclose(new.numpy(),
                               pool[int(name == "v")][:, 0, 0])
        _close(tcache[name], jcache[name])
    _close(logits[writer], np.asarray(jlogits)[writer])
    assert tcache["pos"].tolist() == [5 if i == writer else 0
                                      for i in range(2)]


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda():
    """The CUDA device; skips where there is none (decided at run time, so
    every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [4, 8, 16, 64])
@pytest.mark.parametrize("g", [1, 4])
def test_cuda_flash_decode_paged_matches_plain(cuda, ps, g, dtype):
    """Shuffled pages, -1 at row tails, past the length inside a row and
    inside the length (a zero key and value on both sides), lengths 0, 1,
    one page, one past a page and the full table; partials within 2e-5
    (normalised o, relative l, m)."""
    gen = torch.Generator(device=cuda).manual_seed(ps * 10 + g)
    max_pages = max(2, 256 // ps)
    n_pages = 8 * max_pages
    q = torch.randn(8, 12, g, 64, device=cuda, generator=gen).to(dtype)
    k_pool, v_pool = (torch.randn(n_pages, ps, 12, 64, device=cuda,
                                  generator=gen).to(dtype) for _ in range(2))
    lengths = [0, 1, ps, ps + 1, max_pages * ps, 3 * ps // 2 + 1,
               max_pages * ps - 1, 2]
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(g))
    table = torch.full((8, max_pages), -1, dtype=torch.int32)
    nxt = 0
    for b, ln in enumerate(lengths):
        for j in range(pages_for(ln, ps)):
            table[b, j] = perm[nxt]
            nxt += 1
    table[5, -1] = perm[nxt]  # an owned page past the length, after a hole
    table[6, 0] = -1  # a hole inside the length
    table, lens = table.to(cuda), torch.tensor(lengths, dtype=torch.int32,
                                               device=cuda)
    before = flash_decode_paged_fwd.launches
    o, m, l = flash_decode_paged_fwd(q, k_pool, v_pool, table, lens)
    assert flash_decode_paged_fwd.launches == before + 1
    ro, rm, rl = flash_decode_paged_fwd_plain(q, k_pool, v_pool, table, lens)
    torch.cuda.synchronize()
    norm = o / l[..., None].clamp_min(1e-30)
    rnorm = ro / rl[..., None].clamp_min(1e-30)
    assert (norm - rnorm).abs().max().item() <= 2e-5
    assert ((l - rl).abs() / rl.clamp_min(1.0)).max().item() <= 2e-5
    assert (m - rm).abs().max().item() <= 2e-5
    assert (m[0] == -1e30).all() and (l[0] == 0).all() and (o[0] == 0).all()


@pytest.mark.gpu
def test_cuda_paged_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(2, 4, 1, 64, device=cuda)
    pool = torch.zeros(6, 16, 4, 64, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    table = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # int64 table
        flash_decode_paged_fwd(q, pool, pool, table.long(), lens)
    with pytest.raises(ValueError):  # table rows != B
        flash_decode_paged_fwd(q, pool, pool, table[:1].contiguous(), lens)
    with pytest.raises(ValueError):  # head dim 48
        p48 = torch.zeros(6, 16, 4, 48, device=cuda)
        flash_decode_paged_fwd(torch.zeros(2, 4, 1, 48, device=cuda), p48,
                               p48, table, lens)


@pytest.mark.gpu
def test_cuda_paged_engine_matches_dense_engine(cuda):
    """gpt2-117m cut to 2 layers on the card (head dim 64, which the
    kernels take): paged and dense engines, kernel decode, give the same
    greedy streams."""
    tcfg = tconfigs.get_arch("gpt2-117m").replace(n_layers=2)
    tmodel = tzoo.build_model(tcfg)
    tparams = tzoo.init_params(tcfg, torch.Generator().manual_seed(0), cuda)
    kw = dict(DENSE, cache_len=128)
    dense = InferenceEngine(tmodel, tparams, SchedulerConfig(**kw),
                            device=cuda)
    paged = InferenceEngine(tmodel, tparams, SchedulerConfig(
        **dict(kw, paged=True, page_size=16, n_pages=10)), device=cuda)
    before = flash_decode_paged_fwd.launches
    d_res = dense.run(_requests(Request))
    p_res = paged.run(_requests(Request))
    assert flash_decode_paged_fwd.launches \
        == before + tmodel.cfg.n_layers * paged.stats.decode_steps
    assert [r.tokens for r in p_res] == [r.tokens for r in d_res]
