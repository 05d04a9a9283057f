"""The port's serving slice against the JAX engine.

Greedy continuous batching on reduced gpt2 (fp32, CPU) gives token streams
identical to the JAX ``InferenceEngine`` on the same weights, over the
workload shape of tests/test_serve_engine.py (prompt lengths across two or
more buckets, sub-bucket remainders, more requests than slots).  Sampled
decoding cannot match ``jax.random`` streams, so sampling is held by its
properties, as tests/test_serve_engine.py holds the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.configs.base import SLWConfig
from repro.core.pacing import bucket_ladder
from repro.data import SyntheticCorpus
from repro.launch.serve import make_requests as jax_make_requests
from repro.models import build_model, init_params
from repro.serve import InferenceEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import SchedulerConfig as JaxSchedulerConfig
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import SLWConfig as TSLWConfig
from repro_torch.core.pacing import bucket_ladder as tbucket_ladder
from repro_torch.data import SyntheticCorpus as TSyntheticCorpus
from repro_torch.launch.serve import make_requests, serve_engine
from repro_torch.models import model_zoo as tzoo
from repro_torch.serve import (InferenceEngine, Request, SamplingParams,
                               SchedulerConfig, prefill_split)
from repro_torch.serve import sampling as S

CPU = torch.device("cpu")
SHAPES = [(7, 5), (20, 9), (33, 3), (12, 7), (40, 4), (9, 8), (25, 6),
          (16, 2)]  # (prompt_len, max_tokens), tests/test_serve_engine.py:65


@pytest.fixture(scope="module")
def weights():
    cfg = reduced(get_arch("gpt2-117m").model)
    params = init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tconfigs.reduced(tconfigs.get_arch("gpt2-117m"))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                tcfg, CPU)
    return cfg, params, tcfg, tparams


def _sched(cls, **kw):
    return cls(n_slots=3, cache_len=64, min_prompt_bucket=8,
               round_multiple=16, max_buckets=4, **kw)


def _prompts(seed=3):
    rng = np.random.default_rng(seed)
    return [(tuple(int(t) for t in rng.integers(0, 512, size=plen)), mt)
            for plen, mt in SHAPES]


def _run_both(weights, prefill_batch=1, shapes=None):
    cfg, params, tcfg, tparams = weights
    prompts = shapes or _prompts()
    jeng = JaxEngine(build_model(cfg, dtype=jnp.float32, remat="none"),
                     params, _sched(JaxSchedulerConfig,
                                    prefill_batch=prefill_batch))
    teng = InferenceEngine(tzoo.build_model(tcfg), tparams,
                           _sched(SchedulerConfig,
                                  prefill_batch=prefill_batch), device="cpu")
    jres = jeng.run([JaxRequest(uid=i, tokens=t, max_tokens=mt)
                     for i, (t, mt) in enumerate(prompts)])
    tres = teng.run([Request(uid=i, tokens=t, max_tokens=mt)
                     for i, (t, mt) in enumerate(prompts)])
    return jeng, teng, jres, tres


@pytest.mark.parametrize("prefill_batch", [1, 2])
def test_engine_greedy_streams_match_reference(weights, prefill_batch):
    jeng, teng, jres, tres = _run_both(weights, prefill_batch)
    splits = {prefill_split(len(t), teng.scheduler.ladder)
              for t, _ in _prompts()}
    assert len(splits) >= 2  # several buckets and sub-bucket remainders
    assert teng.scheduler.ladder == jeng.scheduler.ladder
    for j, t in zip(jres, tres):
        assert t.tokens == j.tokens, f"uid {t.uid}"
        assert t.finish_reason == j.finish_reason == "length"
    assert teng.stats.admitted == len(SHAPES)
    assert sorted(teng.scheduler.free) == [0, 1, 2]
    assert not teng.scheduler.busy


def test_engine_stop_token_and_reuse(weights):
    _, teng, _, tres = _run_both(weights)
    first = tres[1]
    stop = first.tokens[1]
    t, mt = _prompts()[1]
    teng.reset_stats()
    res = teng.run([Request(uid=1, tokens=t, max_tokens=mt,
                            sampling=SamplingParams(stop_token=stop)),
                    Request(uid=5, tokens=t[:5], max_tokens=1)])
    assert res[0].tokens == first.tokens[:2]
    assert res[0].finish_reason == "stop_token"
    assert res[1].n_generated == 1 and res[1].finish_reason == "length"
    assert teng.stats.admitted == 2


def test_engine_rejects_bad_requests_all_or_nothing(weights):
    _, _, tcfg, tparams = weights
    eng = InferenceEngine(tzoo.build_model(tcfg), tparams,
                          _sched(SchedulerConfig), device="cpu")
    with pytest.raises(ValueError):
        eng.run([Request(uid=0, tokens=(1, 2), max_tokens=2),
                 Request(uid=1, tokens=(1,) * 60, max_tokens=10)])
    assert not eng.scheduler.pending


def test_ladder_corpus_and_requests_match_reference():
    for s0, m, nb, full in [(8, 16, 4, 64), (12, 128, 8, 576), (1, 8, 32, 40)]:
        assert tbucket_ladder(TSLWConfig(start_seq_len=s0, round_multiple=m,
                                         max_buckets=nb), full) \
            == bucket_ladder(SLWConfig(start_seq_len=s0, round_multiple=m,
                                       max_buckets=nb), full)
    a = SyntheticCorpus(vocab_size=512, seq_len=33, seed=4).batch(2, 3)
    b = TSyntheticCorpus(vocab_size=512, seq_len=33, seed=4).batch(2, 3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    cfg = reduced(get_arch("gpt2-117m").model)
    jr = jax_make_requests(cfg, 6, 40, 8, seed=1)
    tr = make_requests(cfg, 6, 40, 8, seed=1)
    assert [(r.tokens, r.max_tokens) for r in jr] \
        == [(r.tokens, r.max_tokens) for r in tr]


def test_serve_engine_on_cpu_counts_no_kernel_launch():
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_decode import flash_decode_fwd
    before = (flash_attention_fwd.launches, flash_decode_fwd.launches)
    out = serve_engine("gpt2-117m", True, n_slots=2, prompt_len=24,
                       gen_tokens=4, n_requests=3, quiet=True, device="cpu")
    assert [r.n_generated for r in out["results"]] == [4, 3, 2]
    assert out["stats"].decode_steps > 0
    assert (flash_attention_fwd.launches, flash_decode_fwd.launches) == before


# ---------------------------------------------------------------------------
# sampling, by its properties (tests/test_serve_engine.py:366-416)
# ---------------------------------------------------------------------------

def _logits(seed, shape):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _u(n, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).random(n).astype(np.float32))


def test_sampling_greedy_is_argmax():
    logits = _logits(0, (5, 64))
    out = S.sample_tokens(logits, _u(5), torch.zeros(5),
                          torch.zeros(5, dtype=torch.long), torch.ones(5))
    assert (out == logits.argmax(-1)).all()


def test_sampling_topk1_and_tiny_topp_are_argmax():
    logits = _logits(1, (4, 64))
    am = logits.argmax(-1)
    ones, zk = torch.ones(4), torch.zeros(4, dtype=torch.long)
    assert (S.sample_tokens(logits, _u(4), ones,
                            torch.ones(4, dtype=torch.long), ones) == am).all()
    assert (S.sample_tokens(logits, _u(4), ones, zk,
                            torch.full((4,), 1e-6)) == am).all()
    assert (S.sample_tokens(logits, _u(4), ones, zk, torch.zeros(4))
            == am).all()


def test_sampling_topk_support_and_per_row_params():
    logits = _logits(2, (6, 128))
    ks = torch.tensor([1, 2, 4, 8, 0, 3])
    masked = S.apply_top_k(logits, ks)
    assert (masked > -1e29).sum(-1).tolist() == [1, 2, 4, 8, 128, 3]
    for seed in range(5):
        out = S.sample_tokens(logits, _u(6, seed), torch.ones(6), ks,
                              torch.ones(6))
        for i in range(6):
            assert masked[i, out[i]] > -1e29


def test_sampling_streams_are_per_request_and_deterministic():
    a = [S.draw_uniform(S.request_generator(0, uid)) for uid in range(4)]
    b = [S.draw_uniform(S.request_generator(0, uid)) for uid in (3, 2, 1, 0)]
    assert a == b[::-1] and len(set(a)) == 4
    assert S.draw_uniform(S.request_generator(1, 0)) != a[0]


def test_sampling_vocab_mask_and_distribution():
    logits = torch.zeros(2, 8)
    logits[:, 7] = 10.0
    out = S.sample_tokens(logits, _u(2), torch.zeros(2),
                          torch.zeros(2, dtype=torch.long), torch.ones(2),
                          vocab_size=7)
    assert (out < 7).all()
    # inverse-CDF draws follow the softmax: a 3-token row at temperature 1
    row = torch.log(torch.tensor([[0.5, 0.3, 0.2]]))
    u = _u(4000, seed=9)
    draws = torch.stack([S.sample_tokens(row, u[i:i + 1], torch.ones(1),
                                         torch.zeros(1, dtype=torch.long),
                                         torch.ones(1))[0]
                         for i in range(0, 4000, 4)])
    freq = torch.bincount(draws, minlength=3).float() / len(draws)
    assert torch.allclose(freq, torch.tensor([0.5, 0.3, 0.2]), atol=0.05)


def test_sampled_engine_is_reproducible_and_batch_independent(weights):
    _, _, tcfg, tparams = weights
    sp = SamplingParams(temperature=0.9, top_k=20, top_p=0.95, seed=7)
    reqs = [Request(uid=i, tokens=t, max_tokens=mt, sampling=sp)
            for i, (t, mt) in enumerate(_prompts())]

    def run(n_slots, order):
        eng = InferenceEngine(tzoo.build_model(tcfg), tparams,
                              SchedulerConfig(n_slots=n_slots, cache_len=64,
                                              min_prompt_bucket=8,
                                              round_multiple=16,
                                              max_buckets=4), device="cpu")
        res = eng.run([reqs[i] for i in order])
        return {r.uid: r.tokens for r in res}

    a = run(3, range(8))
    b = run(2, reversed(range(8)))
    assert a == b
    assert all(0 <= t < 512 for toks in a.values() for t in toks)
