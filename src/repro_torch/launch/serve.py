"""Serving CLI of the port: the continuous-batching engine on one device
(``repro/launch/serve.py:100-181, 242-316``, engine branch).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-117m \\
      --batch 8 --requests 16 --prompt-len 512 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-117m \\
      --reduced --device cpu

``--batch`` is the slot count.  The engine admits ``--requests`` ragged
requests through the prompt bucket ladder and backfills slots as
generations finish.  The device defaults to "cuda" and the run fails on a
machine without one unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.data import SyntheticCorpus
from repro_torch.serve import (InferenceEngine, Request, SamplingParams,
                               SchedulerConfig)


def make_requests(cfg, n_requests: int, prompt_len: int, gen_tokens: int,
                  seed: int = 0, ragged: bool = True,
                  sampling: SamplingParams = SamplingParams()):
    """``n_requests`` prompts from the synthetic corpus; when ``ragged``,
    prompt and generation lengths vary per request."""
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=prompt_len,
                             seed=seed)
    prompts = np.asarray(corpus.batch(0, n_requests)["tokens"])
    reqs = []
    for i in range(n_requests):
        plen, mt = prompt_len, gen_tokens
        if ragged:
            plen = max(4, prompt_len - (i % 4) * max(prompt_len // 6, 1))
            mt = max(1, gen_tokens - (i % 3) * max(gen_tokens // 4, 1))
        reqs.append(Request(uid=i, tokens=tuple(int(t) for t in
                                                prompts[i, :plen]),
                            max_tokens=mt, sampling=sampling))
    return reqs


def serve_engine(arch: str, use_reduced: bool, n_slots: int, prompt_len: int,
                 gen_tokens: int, n_requests: int = 0, cache_len: int = 0,
                 seed: int = 0, ragged: bool = True,
                 sampling: SamplingParams = SamplingParams(),
                 sched: SchedulerConfig = None, prefill_batch: int = 1,
                 decode_backend: str = "", attn_backend: str = "",
                 quiet: bool = False, device: str = "cuda"):
    """Continuous-batching serve over random weights from ``seed``."""
    mcfg = get_arch(arch)
    cfg = reduce_cfg(mcfg) if use_reduced else mcfg
    n_requests = n_requests or n_slots
    cache_len = cache_len or prompt_len + gen_tokens
    sched = sched or SchedulerConfig(
        n_slots=n_slots, cache_len=cache_len,
        min_prompt_bucket=min(16, max(prompt_len // 4, 1)),
        round_multiple=max(prompt_len // 4, 8),
        prefill_batch=prefill_batch)
    engine = InferenceEngine.from_arch(
        arch, use_reduced=use_reduced, seed=seed, cfg=sched,
        decode_backend=decode_backend or None,
        attn_backend=attn_backend or None, device=device)
    reqs = make_requests(cfg, n_requests, prompt_len, gen_tokens, seed=seed,
                         ragged=ragged, sampling=sampling)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    wall = time.perf_counter() - t0
    s = engine.stats
    if not quiet:
        print(f"arch={cfg.name} device={engine.core.device} slots={n_slots} "
              f"requests={n_requests} buckets={engine.scheduler.ladder}")
        print(f"prefill: {s.prefill_s*1e3:.1f} ms ({s.prefill_tok_s:.0f} "
              f"tok/s over {s.prefill_tokens} prompt tokens)")
        print(f"decode:  {s.decode_s*1e3:.1f} ms, {s.decode_tok_s:.0f} tok/s "
              f"({s.generated_tokens} tokens, {s.decode_steps} fused steps)")
        print(f"latency: p50={s.latency_percentile(50)*1e3:.1f} ms "
              f"p95={s.latency_percentile(95)*1e3:.1f} ms per token")
        print("sample:", results[0].tokens[:16])
    return {"wall_s": wall, "prefill_s": s.prefill_s, "decode_s": s.decode_s,
            "prefill_tok_s": s.prefill_tok_s, "decode_tok_s": s.decode_tok_s,
            "p50_s": s.latency_percentile(50),
            "p95_s": s.latency_percentile(95),
            "results": results, "stats": s, "engine": engine,
            "requests": reqs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="gpt2-117m")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch", type=int, default=4, help="engine slot count")
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache-len", type=int, default=0,
                   help="per-slot cache capacity (0 = prompt+gen)")
    p.add_argument("--requests", type=int, default=0,
                   help="number of requests (0 = --batch)")
    p.add_argument("--uniform", action="store_true",
                   help="identical prompt/gen lengths per request")
    p.add_argument("--prefill-batch", type=int, default=1,
                   help="admit up to k same-bucket requests as one "
                        "(k, bucket) prefill call")
    p.add_argument("--decode-backend", default="",
                   choices=["", "reference", "kernel"],
                   help="override ModelConfig.decode_backend")
    p.add_argument("--attn-backend", default="",
                   choices=["", "blockwise", "flash"],
                   help="override ModelConfig.attn_backend")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    args = p.parse_args(argv)
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.seed)
    serve_engine(args.arch, args.reduced, args.batch, args.prompt_len,
                 args.gen, n_requests=args.requests,
                 cache_len=args.cache_len, seed=args.seed,
                 ragged=not args.uniform, sampling=sp,
                 prefill_batch=args.prefill_batch,
                 decode_backend=args.decode_backend,
                 attn_backend=args.attn_backend, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
