"""Serving CLI of the port (``repro/launch/serve.py``): the continuous-batching
engine (default), the router over replicas (``--replicas N`` or
``--disaggregate``), or the legacy static-batch greedy path (``--legacy``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-117m \\
      --batch 8 --requests 16 --prompt-len 512 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-117m \\
      --reduced --device cpu --paged --page-size 16 --n-pages 7
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --reduced --device cpu --batch 2 --requests 4 --prompt-len 24
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --reduced --device cpu --batch 2 --requests 4 --prompt-len 24 --paged

``--batch`` is the slot count of each replica (the batch of the legacy
path).  The engine admits ``--requests`` ragged requests through the
prompt bucket ladder and backfills slots as generations finish.
``--paged`` serves from a shared KV page pool (``--page-size`` tokens per
page, ``--n-pages`` pages; 0 = the dense-equivalent count).  ``--policy``
picks the admission policy, ``--route`` the router's replica choice;
``--disaggregate`` splits every serving unit into a prefill-role and a
decode-role replica.  ``--metrics-jsonl PATH`` writes one JSON row per
fused decode step (per replica) and a summary row, readable with
``repro_torch.core.telemetry.read_metrics_jsonl``.  The device defaults to
"cuda" and the run fails on a machine without one unless ``--device cpu``
is given.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.data import SyntheticCorpus
from repro_torch.kernels import resolve_device
from repro_torch.serve import (POLICIES, ROUTES, InferenceEngine, Request,
                               Router, SamplingParams, SchedulerConfig,
                               cache_nbytes, make_replicas)
from repro_torch.serve.engine import build_weights


class JsonlWriter:
    """One JSON row per call, to ``path`` (``Replica.on_step_metrics``)."""

    def __init__(self, path: str):
        self._f = open(path, "w")

    def __call__(self, row: dict) -> None:
        self._f.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._f.close()


def serve(arch: str, use_reduced: bool, batch: int, prompt_len: int,
          gen_tokens: int, cache_len: int = 0, seed: int = 0,
          quiet: bool = False, device: str = "cuda"):
    """Legacy static-batch greedy decode (``serve.py:41-99``): one prefill
    of ``batch`` prompts, then ``gen_tokens`` steps of the whole batch at
    one position."""
    dev = resolve_device(device)
    model, params = build_weights(arch, use_reduced, seed, dev)
    cfg = model.cfg
    cache_len = cache_len or prompt_len + gen_tokens
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=prompt_len,
                             seed=seed)
    prompts = torch.as_tensor(np.asarray(corpus.batch(0, batch)["tokens"]),
                              dtype=torch.int64, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompts},
                                  cache_len=cache_len)
    sync()
    t_prefill = time.perf_counter() - t0
    out_tokens = []
    tok = logits.argmax(dim=-1)[:, None]
    t1 = time.perf_counter()
    for _ in range(gen_tokens):
        out_tokens.append(tok[:, 0].cpu().numpy())
        logits, cache = model.decode(params, cache, tok)
        tok = logits.argmax(dim=-1)[:, None]
    sync()
    t_decode = time.perf_counter() - t1
    gen = np.stack(out_tokens, axis=1)
    if not quiet:
        print(f"arch={cfg.name} device={dev} batch={batch} "
              f"prompt={prompt_len} gen={gen_tokens}")
        print(f"prefill: {t_prefill*1e3:.1f} ms "
              f"({batch*prompt_len/max(t_prefill, 1e-9):.0f} tok/s)")
        print(f"decode:  {t_decode*1e3:.1f} ms total, "
              f"{batch*gen_tokens/max(t_decode, 1e-9):.0f} tok/s")
        print("sample:", gen[0][:16].tolist())
    return {"prefill_s": t_prefill, "decode_s": t_decode,
            "decode_tok_s": batch * gen_tokens / max(t_decode, 1e-9),
            "generated": gen}


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


def scheduler_config(n_slots: int, prompt_len: int, cache_len: int,
                     prefill_batch: int = 1, **kw) -> SchedulerConfig:
    """The CLI's scheduler: ``n_slots`` slots of ``cache_len``, a prompt
    ladder from ``min(16, prompt_len / 4)`` in steps of ``prompt_len / 4``,
    and ``kw`` (paging, policy) as given."""
    return SchedulerConfig(
        n_slots=n_slots, cache_len=cache_len,
        min_prompt_bucket=min(16, max(prompt_len // 4, 1)),
        round_multiple=max(prompt_len // 4, 8), prefill_batch=prefill_batch,
        **kw)


def serve_engine(arch: str, use_reduced: bool, n_slots: int, prompt_len: int,
                 gen_tokens: int, n_requests: int = 0, cache_len: int = 0,
                 seed: int = 0, ragged: bool = True,
                 sampling: SamplingParams = SamplingParams(),
                 sched: SchedulerConfig = None, prefill_batch: int = 1,
                 decode_backend: str = "", attn_backend: str = "",
                 paged: bool = False, page_size: int = 64, n_pages: int = 0,
                 policy: str = "fcfs", metrics_jsonl: str = "",
                 quiet: bool = False, device: str = "cuda"):
    """Continuous-batching serve over random weights from ``seed``."""
    mcfg = get_arch(arch)
    cfg = reduce_cfg(mcfg) if use_reduced else mcfg
    n_requests = n_requests or n_slots
    cache_len = cache_len or prompt_len + gen_tokens
    sched = sched or scheduler_config(
        n_slots, prompt_len, cache_len, prefill_batch, paged=paged,
        page_size=page_size, n_pages=n_pages, policy=policy)
    engine = InferenceEngine.from_arch(
        arch, use_reduced=use_reduced, seed=seed, cfg=sched,
        decode_backend=decode_backend or None,
        attn_backend=attn_backend or None, device=device)
    writer = JsonlWriter(metrics_jsonl) if metrics_jsonl else None
    engine.on_step_metrics = writer
    reqs = make_requests(cfg, n_requests, prompt_len, gen_tokens, seed=seed,
                         ragged=ragged, sampling=sampling)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    wall = time.perf_counter() - t0
    s = engine.stats
    if writer is not None:
        writer({"summary": True, "wall_s": wall,
                "generated_tokens": s.generated_tokens,
                "decode_steps": s.decode_steps,
                "slot_errors": s.slot_errors})
        writer.close()
    if not quiet:
        print(f"arch={cfg.name} device={engine.core.device} slots={n_slots} "
              f"requests={n_requests} buckets={engine.scheduler.ladder}")
        if sched.paged:
            print(f"paged:   {sched.resolved_n_pages} pages x "
                  f"{sched.page_size} tokens "
                  f"({sched.resolved_n_pages * sched.page_size} pool tokens "
                  f"vs {n_slots * sched.cache_len} dense; "
                  f"cache {cache_nbytes(engine.cache)/1e6:.2f} MB)")
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


def serve_router(arch: str, use_reduced: bool, n_slots: int, prompt_len: int,
                 gen_tokens: int, n_requests: int = 0, cache_len: int = 0,
                 seed: int = 0, ragged: bool = True,
                 sampling: SamplingParams = SamplingParams(),
                 replicas: int = 2, policy: str = "fcfs",
                 route: str = "least-loaded", disaggregate: bool = False,
                 prefill_batch: int = 1, paged: bool = False,
                 page_size: int = 64, n_pages: int = 0,
                 decode_backend: str = "", attn_backend: str = "",
                 metrics_jsonl: str = "", quiet: bool = False,
                 device: str = "cuda"):
    """Routed serve: ``replicas`` replicas of ``n_slots`` slots, sharing one
    set of weights from ``seed``, behind the Router."""
    dev = resolve_device(device)
    model, params = build_weights(arch, use_reduced, seed, dev,
                                  decode_backend or None, attn_backend or None)
    n_requests = n_requests or replicas * n_slots
    cache_len = cache_len or prompt_len + gen_tokens
    sched = scheduler_config(n_slots, prompt_len, cache_len, prefill_batch,
                             paged=paged, page_size=page_size,
                             n_pages=n_pages, policy=policy)
    router = Router(make_replicas(model, params, sched, replicas, device=dev,
                                  disaggregate=disaggregate), route=route)
    writer = JsonlWriter(metrics_jsonl) if metrics_jsonl else None
    for rep in router.replicas:
        rep.on_step_metrics = writer
    reqs = make_requests(model.cfg, n_requests, prompt_len, gen_tokens,
                         seed=seed, ragged=ragged, sampling=sampling)
    t0 = time.perf_counter()
    results = router.run(reqs)
    wall = time.perf_counter() - t0
    summary = router.summary()
    if writer is not None:
        writer(dict(summary, summary=True, wall_s=wall))
        writer.close()
    if not quiet:
        agg = summary["aggregate"]
        print(f"arch={model.cfg.name} device={dev} replicas={replicas} "
              f"slots={n_slots}/replica policy={policy} route={route} "
              f"disaggregate={disaggregate} paged={paged} "
              f"requests={n_requests}")
        print(f"routed={summary['routed']} spilled={summary['spilled']} "
              f"shed={summary['shed']}")
        print(f"prefill: {agg['prefill_s']*1e3:.1f} ms   "
              f"decode: {agg['decode_s']*1e3:.1f} ms, "
              f"{agg['generated_tokens']} tokens, "
              f"{agg['decode_steps']} fused steps, "
              f"slot_errors={agg['slot_errors']}")
        for name, row in summary["replicas"].items():
            print(f"  {name}: admitted={row['admitted']} "
                  f"{row['decode_tok_s']:.0f} tok/s "
                  f"p95={row['p95_step_s']*1e3:.1f} ms")
        print("sample:", results[0].tokens[:16])
    return {"wall_s": wall, "results": results, "summary": summary,
            "router": router, "requests": reqs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="gpt2-117m")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch", type=int, default=4,
                   help="slots per replica / legacy static batch")
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache-len", type=int, default=0,
                   help="per-slot cache capacity (0 = prompt+gen)")
    p.add_argument("--legacy", action="store_true",
                   help="static-batch greedy path instead of the engine")
    p.add_argument("--requests", type=int, default=0,
                   help="number of requests (0 = --batch per replica)")
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
    p.add_argument("--paged", action="store_true",
                   help="KV page pool + per-slot page tables instead of "
                        "dense (n_slots, cache_len) rows")
    p.add_argument("--page-size", type=int, default=64,
                   help="tokens per KV page (with --paged)")
    p.add_argument("--n-pages", type=int, default=0,
                   help="KV pool size in pages (0 = dense-equivalent "
                        "n_slots * ceil(cache_len / page_size))")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--replicas", type=int, default=1,
                   help="serve through the Router over N replicas")
    p.add_argument("--policy", default="fcfs", choices=list(POLICIES),
                   help="admission policy (serve/policies.py)")
    p.add_argument("--route", default="least-loaded", choices=list(ROUTES),
                   help="router replica selection")
    p.add_argument("--disaggregate", action="store_true",
                   help="split each serving unit into a prefill-role and a "
                        "decode-role replica")
    p.add_argument("--metrics-jsonl", default="",
                   help="write one JSON row per fused decode step (and a "
                        "summary row) to this path")
    args = p.parse_args(argv)
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.seed)
    common = dict(n_requests=args.requests, cache_len=args.cache_len,
                  seed=args.seed, ragged=not args.uniform, sampling=sp,
                  prefill_batch=args.prefill_batch,
                  decode_backend=args.decode_backend,
                  attn_backend=args.attn_backend, paged=args.paged,
                  page_size=args.page_size, n_pages=args.n_pages,
                  policy=args.policy, metrics_jsonl=args.metrics_jsonl,
                  device=args.device)
    if args.legacy:
        serve(args.arch, args.reduced, args.batch, args.prompt_len, args.gen,
              cache_len=args.cache_len, seed=args.seed, device=args.device)
    elif args.replicas > 1 or args.disaggregate:
        serve_router(args.arch, args.reduced, args.batch, args.prompt_len,
                     args.gen, replicas=args.replicas, route=args.route,
                     disaggregate=args.disaggregate, **common)
    else:
        serve_engine(args.arch, args.reduced, args.batch, args.prompt_len,
                     args.gen, **common)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
