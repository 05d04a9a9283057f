#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` from this
checkout and holds each against its plain PyTorch version, then drives
the port's two paths at full width with random weights from a seed:

* serving: GPT-2 117M through ``repro_torch.launch.serve.serve_engine``,
  checking that it launched the forward flash-attention and flash-decode
  kernels the expected number of times and that its greedy token streams
  equal the plain (no custom kernel) path's on the same card;
* training: GPT-2 117M for 30 steps of sequence-length warmup through
  ``repro_torch.launch.train.Trainer``, checking finite losses, the plans
  of ``predict_trajectory``, the launch counts of the forward and the three
  backward flash-attention kernels, every gradient leaf of two batches and
  the first 8 steps against the same run with plain attention on the same
  card.

Phases print one line each.  The second-to-last line lists each kernel
with its error, times and bound; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the run
exits non-zero and prints no result.  Imports nothing of JAX or of the
JAX package ``repro``.
"""
from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; dense FLOP/s by
# input type (fp32 on the CUDA cores, bf16 on the tensor cores)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
H, D = 12, 64  # gpt2-117m heads and head dim
PROMPT_LEN, GEN = 512, 64  # the served requests' longest prompt and budget
SEED = 0
# the training run: gpt2-117m, global batch 16 of sequences of 1024, SLW
# linear from 8 over 20 steps, batch warmup from 8, 30 steps, one eval
B_TRAIN, S_TRAIN, TRAIN_STEPS, EVAL_BATCH = 16, 1024, 30, 8
PARITY_STEPS = 8
# the training run and its plain-attention twin agree on losses and Adam
# variance maxima within this relative error (fixed before the first run:
# fp32 on both sides, sums in another order, 8 small Adam steps)
PARITY_RTOL = 1e-4
# the flash run's and the plain-attention run's gradients of one batch from
# the same params, leaf by leaf: each within GRAD_RTOL x max |plain leaf|
# (fixed before the first run: fp32, 12 layers, sums in another order; a
# zeroed or mis-scaled dQ or dK/dV is off by the whole leaf)
GRAD_RTOL = 1e-4


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def call_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean CUDA-event time of one call over ``iters`` back-to-back calls
    after warm-up.  Where the host submits calls slower than the card runs
    them, this is the host's time per call."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, attempts: int = 3):
    """(device ms, {kernel name: device ms}) of the kernels ``fn`` runs,
    from a CUDA-only ``torch.profiler`` trace.  CUPTI now and then hands
    back a trace with no device activity at all; such a trace is taken
    again, and the run fails after ``attempts`` empty ones."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key: e.self_device_time_total / 1e3
                 for e in prof.key_averages() if e.self_device_time_total > 0}
        if names:
            return sum(names.values()), names
    raise RuntimeError(f"check failed: the profiler recorded no device time "
                       f"in {attempts} traces")


@functools.cache
def spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms of event time."""
    torch.cuda._sleep(1000)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    torch.cuda.synchronize()
    return 1e7 / start.elapsed_time(end)


def device_ms(fn, iters: int = 20, attempts: int = 3) -> float:
    """Device time of one call: CUDA-event time of ``iters`` back-to-back
    calls, over ``iters``.  The calls are queued behind a spin kernel that
    lasts longer than the host takes to issue them, so the card runs them
    without waiting for the host; the run fails if the card still caught up
    with the host (the start event done before the last call was issued)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for attempt in range(attempts):
        torch.cuda._sleep(int((3 * issue_ms + 20) * 4 ** attempt
                              * spin_cycles_per_ms()))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
    raise RuntimeError(f"check failed: the card caught up with the host in "
                       f"{attempts} timed runs")


def times(kernel, plain, library=None) -> dict:
    """``ms``, ``plain_ms``, ``library_ms``: device ms of one call of the
    kernel, its plain version and the library call (:func:`device_ms`;
    None where no one PyTorch call computes the same function).
    ``*call_ms``: CUDA-event ms per call of each with nothing queued ahead,
    which the host's rate of issue bounds where it is slower than the
    card."""
    lib = library is not None
    return {"ms": device_ms(kernel), "plain_ms": device_ms(plain, 10),
            "library_ms": device_ms(library) if lib else None,
            "call_ms": call_ms(kernel), "plain_call_ms": call_ms(plain, 10),
            "library_call_ms": call_ms(library) if lib else None}


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(least ms, what bounds it): the larger of bytes over the memory rate
    and operations over the peak rate for the input type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_tolerance(o: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per element: 2 bf16 ulps (8 significant bits) at the larger of |o|
    and |ref|, plus the fp32 tolerance, since both sides compute in fp32
    (and may differ by that much) before rounding to bf16."""
    mag = torch.maximum(o.abs(), ref.abs()).float().clamp_min(2.0 ** -126)
    return 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7) + 2e-5


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = {"name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    emit("device", **dev)
    return dev


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    kernels = {}
    for name, lib in libs.items():
        entry = None
        for line in lib.ptxas.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                kernels.setdefault(name, {})[entry] = {}
            elif entry and ("Used" in line or "spill" in line):
                kernels[name][entry]["info"] = (
                    kernels[name][entry].get("info", "") + line.strip(" :")
                    .replace("ptxas info    : ", "") + "; ")
    emit("build", seconds=round(time.perf_counter() - t0, 2),
         ptxas={n: {e: v.get("info", "") for e, v in ks.items()}
                for n, ks in kernels.items()})


def _attn_inputs(b, s, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b * H, s, D, device="cuda", generator=gen).to(dtype)
            for _ in range(3)]


def check_attention(q, k, v, what: str) -> list:
    """[o err, lse err] of the kernel against its plain version on the same
    inputs; fails unless fp32 ``o`` is within 2e-5 (bf16 ``o`` within
    :func:`bf16_tolerance`) and ``lse`` within 2e-5."""
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_fwd_plain)
    o, lse = flash_attention_fwd(q, k, v)
    ro, rlse = flash_attention_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs()
    lse_err = (lse - rlse).abs().max().item()
    if q.dtype == torch.float32:
        check(err.max().item() <= 2e-5, f"fa o {what}: {err.max().item()}")
    else:
        check(bool((err <= bf16_tolerance(o, ro)).all()), f"fa o {what}")
    check(lse_err <= 2e-5, f"fa lse {what}: {lse_err}")
    return [err.max().item(), lse_err]


# (B, S) at H=12: ragged tails, and the serving path's prefills of one
# request at each bucket of its ladder (256, 384, 512)
FA_SHAPES = ((1, 1), (4, 96), (4, 427), (2, 1024), (1, 256), (1, 384),
             (1, 512))


def phase_flash_attention() -> tuple:
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_fwd_plain)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, s in FA_SHAPES:
            key = f"{str(dtype)[6:]}_{b}x{s}"
            errs[key] = check_attention(*_attn_inputs(b, s, dtype, s), key)
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, s in ((8, 512), (1, 512)):
            key = f"{str(dtype)[6:]}_{b}x{s}"
            q, k, v = _attn_inputs(b, s, dtype, 1)
            q4, k4, v4 = (t.reshape(b, H, s, D) for t in (q, k, v))
            elt = q.element_size()
            nbytes = 4 * b * H * s * D * elt + b * H * s * 4
            t_bound, by = bound(nbytes, 2 * b * H * s * s * D, dtype)
            timing[key] = {
                "max_abs_err": check_attention(q, k, v, key)[0],
                **times(lambda: flash_attention_fwd(q, k, v),
                        lambda: flash_attention_fwd_plain(q, k, v),
                        lambda: F.scaled_dot_product_attention(
                            q4, k4, v4, is_causal=True)),
                "bound_ms": t_bound, "bound_by": by}
    emit("flash_attention_fwd", max_err=errs, timing=timing)
    return timing, set(FA_SHAPES)


def _decode_inputs(b, s, g, dtype, lengths, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, H, g, D, device="cuda", generator=gen).to(dtype)
    kc, vc = (torch.randn(b, s, H, D, device="cuda", generator=gen).to(dtype)
              for _ in range(2))
    return q, kc, vc, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def _decode_library(q, kc, vc, lengths):
    """One SDPA call over the same cache with a length mask (a yardstick)."""
    b, kvh, g, d = q.shape
    s = kc.shape[1]
    mask = (torch.arange(s, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    qh = q.reshape(b, kvh * g, 1, d)
    kh, vh = kc.transpose(1, 2), vc.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=g > 1)


def check_decode(q, kc, vc, lengths, what: str) -> list:
    """[normalised o err, relative o err, m err, relative l err] of the
    kernel's partials against its plain version on the same inputs (the
    partials are fp32 for either input type); fails unless each is within
    2e-5 and every empty slot gives (0, -1e30, 0)."""
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_fwd_plain)
    o, m, l = flash_decode_fwd(q, kc, vc, lengths)
    ro, rm, rl = flash_decode_fwd_plain(q, kc, vc, lengths)
    torch.cuda.synchronize()
    norm_err = (o / l[..., None].clamp_min(1e-30)
                - ro / rl[..., None].clamp_min(1e-30)).abs().max()
    rel = lambda a, r: ((a - r).abs() / r.abs().clamp_min(1.0)).max()
    e = [norm_err.item(), rel(o, ro).item(), (m - rm).abs().max().item(),
         rel(l, rl).item()]
    check(all(x <= 2e-5 for x in e), f"fd {what}: {e}")
    empty = lengths == 0
    check(bool((m[empty] == -1e30).all() and (l[empty] == 0).all()
               and (o[empty] == 0).all()), f"fd empty slot {what}")
    return e


def time_decode(q, kc, vc, lengths, what: str) -> dict:
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_fwd_plain)
    b, kvh, g, d = q.shape
    total = int(lengths.clamp(0, kc.shape[1]).sum())
    elt = q.element_size()
    nbytes = (2 * total * kvh * d * elt + q.numel() * elt + 4 * b
              + (q.numel() + 2 * b * kvh * g) * 4)
    t_bound, by = bound(nbytes, 4 * total * kvh * g * d, q.dtype)
    return {"max_abs_err": check_decode(q, kc, vc, lengths, what)[0],
            **times(lambda: flash_decode_fwd(q, kc, vc, lengths),
                    lambda: flash_decode_fwd_plain(q, kc, vc, lengths),
                    _decode_library(q, kc, vc, lengths)),
            "bound_ms": t_bound, "bound_by": by}


def phase_flash_decode(main_lengths, cache_len: int) -> tuple:
    """Checks the kernel on an edge-case cache of 1024 (G 1 and 4) and at
    the serving path's shapes: the fused step's 8 slots at
    ``main_lengths`` and a prompt's replay, one slot, both over
    ``cache_len``; times it at 1024 and on the fused step."""
    lengths = [0, 1, 127, 128, 1000, 1024, 600, 5]
    cases = [(8, 1024, g, lengths) for g in (1, 4)] + [
        (8, cache_len, 1, main_lengths), (1, cache_len, 1, [cache_len - 149])]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, s, g, ln) in enumerate(cases):
            key = f"{str(dtype)[6:]}_{b}x{s}_g{g}"
            errs[key] = check_decode(*_decode_inputs(b, s, g, dtype, ln, i),
                                     key)
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = f"{str(dtype)[6:]}_8x1024"
        timing[key] = time_decode(
            *_decode_inputs(8, 1024, 1, dtype, lengths, 3), key)
    timing["float32_main"] = time_decode(*_decode_inputs(
        8, cache_len, 1, torch.float32, main_lengths, 4), "float32_main")
    emit("flash_decode_fwd", max_err=errs, timing=timing)
    return timing, {(b, s) for b, s, g, _ in cases if g == 1}


def _serve(**kw):
    from repro_torch.launch.serve import serve_engine
    return serve_engine("gpt2-117m", use_reduced=False, n_slots=8,
                        prompt_len=PROMPT_LEN, gen_tokens=GEN, n_requests=16,
                        quiet=True, device="cuda", seed=SEED, **kw)


def phase_engine(dev: dict, fa_checked: set, fd_checked: set) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_decode import flash_decode_fwd
    from repro_torch.serve import prefill_split
    _serve()  # warm-up: cuBLAS handles, allocator, first-call costs
    flash_attention_fwd.launches = 0
    flash_decode_fwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = _serve()
    fa, fd = flash_attention_fwd.launches, flash_decode_fwd.launches
    eng, stats = out["engine"], out["stats"]
    n_layers = eng.model.cfg.n_layers
    ladder = eng.scheduler.ladder
    replay = sum(len(r.tokens) - prefill_split(len(r.tokens), ladder)
                 for r in out["requests"])
    check(fa == n_layers * len(out["requests"]),
          f"flash_attention_fwd launches {fa}")
    check(fd == n_layers * (stats.decode_steps + replay),
          f"flash_decode_fwd launches {fd} vs {n_layers} x "
          f"({stats.decode_steps} fused + {replay} replay)")
    check(all(r.n_generated == req.max_tokens and r.finish_reason == "length"
              for r, req in zip(out["results"], out["requests"])),
          "every request generated its budget")
    # every shape the path gave a kernel was held against its plain version
    # (one request per prefill call; fused steps over all slots, replay
    # over one row, both at the slot cache's length)
    prefills = {(1, prefill_split(len(r.tokens), ladder))
                for r in out["requests"]}
    decodes = {(eng.cfg.n_slots, eng.cfg.cache_len)} | (
        {(1, eng.cfg.cache_len)} if replay else set())
    check(prefills <= fa_checked, f"prefill shapes {prefills} not all "
                                  f"checked in {fa_checked}")
    check(decodes <= fd_checked, f"decode shapes {decodes} not all "
                                 f"checked in {fd_checked}")
    # a separate traced run gives the device's busy time; the untraced
    # run's wall time is the base of the idle share (tracing slows the host)
    busy, names = device_profile(_serve)
    wall = out["wall_s"] * 1e3
    top = {k[:60]: v for k, v in sorted(names.items(),
                                        key=lambda kv: -kv[1])[:6]}
    emit("engine", card=dev["nvidia_smi"], prefill_tok_s=out["prefill_tok_s"],
         decode_tok_s=out["decode_tok_s"], p50_ms=out["p50_s"] * 1e3,
         p95_ms=out["p95_s"] * 1e3, prefill_calls=len(out["requests"]),
         fused_steps=stats.decode_steps, replay_steps=replay,
         launches={"flash_attention_fwd": fa, "flash_decode_fwd": fd},
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         wall_ms=wall,
         traced_run={"device_busy_ms": busy,
                     "device_idle_share": 1 - busy / wall,
                     "top_kernels_ms": top})
    return {"out": out, "launches": {"flash_attention_fwd": fa,
                                     "flash_decode_fwd": fd}}


def _top2_gap(engine, request, tokens, j) -> float:
    """Gap between the two largest logits of the plain path before token j."""
    from repro_torch.serve.sampling import mask_vocab
    model, params = engine.model, engine.params
    seq = torch.tensor([list(request.tokens)], device="cuda")
    logits, cache = model.prefill(params, {"tokens": seq},
                                  cache_len=len(request.tokens) + j + 1)
    for t in tokens[:j]:
        logits, cache = model.decode(params, cache,
                                     torch.tensor([[t]], device="cuda"))
    top = mask_vocab(logits, model.cfg.vocab_size)[0].topk(2).values
    return float(top[0] - top[1])


def phase_parity(engine_out) -> None:
    out = engine_out["out"]
    plain = _serve(attn_backend="blockwise", decode_backend="reference")
    diverged, gaps = 0, []
    for req, a, b in zip(out["requests"], out["results"], plain["results"]):
        if a.tokens == b.tokens:
            continue
        diverged += 1
        j = next(i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                 if x != y)
        gaps.append(_top2_gap(plain["engine"], req, b.tokens, j))
        check(gaps[-1] < 1e-4, f"uid {req.uid} diverges at {j} with a top-2 "
                               f"logit gap of {gaps[-1]}")
    emit("parity", requests=len(out["requests"]), diverged=diverged,
         near_tie_gaps=gaps)


def check_attention_bwd(q, k, v, o, lse, do, what: str) -> list:
    """[dq, dk, dv max abs err] of the three backward kernels against their
    plain versions on the same inputs.  fp32: each within 1e-4 x max |plain|
    (another summation order over up to 1024 keys) plus 1e-5 absolute for
    entries that cancel to 0 (at S = 1, dq is 0 in exact arithmetic).  bf16
    outputs: that plus 2 bf16 ulps at the value, since both sides compute
    in fp32 and round once to bf16."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    errs = []
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        err = (a.float() - r.float()).abs()
        tol = 1e-4 * r.float().abs().max().item() + 1e-5
        if q.dtype == torch.bfloat16:
            tol = tol + bf16_tolerance(a, r) - 2e-5
        check(bool((err <= tol).all()), f"fa bwd {name} {what}: "
                                        f"{err.max().item()}")
        errs.append(err.max().item())
    return errs


def train_config(attn_backend: str = "flash"):
    from repro_torch.configs import (BatchWarmupConfig, OptimizerConfig,
                                     SLWConfig, TrainConfig, get_arch)
    tokens = TRAIN_STEPS * B_TRAIN * S_TRAIN
    return TrainConfig(
        model=get_arch("gpt2-117m").replace(attn_backend=attn_backend),
        optimizer=OptimizerConfig(
            lr=6e-4, schedule="token_cosine", warmup_steps=10,
            warmup_tokens=10 * B_TRAIN * S_TRAIN, total_steps=TRAIN_STEPS,
            total_tokens=tokens),
        slw=SLWConfig(enabled=True, pacing="linear", start_seq_len=8,
                      duration_steps=20, round_multiple=8, max_buckets=12),
        batch_warmup=BatchWarmupConfig(enabled=True, start_batch=8,
                                       warmup_tokens=tokens // 20),
        seq_len=S_TRAIN, global_batch=B_TRAIN, seed=SEED, remat="none",
        eval_interval=TRAIN_STEPS)


def _causal_pairs(bh: int, s: int) -> int:
    return bh * s * (s + 1) // 2


def _bwd_bounds(bh: int, s: int) -> dict:
    """(least ms, what bounds it) of each backward kernel and of all three,
    fp32, causal over the whole length: each input read once and each
    output written once; 2 D operations per (query, key) pair below the
    diagonal for each product a kernel does (dQ kernel: S, dP, dQ; dK/dV
    kernel: S, dP, dV, dK; five distinct)."""
    row, tile = bh * s * 4, bh * s * D * 4
    pair_ops = 2 * D * _causal_pairs(bh, s)
    f32 = torch.float32
    return {"preprocess": bound(2 * tile + row, 2 * bh * s * D, f32),
            "dq": bound(5 * tile + 2 * row, 3 * pair_ops, f32),
            "dkv": bound(6 * tile + 2 * row, 4 * pair_ops, f32),
            "all": bound(8 * tile + row, 5 * pair_ops + 2 * bh * s * D, f32)}


def phase_flash_attention_bwd(shapes) -> tuple:
    """Holds the forward and the three backward kernels against their plain
    versions at every (B, S) of ``shapes`` (the training run's, at H = 12)
    in fp32, plus ragged S = 1 and 427 in fp32 and bf16; times them at
    (16, 1024) fp32."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd, flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
        flash_attention_bwd_dq_plain, flash_attention_bwd_plain,
        flash_attention_bwd_preprocess,
        flash_attention_bwd_preprocess_plain, flash_attention_fwd,
        flash_attention_fwd_plain)
    cases = [(torch.float32, b, s) for b, s in sorted(shapes)] + [
        (dt, 4, s) for dt in (torch.float32, torch.bfloat16) for s in (1, 427)]
    errs = {}
    for i, (dtype, b, s) in enumerate(cases):
        key = f"{str(dtype)[6:]}_{b}x{s}"
        q, k, v = _attn_inputs(b, s, dtype, 1000 + i)
        do = _attn_inputs(b, s, dtype, 2000 + i)[0]
        check_attention(q, k, v, key)
        o, lse = flash_attention_fwd(q, k, v)
        errs[key] = check_attention_bwd(q, k, v, o, lse, do, key)

    bh, s = B_TRAIN * H, S_TRAIN
    q, k, v = _attn_inputs(B_TRAIN, s, torch.float32, 1)
    do = _attn_inputs(B_TRAIN, s, torch.float32, 2)[0]
    o, lse = flash_attention_fwd(q, k, v)
    delta = flash_attention_bwd_preprocess(o, do)
    err = dict(zip(("dq", "dk", "dv"),
                   check_attention_bwd(q, k, v, o, lse, do, "timed")))
    bounds = _bwd_bounds(bh, s)
    q4, k4, v4 = (t.reshape(B_TRAIN, H, s, D).clone().requires_grad_()
                  for t in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.reshape(B_TRAIN, H, s, D)
    sdpa_bwd = lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                           retain_graph=True)
    rest = (do, lse, delta)
    timing = {
        "preprocess": {
            "max_abs_err": (delta - flash_attention_bwd_preprocess_plain(
                o, do)).abs().max().item(),
            **times(lambda: flash_attention_bwd_preprocess(o, do),
                    lambda: flash_attention_bwd_preprocess_plain(o, do),
                    lambda: torch.linalg.vecdot(o, do))},
        "dq": {"max_abs_err": err["dq"],
               **times(lambda: flash_attention_bwd_dq(q, k, v, *rest),
                       lambda: flash_attention_bwd_dq_plain(q, k, v, *rest))},
        "dkv": {"max_abs_err": max(err["dk"], err["dv"]),
                **times(lambda: flash_attention_bwd_dkv(q, k, v, *rest),
                        lambda: flash_attention_bwd_dkv_plain(q, k, v,
                                                              *rest))},
        "all": {"max_abs_err": max(err.values()),
                **times(lambda: flash_attention_bwd(q, k, v, o, lse, do),
                        lambda: flash_attention_bwd_plain(q, k, v, o, lse,
                                                          do), sdpa_bwd)},
        "fwd": {"max_abs_err": check_attention(q, k, v, "timed fwd")[0],
                **times(lambda: flash_attention_fwd(q, k, v),
                        lambda: flash_attention_fwd_plain(q, k, v),
                        lambda: F.scaled_dot_product_attention(
                            q4, k4, v4, is_causal=True))},
    }
    check(timing["preprocess"]["max_abs_err"] <= 1e-4, "fa bwd delta")
    # SDPA's backward is one call for all three kernels: the dQ and dK/dV
    # entries carry its time, marked as covering the whole backward
    for name in ("dq", "dkv"):
        timing[name].update(library_ms=timing["all"]["library_ms"],
                            library_call_ms=timing["all"]["library_call_ms"],
                            library_covers="all three backward kernels")
    for name, (t_bound, by) in bounds.items():
        timing[name].update(bound_ms=t_bound, bound_by=by)
    fwd_bytes = 4 * bh * s * D * 4 + bh * s * 4
    timing["fwd"].update(zip(("bound_ms", "bound_by"), bound(
        fwd_bytes, 4 * D * _causal_pairs(bh, s), torch.float32)))
    emit("flash_attention_bwd", max_err=errs, timing=timing,
         shape=f"B={B_TRAIN} H={H} S={s} D={D} float32")
    return timing, {(b, s) for dt, b, s in cases if dt == torch.float32}


def _fa_kernels():
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_bwd_preprocess, flash_attention_fwd)
    return {"flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd_preprocess": flash_attention_bwd_preprocess,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv}


def _clone_state(state):
    from repro_torch.optim.transforms import tree_map
    return tree_map(lambda t: t.detach().clone(), state)


def phase_train(dev: dict, checked: set) -> dict:
    """Trains full-width gpt2-117m (random weights from SEED) through the
    Trainer: 30 SLW steps and one full-length eval, then 3 more
    full-length steps untraced and 3 under the profiler."""
    from repro_torch.core.regulators import predict_trajectory
    from repro_torch.launch.train import Trainer
    tc = train_config()
    trainer = Trainer(tc, eval_batch=EVAL_BATCH, device="cuda")
    init = _clone_state(trainer.state)
    kernels = _fa_kernels()
    for f in kernels.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = trainer.run()
    launches = {name: f.launches for name, f in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    n_layers = tc.model.n_layers

    check(res.steps == TRAIN_STEPS and not res.diverged, "trained 30 steps")
    check(all(math.isfinite(x) for x in res.loss_history), "finite losses")
    plans = [(p.seq_len, p.batch_size, p.lr)
             for p in predict_trajectory(tc, TRAIN_STEPS)]
    ran = list(zip(res.seqlen_history, res.batch_history, res.lr_history))
    check(ran == plans, "the executed plans are predict_trajectory's")
    n_evals = len(res.val_ppl_history)
    check(n_evals == 1, f"{n_evals} evals")
    want = {name: n_layers * TRAIN_STEPS for name in kernels}
    want["flash_attention_fwd"] += n_layers * n_evals
    check(launches == want, f"launches {launches} != {want}")
    shapes = {(b, s) for s, b, _ in plans} | {(EVAL_BATCH, S_TRAIN)}
    check(shapes <= checked, f"shapes {shapes - checked} not checked")

    full = [i for i, s in enumerate(res.seqlen_history) if s == S_TRAIN]
    durations = trainer.watchdog.durations
    check(len(durations) == TRAIN_STEPS, "one duration per step")
    full_s = [durations[i] for i in full]
    full_tokens = sum(res.batch_history[i] * S_TRAIN for i in full)

    def steps3():
        for _ in range(3):
            trainer.run_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps3()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, names = device_profile(steps3)
    top = {k[:60]: v for k, v in sorted(names.items(),
                                        key=lambda kv: -kv[1])[:8]}
    emit("train", card=dev["nvidia_smi"], steps=res.steps,
         tokens=res.tokens, full_length_steps=len(full),
         tokens_per_s_full_length=full_tokens / sum(full_s),
         p50_step_ms_full_length=float(np.median(full_s)) * 1e3,
         first_loss=res.loss_history[0], last_loss=res.loss_history[-1],
         val_ppl=res.val_ppl_history, n_compiles=res.n_compiles,
         launches=launches, max_memory_allocated=peak,
         wall_s=res.wall_time_s,
         traced_3_full_steps={"wall_ms_untraced": wall,
                              "device_busy_ms": busy,
                              "device_idle_share": 1 - busy / wall,
                              "top_kernels_ms": top})
    return {"init": init, "result": res, "launches": launches}


def _leaf_names(tree, prefix: str = "") -> list:
    """Names of the leaves of a param tree, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in _leaf_names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _grads(model, params, batch) -> list:
    from repro_torch.optim.transforms import tree_leaves, tree_unflatten
    leaves = [t.detach().clone().requires_grad_()
              for t in tree_leaves(params)]
    loss, _ = model.loss(tree_unflatten(params, leaves), batch)
    return list(torch.autograd.grad(loss, leaves))


def compare_grads(flash_model, plain_model, params, batch) -> dict:
    """Every gradient leaf of the flash model against the plain model's on
    the same params and batch: {leaf name: max abs err / max |plain|}.
    Fails if a leaf is off by more than GRAD_RTOL of its largest entry, or
    if an attention projection gets no gradient."""
    got = _grads(flash_model, params, batch)
    ref = _grads(plain_model, params, batch)
    rel = {}
    for name, a, r in zip(_leaf_names(params), got, ref):
        scale = r.abs().max().item()
        if ".attn." in name:
            check(scale > 0, f"no gradient reaches {name}")
        rel[name] = (a - r).abs().max().item() / scale
        check(rel[name] <= GRAD_RTOL, f"gradient {name}: {rel[name]}")
    return rel


def phase_train_parity(train: dict) -> None:
    """The same config with plain blockwise attention, from the same
    initial state: the gradients of the first step's batch and of a
    full-length batch leaf by leaf, then the first PARITY_STEPS steps, on
    the same card."""
    from repro_torch.core.regulators import predict_trajectory
    from repro_torch.launch.train import Trainer
    from repro_torch.models import model_zoo
    tc = train_config("blockwise")
    trainer = Trainer(tc, eval_batch=EVAL_BATCH, device="cuda")
    trainer.state = train["init"]
    kernels = _fa_kernels()
    flash_model = model_zoo.build_model(train_config().model, remat=tc.remat)
    plans = predict_trajectory(tc, TRAIN_STEPS)
    grads = {}
    for i in (0, TRAIN_STEPS - 1):
        batch, _ = trainer.stack.apply(trainer.pipeline.batch_at(i), plans[i])
        rel = compare_grads(flash_model, trainer.model,
                            train["init"]["params"], trainer.to_device(batch))
        attn = {kind: max(v for k, v in rel.items() if k.endswith(kind))
                for kind in ("wq", "wk", "wv", "wo")}
        grads[f"{plans[i].batch_size}x{plans[i].seq_len}"] = {
            "max_rel_err": max(rel.values()),
            "worst_leaf": max(rel, key=rel.get), "attn_max_rel_err": attn}
        torch.cuda.empty_cache()
    emit("train_grads", leaves=len(rel), rtol=GRAD_RTOL, batches=grads)
    before = {name: f.launches for name, f in kernels.items()}
    plain = trainer.run(max_steps=PARITY_STEPS)
    check({name: f.launches for name, f in kernels.items()} == before,
          "the blockwise run launched a flash-attention kernel")
    ref = train["result"]
    n = PARITY_STEPS
    check(plain.seqlen_history == ref.seqlen_history[:n]
          and plain.batch_history == ref.batch_history[:n]
          and plain.lr_history == ref.lr_history[:n], "parity plans")
    rel = {}
    for key in ("loss_history", "var_max_history"):
        a = np.asarray(getattr(ref, key)[:n])
        b = np.asarray(getattr(plain, key))
        rel[key] = float(np.max(np.abs(a - b) / np.abs(b)))
        check(rel[key] <= PARITY_RTOL, f"parity {key}: {rel[key]}")
    emit("train_parity", steps=n, max_rel_err=rel, rtol=PARITY_RTOL,
         seqlens=plain.seqlen_history, batches=plain.batch_history)


def main() -> int:
    dev = phase_device()
    phase_build()
    fa_timing, fa_checked = phase_flash_attention()
    from repro_torch.launch.serve import make_requests
    from repro_torch.configs import get_arch
    # main-path decode lengths: the first 8 requests mid-generation, in the
    # slot cache of prompt_len + gen_tokens that _serve gives the engine
    main_lengths = [len(r.tokens) + r.max_tokens // 2 for r in make_requests(
        get_arch("gpt2-117m"), 8, PROMPT_LEN, GEN, seed=SEED)]
    fd_timing, fd_checked = phase_flash_decode(main_lengths, PROMPT_LEN + GEN)
    engine = phase_engine(dev, fa_checked, fd_checked)
    phase_parity(engine)
    serve_launches = engine["launches"]
    del engine
    torch.cuda.empty_cache()

    from repro_torch.core.regulators import predict_trajectory
    train_shapes = {(p.batch_size, p.seq_len) for p in predict_trajectory(
        train_config(), TRAIN_STEPS)} | {(EVAL_BATCH, S_TRAIN)}
    bwd_timing, bwd_checked = phase_flash_attention_bwd(train_shapes)
    train = phase_train(dev, bwd_checked)
    phase_train_parity(train)

    src = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/"
    by_path = {"serve": serve_launches, "train": train["launches"]}
    rows = [("flash_attention_fwd", "flash_attention_fwd.cu",
             "flash_attention/kernel.py:168", fa_timing["float32_1x512"]),
            ("flash_attention_bwd_preprocess", "flash_attention_bwd.cu",
             "flash_attention/kernel.py:310", bwd_timing["preprocess"]),
            ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
             "flash_attention/kernel.py:326", bwd_timing["dq"]),
            ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
             "flash_attention/kernel.py:348", bwd_timing["dkv"]),
            ("flash_decode_fwd", "flash_decode.cu",
             "flash_decode/kernel.py:109", fd_timing["float32_main"])]
    entries = []
    for name, source, rep, t in rows:
        counts = {path: c[name] for path, c in by_path.items() if name in c}
        entries.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": ref + rep,
                        "launches": sum(counts.values()),
                        "launches_by_path": counts, **t})
    print(json.dumps({"kernels": entries}), flush=True)
    print(dev["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
