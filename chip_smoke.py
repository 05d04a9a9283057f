#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` from this
checkout, holds each against its plain PyTorch version, serves
full-width GPT-2 117M (random weights from a seed) through
``repro_torch.launch.serve.serve_engine``, checks that the serving path
launched both kernels the expected number of times, and checks its greedy
token streams against the plain (no custom kernel) path on the same card.
Phases print one line each.  The second-to-last line lists each kernel
with its error, times and bound; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the run
exits non-zero and prints no result.  Imports nothing of JAX or of the
JAX package ``repro``.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

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


def times(kernel, plain, library) -> dict:
    """``ms``, ``plain_ms``, ``library_ms``: device ms of one call of the
    kernel, its plain version and the library call (:func:`device_ms`).
    ``*call_ms``: CUDA-event ms per call of each with nothing queued ahead,
    which the host's rate of issue bounds where it is slower than the
    card."""
    return {"ms": device_ms(kernel), "plain_ms": device_ms(plain, 10),
            "library_ms": device_ms(library), "call_ms": call_ms(kernel),
            "plain_call_ms": call_ms(plain, 10),
            "library_call_ms": call_ms(library)}


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
    src = "src/repro_torch/kernels/csrc/"
    rows = [("flash_attention_fwd", src + "flash_attention_fwd.cu",
             "src/repro/kernels/flash_attention/kernel.py:168",
             fa_timing["float32_1x512"]),
            ("flash_decode_fwd", src + "flash_decode.cu",
             "src/repro/kernels/flash_decode/kernel.py:109",
             fd_timing["float32_main"])]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": rep,
         "launches": engine["launches"][name], **t}
        for name, source, rep, t in rows]}), flush=True)
    print(dev["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
