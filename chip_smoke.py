#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` from this
checkout, reads the registers, spills and tensor-core (HMMA) instructions
of the flash-attention kernels from ``-Xptxas -v`` and their SASS, holds
each kernel against its plain PyTorch version at every shape its path
gives it, then drives the port's paths at full width with random
weights from a seed:

* serving: GPT-2 117M through ``repro_torch.launch.serve.serve_engine``,
  checking that it launched the forward flash-attention and flash-decode
  kernels the expected number of times and that its greedy token streams
  equal the plain (no custom kernel) path's on the same card;
* paged serving: the same 16 requests from a pool of 48 pages of 64
  tokens (two thirds of the dense cache), checking that admission waited
  for pages, that the paged and dense decode kernels launched 12 x fused
  and 12 x replay steps, that every page came back, and that each greedy
  stream is the dense engine's;
* the router: a paged and a dense replica under two admission policies
  (32 requests), a prefill/decode role split, and one live slot migration
  each way between dense and paged replicas, all on the one card, each
  greedy stream the single dense engine's;
* training: GPT-2 117M for 30 steps of sequence-length warmup through
  ``repro_torch.launch.train.Trainer``, checking finite losses, the plans
  of ``predict_trajectory``, the launch counts of the forward and the three
  backward flash-attention kernels, every gradient leaf of two batches and
  the first 8 steps against the same run with plain attention on the same
  card; the flash-attention forward and backward also in bf16 at the
  training shape (against SDPA's bf16 calls), two backward runs bit for
  bit, and one loss and backward of gpt2-117m with bf16 params through
  the kernels' bf16 instances against the blockwise backend;
* RWKV-6: the WKV-6 forward and backward kernels against their plain
  versions (and the backward against autograd through the plain forward)
  at every shape the RWKV paths give them, then full-depth, full-width
  rwkv6-7b served from 8 slots (launch counts, greedy streams against the
  plain reference backend, the router with a paged replica and a
  migration each way), and rwkv6-7b at full width cut to 4 layers trained
  for 20 SLW steps (finite losses, the plans of ``predict_trajectory``,
  launch counts, every gradient leaf of two batches and the first 8
  steps' losses against the reference backend, and a planted fault in
  the backward that the gradient check must catch).  Their weights are drawn
  on the card from a CUDA generator;
* Zamba-2: flash-decode at head dim 80 (dense and paged), the SSD forward
  and backward kernels against their plain versions (the backward through
  the autograd Function's reductions, against the plain reverse scan and
  against autograd through the plain forward) at every shape the zamba
  paths give them, cum past -1000 included; then full-depth, full-width
  zamba2-2.7b served from 8 slots (launch counts, greedy streams against
  the plain reference backends, the router with a replica whose shared
  attention KV really lives in pages, and a migration each way), and
  trained at full depth with remat "full" for 20 SLW steps (finite
  losses, plans, launch counts, every gradient leaf of two batches and 8
  steps' losses against the reference SSD backend, and a planted fault in
  the backward that the gradient check must catch).

Phases print one line each.  The second-to-last line lists each kernel
with its error, times and bound; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the run
exits non-zero and prints no result.  Imports nothing of JAX or of the
JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import re
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
TF32_FLOPS = 495e12  # dense TF32 on the tensor cores
H, D = 12, 64  # gpt2-117m heads and head dim
ZAMBA_H, ZAMBA_D = 32, 80  # zamba2-2.7b's shared attention block
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


START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase line, with the seconds since the run started."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - START}), flush=True)


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
    from a CUDA-only ``torch.profiler`` trace: the durations of its device
    events, summed by name from the trace's kineto events (the numbers
    ``key_averages()`` gives, without the Python event tree it builds,
    which took 58 s for a gpt2 engine run's ~400,000 kernels on the H100).
    CUPTI now and then hands back a trace with no device activity at all;
    such a trace is taken again, and the run fails after ``attempts`` empty
    ones."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda and e.duration_ns() > 0:
                ms = e.duration_ns() / 1e6
                names[e.name()] = names.get(e.name(), 0.0) + ms
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


def times(kernel, plain, library=None, plain_queued: bool = True) -> dict:
    """``ms``, ``plain_ms``, ``library_ms``: device ms of one call of the
    kernel, its plain version and the library call (:func:`device_ms`;
    None where no one PyTorch call computes the same function).
    ``*call_ms``: CUDA-event ms per call of each with nothing queued ahead,
    which the host's rate of issue bounds where it is slower than the
    card.  With ``plain_queued`` False the plain version is timed by
    :func:`call_ms` alone: one that makes hundreds of launches a call fills
    the card's launch queue behind the spin kernel, so the host waits for
    the card; its large operations keep the card the slower side."""
    lib = library is not None
    plain_call = call_ms(plain, 10 if plain_queued else 3,
                         5 if plain_queued else 1)
    return {"ms": device_ms(kernel),
            "plain_ms": device_ms(plain, 10) if plain_queued else plain_call,
            "library_ms": device_ms(library) if lib else None,
            "call_ms": call_ms(kernel), "plain_call_ms": plain_call,
            "library_call_ms": call_ms(library) if lib else None}


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(least ms, what bounds it): the larger of bytes over the memory rate
    and operations over the peak rate for the input type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tc_bound(nbytes: float, flops: float) -> tuple:
    """:func:`bound` of fp32 work that runs on the tensor cores as three
    TF32 products (error-compensated TF32, the flash-attention kernels)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 3 * flops / TF32_FLOPS * 1e3
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


def phase_build() -> dict:
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
    ptxas = {n: {e: v.get("info", "") for e, v in ks.items()}
             for n, ks in kernels.items()}
    emit("build", seconds=round(time.perf_counter() - t0, 2), ptxas=ptxas)
    return {"libs": libs, "ptxas": ptxas}


# the kernels redesigned for the tensor cores, by the name in their source;
# HMMA is the SASS opcode of mma.sync (HMMA.1688.F32.TF32, .16816.F32.BF16)
HMMA = re.compile(r"HMMA[.\w]*")
FA_TENSOR_CORE_KERNELS = {"flash_attention_fwd": ("flash_fwd_kernel",),
                          "flash_attention_bwd": ("bwd_dq_kernel",
                                                  "bwd_dkv_kernel")}


def _sass_functions(lib: Path) -> dict:
    """{mangled function name: [SASS lines]} of a built library, from
    ``cuobjdump -sass``."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def _instance(mangled: str, kernel: str) -> str:
    """``kernel<f32|bf16, D>`` from a mangled template instance name."""
    d = "128" if "Li128E" in mangled else "64"
    return f"{kernel}<{'bf16' if 'bfloat16' in mangled else 'f32'},{d}>"


def phase_fa_design(build: dict) -> dict:
    """Each instance of the flash-attention kernels redesigned for the
    tensor cores: the registers and spills ``-Xptxas -v`` reported and the
    tensor-core (HMMA) instructions in its SASS.  Fails if one has none,
    or if its SASS cannot be read."""
    found = {}
    for lib_name, kernels in FA_TENSOR_CORE_KERNELS.items():
        funcs = _sass_functions(build["libs"][lib_name].path)
        info = build["ptxas"].get(lib_name, {})
        for mangled, lines in funcs.items():
            kernel = next((k for k in kernels if k in mangled), None)
            if kernel is None:
                continue
            hmma = [m.group(0) for m in map(HMMA.search, lines) if m]
            found[_instance(mangled, kernel)] = {
                "hmma": len(hmma), "hmma_kinds": sorted(set(hmma)),
                "ptxas": info.get(mangled, "not captured (library prebuilt)")}
    want = {f"{k}<{t},{d}>" for ks in FA_TENSOR_CORE_KERNELS.values()
            for k in ks for t in ("f32", "bf16") for d in (64, 128)}
    check(set(found) == want, f"kernel instances {sorted(found)} != "
                              f"{sorted(want)}")
    for name, v in found.items():
        check(v["hmma"] > 0, f"{name}: no tensor-core instruction in SASS")
    emit("fa_design", kernels=found)
    return found


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
            flops = 2 * b * H * s * s * D
            t_bound, by = (tc_bound(nbytes, flops) if dtype == torch.float32
                           else bound(nbytes, flops, dtype))
            timing[key] = {
                "max_abs_err": check_attention(q, k, v, key)[0],
                **times(lambda: flash_attention_fwd(q, k, v),
                        lambda: flash_attention_fwd_plain(q, k, v),
                        lambda: F.scaled_dot_product_attention(
                            q4, k4, v4, is_causal=True)),
                "bound_ms": t_bound, "bound_by": by}
            if dtype == torch.float32:  # the same work on the CUDA cores
                timing[key]["cuda_core_bound_ms"] = bound(nbytes, flops,
                                                          dtype)[0]
    emit("flash_attention_fwd", max_err=errs, timing=timing)
    return timing, set(FA_SHAPES)


def _decode_inputs(b, s, g, dtype, lengths, seed, h=H, d=D):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, g, d, device="cuda", generator=gen).to(dtype)
    kc, vc = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
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


def check_partials(got, ref, lengths, what: str) -> list:
    """[normalised o err, relative o err, m err, relative l err] of a
    decode kernel's partials against its plain version's on the same
    inputs (fp32 for either input type); fails unless each is within 2e-5
    and every empty slot gives (0, -1e30, 0)."""
    torch.cuda.synchronize()
    (o, m, l), (ro, rm, rl) = got, ref
    norm_err = (o / l[..., None].clamp_min(1e-30)
                - ro / rl[..., None].clamp_min(1e-30)).abs().max()
    rel = lambda a, r: ((a - r).abs() / r.abs().clamp_min(1.0)).max()
    e = [norm_err.item(), rel(o, ro).item(), (m - rm).abs().max().item(),
         rel(l, rl).item()]
    check(all(x <= 2e-5 for x in e), f"{what}: {e}")
    empty = lengths == 0
    check(bool((m[empty] == -1e30).all() and (l[empty] == 0).all()
               and (o[empty] == 0).all()), f"empty slot {what}")
    return e


def check_decode(q, kc, vc, lengths, what: str) -> list:
    """:func:`check_partials` of the dense decode kernel."""
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_fwd_plain)
    return check_partials(flash_decode_fwd(q, kc, vc, lengths),
                          flash_decode_fwd_plain(q, kc, vc, lengths),
                          lengths, f"fd {what}")


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
    ``cache_len``; the same at zamba2's head dim 80 (32 heads, G 1), with
    a ragged set of lengths off multiples of 32 besides.  Times it at 1024,
    on the fused step, and on zamba2's fused step."""
    lengths = [0, 1, 127, 128, 1000, 1024, 600, 5]
    cases = [(8, 1024, g, lengths) for g in (1, 4)] + [
        (8, cache_len, 1, main_lengths), (1, cache_len, 1, [cache_len - 149])]
    zamba = [(8, cache_len, main_lengths), (1, cache_len, [cache_len - 149]),
             (8, cache_len, [0, 1, 31, 129, cache_len, 300, 545, 77])]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, s, g, ln) in enumerate(cases):
            key = f"{str(dtype)[6:]}_{b}x{s}_g{g}"
            errs[key] = check_decode(*_decode_inputs(b, s, g, dtype, ln, i),
                                     key)
        for i, (b, s, ln) in enumerate(zamba):
            key = f"{str(dtype)[6:]}_{b}x{s}_d80_{i}"
            errs[key] = check_decode(*_decode_inputs(
                b, s, 1, dtype, ln, 20 + i, ZAMBA_H, ZAMBA_D), key)
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = f"{str(dtype)[6:]}_8x1024"
        timing[key] = time_decode(
            *_decode_inputs(8, 1024, 1, dtype, lengths, 3), key)
    timing["float32_main"] = time_decode(*_decode_inputs(
        8, cache_len, 1, torch.float32, main_lengths, 4), "float32_main")
    timing["float32_zamba_main"] = time_decode(*_decode_inputs(
        8, cache_len, 1, torch.float32, main_lengths, 5, ZAMBA_H, ZAMBA_D),
        "float32_zamba_main")
    emit("flash_decode_fwd", max_err=errs, timing=timing)
    return timing, ({(b, s, D) for b, s, g, _ in cases if g == 1}
                    | {(b, s, ZAMBA_D) for b, s, _ in zamba})


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
    decodes = {(eng.cfg.n_slots, eng.cfg.cache_len, D)} | (
        {(1, eng.cfg.cache_len, D)} if replay else set())
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


def check_streams(reqs, results, plain_results, plain_engine,
                  what: str) -> tuple:
    """(diverged, gaps): each greedy stream must equal the plain path's,
    or leave it only at a near tie, a top-2 logit gap under 1e-4 there."""
    diverged, gaps = 0, []
    for req, a, b in zip(reqs, results, plain_results):
        if a.tokens == b.tokens:
            continue
        diverged += 1
        j = next(i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                 if x != y)
        gaps.append(_top2_gap(plain_engine, req, b.tokens, j))
        check(gaps[-1] < 1e-4, f"{what} uid {req.uid} diverges at {j} with "
                               f"a top-2 logit gap of {gaps[-1]}")
    return diverged, gaps


def phase_parity(engine_out) -> None:
    out = engine_out["out"]
    plain = _serve(attn_backend="blockwise", decode_backend="reference")
    diverged, gaps = check_streams(out["requests"], out["results"],
                                   plain["results"], plain["engine"], "gpt2")
    emit("parity", requests=len(out["requests"]), diverged=diverged,
         near_tie_gaps=gaps)


# the paged serving path: pages of 64 tokens, a pool of 48 pages, two
# thirds of the dense-equivalent 8 slots x 9 pages of the 576-token cache
PAGE_SIZE, N_PAGES = 64, 48


def _paged_inputs(lengths, ps, max_pages, n_pages, g, dtype, seed,
                  holes=(), h=H, d=D):
    """q (B, h, g, d); k and v pools (n_pages, ps, h, d), each one
    layer of a stacked (2, n_pages, ...) pool as the engine passes them;
    a table with each row's pages drawn from a shuffled pool (slot 0 need
    not own page 0), ``-1`` past them, and ``-1`` at each (row, page) of
    ``holes``; lengths (B,) int32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = len(lengths)
    q = torch.randn(b, h, g, d, device="cuda", generator=gen).to(dtype)
    k, v = (torch.randn(2, n_pages, ps, h, d, device="cuda",
                        generator=gen).to(dtype)[1] for _ in range(2))
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(
        seed)).tolist()
    table = torch.full((b, max_pages), -1, dtype=torch.int32)
    for i, ln in enumerate(lengths):
        for j in range(-(-ln // ps)):
            table[i, j] = perm.pop()
    for i, j in holes:
        table[i, j] = -1
    return (q, k, v, table.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def check_paged(q, k, v, table, lengths, what: str) -> list:
    """:func:`check_partials` of the paged decode kernel; its plain version
    gathers the pages, then runs the dense plain version."""
    from repro_torch.kernels.flash_decode import (
        flash_decode_paged_fwd, flash_decode_paged_fwd_plain)
    return check_partials(
        flash_decode_paged_fwd(q, k, v, table, lengths),
        flash_decode_paged_fwd_plain(q, k, v, table, lengths), lengths,
        f"paged {what}")


def _owned_rows(table, lengths, ps) -> int:
    """Cache rows the paged kernel reads: keys j < lengths[b] whose page
    ``table[b, j // ps]`` is owned."""
    cols = torch.arange(table.shape[1] * ps, device=table.device)
    owned = table[:, cols // ps] >= 0
    return int((owned & (cols[None, :] < lengths[:, None].long())).sum())


def time_paged(q, k, v, table, lengths, what: str) -> dict:
    """Kernel, plain and library times at one shape, and the dense kernel
    over the same rows gathered into a (B, max_pages x ps) cache.  The
    library call is SDPA over that gathered cache; the gather runs before
    the timing."""
    from repro_torch.kernels.flash_decode import (
        flash_decode_fwd, flash_decode_paged_fwd,
        flash_decode_paged_fwd_plain, gather_pages)
    b, kvh, g, d = q.shape
    ps = k.shape[1]
    rows = _owned_rows(table, lengths, ps)
    elt = q.element_size()
    nbytes = (2 * rows * kvh * d * elt + table.numel() * 4
              + q.numel() * elt + 4 * b + (q.numel() + 2 * b * kvh * g) * 4)
    t_bound, by = bound(nbytes, 4 * rows * kvh * g * d, q.dtype)
    kc, vc = gather_pages(k, table), gather_pages(v, table)
    return {"max_abs_err": check_paged(q, k, v, table, lengths, what)[0],
            **times(lambda: flash_decode_paged_fwd(q, k, v, table, lengths),
                    lambda: flash_decode_paged_fwd_plain(q, k, v, table,
                                                         lengths),
                    _decode_library(q, kc, vc, lengths)),
            "library_covers": "SDPA over the pages gathered into a dense "
                              "cache before the timing (gather not timed)",
            "dense_kernel_ms": device_ms(
                lambda: flash_decode_fwd(q, kc, vc, lengths)),
            "owned_rows": rows, "bound_ms": t_bound, "bound_by": by}


def paged_main_lengths(main_lengths) -> tuple:
    """(lengths, free slots) of a fused step on the paged path: the dense
    path's mid-generation lengths, slot by slot until one's pages do not
    fit in the pool, then free slots (length 1, pos 0 plus the step's own
    token, and no page)."""
    out, used, full = [], 0, False
    for ln in main_lengths:
        need = -(-ln // PAGE_SIZE)
        full = full or used + need > N_PAGES
        out.append(1 if full else ln)
        used += 0 if full else need
    return out, [i for i, ln in enumerate(out) if ln == 1]


def phase_flash_decode_paged(main_lengths, cache_len: int) -> tuple:
    """Holds the paged kernel against its plain version in fp32 and bf16,
    page sizes 16 and 64, G 1 and 4, over lengths 0, 1, one page, one past
    a page and the full table, with -1 inside rows (past the length and
    inside it) and at their tails, and at the paged engine's shape: 8
    slots, 9 pages of 64, a pool of 48.  Times the engine's shape."""
    errs, checked = {}, set()
    for dtype in (torch.float32, torch.bfloat16):
        for ps in (16, 64):
            mp = -(-cache_len // ps)
            lengths = [0, 1, ps, ps + 1, mp * ps, 2 * ps + 5, 1, 2 * ps]
            for g in (1, 4):
                key = f"{str(dtype)[6:]}_ps{ps}_g{g}"
                # row 5: a hole inside its length; row 6: no page at all;
                # row 7: a hole past its length, then an owned page
                q, k, v, table, lens = _paged_inputs(
                    lengths, ps, mp, 64, g, dtype, ps + g,
                    holes=[(5, 1), (6, 0)])
                table[7, 3] = table[4, 0]  # shared page id past row 7's end
                errs[key] = check_paged(q, k, v, table, lens, key)
                if dtype == torch.float32 and g == 1:
                    checked.add((len(lengths), mp, ps, 64, D))
        # zamba2's head dim 80, G 1, pages of 64: the edge lengths, holes
        # and a shared page id as above, and lengths off multiples of 32
        ps = PAGE_SIZE
        mp = -(-cache_len // ps)
        for i, lengths in enumerate((
                [0, 1, ps, ps + 1, mp * ps, 2 * ps + 5, 1, 2 * ps],
                [min(n, mp * ps) for n in (31, 129, 300, 545, 77, 1, 250,
                                           200)])):
            key = f"{str(dtype)[6:]}_ps64_d80_{i}"
            q, k, v, table, lens = _paged_inputs(
                lengths, ps, mp, 8 * mp, 1, dtype, 30 + i,
                holes=[(5, 1), (6, 0)] if i == 0 else [], h=ZAMBA_H,
                d=ZAMBA_D)
            if i == 0:
                table[7, 3] = table[4, 0]
            errs[key] = check_paged(q, k, v, table, lens, key)
    lengths, free = paged_main_lengths(main_lengths)
    mp = -(-cache_len // PAGE_SIZE)
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = f"{str(dtype)[6:]}_main"
        args = _paged_inputs(lengths, PAGE_SIZE, mp, N_PAGES, 1, dtype, 7,
                             holes=[(i, 0) for i in free])
        timing[key] = time_paged(*args, key)
    timing["float32_zamba_main"] = time_paged(*_paged_inputs(
        lengths, PAGE_SIZE, mp, N_PAGES, 1, torch.float32, 8,
        holes=[(i, 0) for i in free], h=ZAMBA_H, d=ZAMBA_D),
        "float32_zamba_main")
    checked |= {(len(lengths), mp, PAGE_SIZE, N_PAGES, d)
                for d in (D, ZAMBA_D)}
    emit("flash_decode_paged_fwd", max_err=errs, timing=timing,
         main_lengths=lengths)
    return timing, checked


def phase_engine_paged(dev: dict, engine: dict, fa_checked: set,
                       fd_checked: set, pd_checked: set) -> dict:
    """Serves phase ``engine``'s 16 requests on the same weights from a
    pool of 48 pages of 64 tokens; its greedy streams must be the dense
    engine's, token for token."""
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_paged_fwd)
    from repro_torch.serve import cache_nbytes, prefill_split
    paged_kw = dict(paged=True, page_size=PAGE_SIZE, n_pages=N_PAGES)
    flash_decode_fwd.launches = 0
    flash_decode_paged_fwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = _serve(**paged_kw)
    fd, pd = flash_decode_fwd.launches, flash_decode_paged_fwd.launches
    eng, stats = out["engine"], out["stats"]
    state = eng.state
    n_layers = eng.model.cfg.n_layers
    ladder = eng.scheduler.ladder
    replay = sum(len(r.tokens) - prefill_split(len(r.tokens), ladder)
                 for r in out["requests"])
    dense = engine["out"]
    for a, b in zip(out["results"], dense["results"]):
        check(a.tokens == b.tokens, f"paged uid {a.uid} differs from the "
                                    f"dense engine's stream")
    check(state.refusals > 0, "admission never waited for pages")
    check(pd == n_layers * stats.decode_steps,
          f"flash_decode_paged_fwd launches {pd} vs {n_layers} x "
          f"{stats.decode_steps} fused steps")
    check(fd == n_layers * replay, f"flash_decode_fwd launches {fd} vs "
                                   f"{n_layers} x {replay} replay steps")
    state.alloc.check()
    check(state.alloc.pages_in_use == 0, "pages left in use")
    mp = state.alloc.pages_per_slot
    check({(eng.cfg.n_slots, mp, PAGE_SIZE, N_PAGES, D)} <= pd_checked,
          f"paged shape not checked in {pd_checked}")
    check({(1, eng.cfg.cache_len, D)} <= fd_checked,
          "replay shape not checked")
    check({(1, prefill_split(len(r.tokens), ladder))
           for r in out["requests"]} <= fa_checked, "prefill shapes")
    kv = lambda c: cache_nbytes({n: c[n] for n in ("k", "v")})
    peak = torch.cuda.max_memory_allocated()
    busy, names = device_profile(lambda: _serve(**paged_kw))
    wall = out["wall_s"] * 1e3
    top = {k[:60]: v for k, v in sorted(names.items(),
                                        key=lambda kv_: -kv_[1])[:6]}
    emit("engine_paged", card=dev["nvidia_smi"],
         prefill_tok_s=out["prefill_tok_s"],
         decode_tok_s=out["decode_tok_s"], p50_ms=out["p50_s"] * 1e3,
         p95_ms=out["p95_s"] * 1e3, fused_steps=stats.decode_steps,
         replay_steps=replay, admission_waits=state.refusals,
         table_uploads=state.table_uploads,
         launches={"flash_decode_paged_fwd": pd, "flash_decode_fwd": fd},
         pool_kv_bytes=kv(eng.cache),
         dense_kv_bytes=kv(engine["out"]["engine"].cache),
         max_memory_allocated=peak, wall_ms=wall,
         dense_engine={"decode_tok_s": dense["decode_tok_s"],
                       "p50_ms": dense["p50_s"] * 1e3,
                       "fused_steps": dense["stats"].decode_steps},
         traced_run={"device_busy_ms": busy,
                     "device_idle_share": 1 - busy / wall,
                     "top_kernels_ms": top})
    return {"flash_decode_paged_fwd": pd, "flash_decode_fwd": fd}


def phase_router(engine: dict) -> dict:
    """On the one card, with phase ``engine``'s weights: two replicas of 8
    slots (paged shortest-prompt-first, dense budget-packing) serve 32
    requests; a prefill-role replica feeds a paged decode-role one the 16
    requests; one request moves mid-flight dense -> paged and one paged ->
    dense.  Every greedy stream must be the single dense engine's."""
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_paged_fwd)
    from repro_torch.launch.serve import make_requests, scheduler_config
    from repro_torch.serve import (InferenceEngine, Replica, Router,
                                   make_replicas, prefill_split)
    dense_eng = engine["out"]["engine"]
    model, params = dense_eng.model, dense_eng.params
    n_layers = model.cfg.n_layers
    cache_len = PROMPT_LEN + GEN
    cfg = lambda **kw: scheduler_config(8, PROMPT_LEN, cache_len, **kw)
    paged_kw = dict(paged=True, page_size=PAGE_SIZE, n_pages=N_PAGES)
    reqs = make_requests(model.cfg, 32, PROMPT_LEN, GEN, seed=SEED)
    oracle = {r.uid: r.tokens for r in engine["out"]["results"]}
    oracle.update({r.uid: r.tokens for r in InferenceEngine(
        model, params, cfg(), device="cuda").run(reqs[16:])})
    ladder = dense_eng.scheduler.ladder
    replay = lambda rs: sum(len(r.tokens) - prefill_split(len(r.tokens),
                                                          ladder) for r in rs)
    totals = {"flash_decode_paged_fwd": 0, "flash_decode_fwd": 0}

    def counted(run):
        flash_decode_fwd.launches = flash_decode_paged_fwd.launches = 0
        t0 = time.perf_counter()
        results = run()
        wall = time.perf_counter() - t0
        got = (flash_decode_paged_fwd.launches, flash_decode_fwd.launches)
        totals["flash_decode_paged_fwd"] += got[0]
        totals["flash_decode_fwd"] += got[1]
        for r in results:
            check(r.tokens == oracle[r.uid], f"router uid {r.uid} differs "
                                             f"from the single engine's")
        return got, wall

    reps = [Replica(model, params, cfg(policy="shortest-prompt-first",
                                       **paged_kw), device="cuda",
                    name="paged-spf"),
            Replica(model, params, cfg(policy="budget-packing"),
                    device="cuda", name="dense-budget")]
    router = Router(reps)
    (pd, fd), wall = counted(lambda: router.run(reqs))
    check(pd == n_layers * reps[0].stats.decode_steps, f"router paged {pd}")
    check(fd == n_layers * (reps[1].stats.decode_steps + replay(reqs)),
          f"router dense {fd}")
    check(len(router.stats.routed) == 2, f"routed {router.stats.routed}")
    two = {"wall_ms": wall * 1e3, **router.summary(),
           "launches": {"flash_decode_paged_fwd": pd, "flash_decode_fwd": fd},
           "admission_waits": reps[0].state.refusals}

    [pair] = make_replicas(model, params, cfg(**paged_kw), 1, device="cuda",
                           disaggregate=True)
    (pd, fd), wall = counted(lambda: Router([pair]).run(reqs[:16]))
    check(pd == n_layers * pair.stats.decode_steps, f"disagg paged {pd}")
    check(fd == n_layers * replay(reqs[:16]), f"disagg dense {fd}")
    check(pair.prefill_replica.stats.prefill_tokens
          == sum(len(r.tokens) for r in reqs[:16]), "prefill partner")
    disagg = {"wall_ms": wall * 1e3, "decode_tok_s": pair.stats.decode_tok_s,
              "launches": {"flash_decode_paged_fwd": pd,
                           "flash_decode_fwd": fd}}

    moves = {}
    dense_rep = Replica(model, params, cfg(), device="cuda", name="dense")
    paged_rep = Replica(model, params, cfg(**paged_kw), device="cuda",
                        name="paged")
    for name, src, dst, req in (("dense_to_paged", dense_rep, paged_rep,
                                 reqs[0]),
                                ("paged_to_dense", paged_rep, dense_rep,
                                 reqs[1])):
        def move():
            src.scheduler.submit(req)
            src.pump()  # admit and one fused step
            src.pump()  # one more step mid-flight
            [slot] = list(src.scheduler.active)
            src.migrate_slot_to(slot, dst)
            check(not src.scheduler.busy, "source kept the request")
            while dst.scheduler.busy:
                dst.pump()
            return dst.take_finished()
        (pd, fd), _ = counted(move)
        moves[name] = {"launches": {"flash_decode_paged_fwd": pd,
                                    "flash_decode_fwd": fd}}
    paged_rep.state.alloc.check()
    check(paged_rep.state.alloc.pages_in_use == 0
          and reps[0].state.alloc.pages_in_use == 0
          and pair.state.alloc.pages_in_use == 0, "pages left in use")
    emit("router", two_replicas=two, disaggregated=disagg, migrations=moves,
         requests_checked=len(oracle), launches=totals)
    return totals


def attention_bwd_errs(q, k, v, o, lse, do, got=None) -> dict:
    """{dq, dk, dv: (max abs err, within the limit)} of ``got`` (by default
    the three backward kernels' outputs) against the plain versions on the
    same inputs.  fp32: each within 1e-4 x max |plain| (another summation
    order over up to 1024 keys) plus 1e-5 absolute for entries that cancel
    to 0 (at S = 1, dq is 0 in exact arithmetic).  bf16 outputs: that plus
    2 bf16 ulps at the value, since both sides compute in fp32 and round
    once to bf16."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_plain)
    if got is None:
        got = flash_attention_bwd(q, k, v, o, lse, do)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    errs = {}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        err = (a.float() - r.float()).abs()
        tol = 1e-4 * r.float().abs().max().item() + 1e-5
        if q.dtype == torch.bfloat16:
            tol = tol + bf16_tolerance(a, r) - 2e-5
        errs[name] = (err.max().item(), bool((err <= tol).all()))
    return errs


def check_attention_bwd(q, k, v, o, lse, do, what: str) -> list:
    """[dq, dk, dv max abs err] of :func:`attention_bwd_errs`; fails if one
    is outside its limit."""
    errs = attention_bwd_errs(q, k, v, o, lse, do)
    for name, (err, ok) in errs.items():
        check(ok, f"fa bwd {name} {what}: {err}")
    return [err for err, _ in errs.values()]


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


def _bwd_bounds(bh: int, s: int, tensor_cores: bool = True) -> dict:
    """(least ms, what bounds it) of each backward kernel and of all three,
    fp32, causal over the whole length: each input read once and each
    output written once; 2 D operations per (query, key) pair below the
    diagonal for each product a kernel does (dQ kernel: S, dP, dQ; dK/dV
    kernel: S, dP, dV, dK; five distinct), as three TF32 products on the
    tensor cores (:func:`tc_bound`) or on the CUDA cores.  The delta
    kernel runs on the CUDA cores."""
    row, tile = bh * s * 4, bh * s * D * 4
    pair_ops = 2 * D * _causal_pairs(bh, s)
    f32 = torch.float32
    bound_fn = (tc_bound if tensor_cores
                else lambda nbytes, flops: bound(nbytes, flops, f32))
    return {"preprocess": bound(2 * tile + row, 2 * bh * s * D, f32),
            "dq": bound_fn(5 * tile + 2 * row, 3 * pair_ops),
            "dkv": bound_fn(6 * tile + 2 * row, 4 * pair_ops),
            "all": bound_fn(8 * tile + row, 5 * pair_ops + 2 * bh * s * D)}


def phase_flash_attention_bwd(shapes) -> tuple:
    """Holds the forward and the three backward kernels against their plain
    versions at every (B, S) of ``shapes`` (the training run's, at H = 12)
    in fp32, plus ragged S = 1 and 427 in fp32 and bf16 and the bf16 model
    run's (BF16_B, BF16_S); times them at (16, 1024) fp32."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd, flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
        flash_attention_bwd_dq_plain, flash_attention_bwd_plain,
        flash_attention_bwd_preprocess,
        flash_attention_bwd_preprocess_plain, flash_attention_fwd,
        flash_attention_fwd_plain)
    cases = [(torch.float32, b, s) for b, s in sorted(shapes)] + [
        (dt, 4, s) for dt in (torch.float32, torch.bfloat16) for s in (1, 427)
    ] + [(torch.bfloat16, BF16_B, BF16_S)]
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
    for name, (t_bound, _) in _bwd_bounds(bh, s, False).items():
        if name != "preprocess":  # the same work on the CUDA cores
            timing[name]["cuda_core_bound_ms"] = t_bound
    fwd_bytes = 4 * bh * s * D * 4 + bh * s * 4
    fwd_flops = 4 * D * _causal_pairs(bh, s)
    timing["fwd"].update(zip(("bound_ms", "bound_by"),
                             tc_bound(fwd_bytes, fwd_flops)))
    timing["fwd"]["cuda_core_bound_ms"] = bound(fwd_bytes, fwd_flops,
                                                torch.float32)[0]

    # bf16 at the training shape: the forward and the whole backward against
    # their plain versions (the existing tolerances) and SDPA's bf16 calls
    bf = torch.bfloat16
    qb, kb, vb, dob = (t.to(bf) for t in (q, k, v, do))
    ob, lseb = flash_attention_fwd(qb, kb, vb)
    q4b, k4b, v4b = (t.reshape(B_TRAIN, H, s, D).clone().requires_grad_()
                     for t in (qb, kb, vb))
    out4b = F.scaled_dot_product_attention(q4b, k4b, v4b, is_causal=True)
    do4b = dob.reshape(B_TRAIN, H, s, D)
    timing["fwd_bf16"] = {
        "max_abs_err": check_attention(qb, kb, vb, "timed fwd bf16")[0],
        **times(lambda: flash_attention_fwd(qb, kb, vb),
                lambda: flash_attention_fwd_plain(qb, kb, vb),
                lambda: F.scaled_dot_product_attention(
                    q4b, k4b, v4b, is_causal=True))}
    timing["fwd_bf16"].update(zip(("bound_ms", "bound_by"), bound(
        fwd_bytes // 2 + bh * s * 2, 4 * D * _causal_pairs(bh, s), bf)))
    timing["all_bf16"] = {
        "max_abs_err": max(check_attention_bwd(qb, kb, vb, ob, lseb, dob,
                                               "timed bf16")),
        **times(lambda: flash_attention_bwd(qb, kb, vb, ob, lseb, dob),
                lambda: flash_attention_bwd_plain(qb, kb, vb, ob, lseb, dob),
                lambda: torch.autograd.grad(out4b, (q4b, k4b, v4b), do4b,
                                            retain_graph=True))}
    timing["all_bf16"].update(zip(("bound_ms", "bound_by"), bound(
        8 * bh * s * D * 2 + bh * s * 4, 5 * 2 * D * _causal_pairs(bh, s),
        bf)))

    # no atomics: two runs of the backward on the same inputs agree bit
    # for bit, in both dtypes
    for args in ((q, k, v, o, lse, do), (qb, kb, vb, ob, lseb, dob)):
        first = flash_attention_bwd(*args)
        again = flash_attention_bwd(*args)
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"fa bwd not deterministic ({args[0].dtype})")
    emit("flash_attention_bwd", max_err=errs, timing=timing,
         shape=f"B={B_TRAIN} H={H} S={s} D={D} float32 (and *_bf16)",
         deterministic=True)
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
    # each flash-attention kernel's device ms over the 3 traced steps, by
    # the __global__ name in its source's anonymous namespace (demangled or
    # mangled)
    fa_ms = {name: sum(v for k, v in names.items() if re.search(
                 rf"\(anonymous namespace\)::{fn}<|_GLOBAL__N_\w*\d{fn}I", k))
             for name, fn in (("flash_attention_fwd", "flash_fwd_kernel"),
                              ("flash_attention_bwd_preprocess",
                               "bwd_preprocess_kernel"),
                              ("flash_attention_bwd_dq", "bwd_dq_kernel"),
                              ("flash_attention_bwd_dkv", "bwd_dkv_kernel"))}
    check(all(v > 0 for v in fa_ms.values()),
          f"a flash-attention kernel is missing from the trace: {fa_ms}")
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
                              "top_kernels_ms": top,
                              "flash_kernels_ms": fa_ms})
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

# gpt2-117m in bf16: one loss and backward through the flash kernels'
# bf16 instances, against the blockwise backend on the same bf16 params
BF16_B, BF16_S = 8, 512
# fixed before the first run: both backends round every GEMM, norm and
# activation to bf16 (8 significant bits), and blockwise also rounds the
# scores and P, which the kernels keep in fp32.  The same plain functions
# on the host at this shape put the two 3.6e-2 of a leaf's largest entry
# apart (wq, wk), each as far from the fp32 model (3.9e-2, 5.4e-2), and
# the losses 4.3e-6 apart; a zeroed or mis-scaled gradient is off by the
# whole leaf
BF16_GRAD_RTOL = 0.1
BF16_LOSS_RTOL = 1e-3
# The model's gradients cannot say more: the same flash model on the
# kernels' plain versions (fp32 P on both sides) reads about as far from
# the kernels' run as blockwise does (PERF.md section 6, PR 16), since in
# bf16 a flipped rounding anywhere moves every later leaf.  So every launch
# of the run is held against its plain version on the inputs the run gave
# it, at the kernel checks' bf16 tolerance, and a dv x (1 + BF16_FAULT)
# planted there must break that tolerance in every layer.
BF16_FAULT = 0.01


def _bf16_grads(cfg, params, batch, backend, **swap):
    """(loss, gradient leaves) of ``DenseLM.loss`` with ``backend``; each
    ``swap`` replaces that name in the flash Function's module."""
    import contextlib
    from unittest import mock

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import model_zoo
    from repro_torch.optim.transforms import tree_leaves, tree_unflatten
    model = model_zoo.build_model(cfg.replace(attn_backend=backend),
                                  remat="none")
    leaves = [t.detach().clone().requires_grad_()
              for t in tree_leaves(params)]
    with (mock.patch.multiple(ops, **swap) if swap
          else contextlib.nullcontext()):
        loss, _ = model.loss(tree_unflatten(params, leaves), batch)
        return loss.item(), torch.autograd.grad(loss, leaves)


def _max_rel(names, got, ref) -> dict:
    """{leaf: max |got - ref| / max |ref|}."""
    return {n: (a.float() - r.float()).abs().max().item()
            / r.float().abs().max().item() for n, a, r in zip(names, got, ref)}


def phase_grads_bf16() -> dict:
    """``DenseLM.loss`` and its backward of full-width gpt2-117m with bf16
    params (random, from SEED) on a random 8 x 512 batch, through the flash
    backend, each kernel launched once a layer: the loss and every leaf
    against the blockwise backend within the fixed limits, and each launch
    against its plain version on the inputs the run gave it."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)
    from repro_torch.models import model_zoo
    from repro_torch.optim.transforms import tree_map
    cfg = get_arch("gpt2-117m")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = tree_map(lambda t: t.to(torch.bfloat16), model_zoo.init_params(
        cfg, gen, torch.device("cuda")))
    tokens = torch.randint(0, cfg.vocab_size, (BF16_B, BF16_S + 1),
                           device="cuda", generator=gen)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    names = _leaf_names(params)
    run = functools.partial(_bf16_grads, cfg, params, batch)

    calls = {"fwd": [], "bwd": []}

    def fwd(*args, **kw):
        calls["fwd"].append((args, kw))
        return flash_attention_fwd(*args, **kw)

    def bwd(*args, **kw):
        calls["bwd"].append((args, kw))
        return flash_attention_bwd(*args, **kw)
    kernels = _fa_kernels()
    for f in kernels.values():
        f.launches = 0
    flash_loss, got = run("flash", flash_attention_fwd=fwd,
                          flash_attention_bwd=bwd)
    launches = {name: f.launches for name, f in kernels.items()}
    plain_loss, ref = run("blockwise")
    fp32p_loss, fp32p = run("flash",
                            flash_attention_fwd=flash_attention_fwd_plain,
                            flash_attention_bwd=flash_attention_bwd_plain)
    check({name: f.launches for name, f in kernels.items()} == launches,
          "the blockwise or plain run launched a flash-attention kernel")
    want = {name: cfg.n_layers for name in kernels}
    check(launches == want, f"bf16 launches {launches} != {want}")

    for name, a, r in zip(names, got, ref):
        check(a.dtype == torch.bfloat16, f"{name} gradient is {a.dtype}")
        if ".attn." in name:
            check(r.abs().max().item() > 0, f"no gradient reaches {name}")
    loss_rel = abs(flash_loss - plain_loss) / abs(plain_loss)
    check(loss_rel <= BF16_LOSS_RTOL, f"bf16 loss: {loss_rel}")
    rel = _max_rel(names, got, ref)
    for name, e in rel.items():
        check(e <= BF16_GRAD_RTOL, f"bf16 gradient {name}: {e}")

    # every launch against its plain version on the run's own inputs
    whole = {"causal": True, "valid_len": BF16_S}
    fwd_err, bwd_err, caught, do_max = 0.0, 0.0, 0, 0.0
    for i, (args, kw) in enumerate(calls["fwd"]):
        check(kw == whole, f"bf16 forward call {i}: {kw}")
        fwd_err = max(fwd_err, check_attention(*args, f"bf16 model {i}")[0])
    for i, ((q, k, v, o, lse, do), kw) in enumerate(calls["bwd"]):
        check(kw == whole, f"bf16 backward call {i}: {kw}")
        # the loss's dO is small (do_max), where the limits' absolute
        # floors, set for unit-size inputs, could hide a wrong dv: the
        # backward is linear in dO and a power-of-two scale is exact, so
        # the kernels see the run's inputs scaled to a largest |dO| in
        # [1, 2), as in the other checks
        do_max = max(do_max, do.abs().max().item())
        do = do * 2.0 ** -math.floor(math.log2(do.abs().max().item()))
        args = (q, k, v, o, lse, do)
        bwd_err = max(bwd_err, *check_attention_bwd(*args,
                                                    f"bf16 model {i}"))
        dq, dk, dv = flash_attention_bwd(*args)
        errs = attention_bwd_errs(*args, got=(dq, dk, dv * (1 + BF16_FAULT)))
        caught += not errs["dv"][1]
    n = len(calls["bwd"])
    check(caught == n, f"a planted dv x {1 + BF16_FAULT} passed the kernel "
                       f"check in {n - caught} of {n} backward calls")
    fp32p_rel = _max_rel(names, got, fp32p)
    emit("grads_bf16", shape=f"{BF16_B}x{BF16_S}", loss=flash_loss,
         loss_rel_err=loss_rel, leaves=len(rel), rtol=BF16_GRAD_RTOL,
         max_rel_err=max(rel.values()), worst_leaf=max(rel, key=rel.get),
         launches=launches, calls_checked={"fwd": len(calls["fwd"]),
                                           "bwd": n},
         calls_max_abs_err={"fwd": fwd_err, "bwd": bwd_err}, do_max=do_max,
         planted_dv_fault_caught=f"{caught} of {n}",
         reported_only_plain_versions={
             "loss_rel_err": abs(flash_loss - fp32p_loss) / abs(fp32p_loss),
             "max_rel_err": max(fp32p_rel.values()),
             "worst_leaf": max(fp32p_rel, key=fp32p_rel.get)})
    return launches

# ---------------------------------------------------------------------------
# RWKV-6: the WKV-6 kernels, serving and training rwkv6-7b at full width
# ---------------------------------------------------------------------------

RWKV_H, RWKV_D, RWKV_CHUNK = 64, 64, 64  # rwkv6-7b: 64 heads of 64
# training: rwkv6-7b at full width cut to 4 layers, global batch 8 of
# sequences of 1024, SLW linear from 8 over 12 steps, batch warmup from 4,
# 20 steps, one eval of 8 sequences
RWKV_LAYERS, RWKV_B, RWKV_STEPS, RWKV_EVAL = 4, 8, 20, 8
# the kernels against their plain versions, fp32: each output within this
# fraction of the plain output's largest entry (fixed before the first run:
# fp32 sums over up to 64 keys and 64 channels in another order)
WKV_RTOL = 1e-4
# log_w near -54.6 a token (the floor of -exp(clip(w, -8, 4))): cumulative
# log-decays reach -3,500 in a chunk, whose fp32 ulp is 2.4e-4, and the
# pairwise exponent is a difference of two of them; two summation orders
# then differ by up to ~1e-3 in a pair weight near 1
WKV_FAST_RTOL = 2e-3
FAST_DECAY = -54.6
# the RWKV gradients (see :func:`_compare_rwkv_grads`), kernel path against
# the reference backend on the card: every leaf of two batches within
# GRAD_RTOL of the leaf's largest entry at the norms' eps raised to
# RWKV_GRAD_EPS, where the fp32 gradient is well-conditioned; at the
# model's own eps and at those of RWKV_GRAD_SWEEP only reported.  At the
# model's eps no fixed limit both passes the kernels and catches a wrong
# backward: on the H100 (PERF.md, §6) the reference itself moved 4.1e-3
# and 4.8e-2 between card and host there, and the kernel path's distance
# to it on the trained batch read 2.4e-2, more than the planted fault's
# 1e-2; at eps 1 the kernel path read at most 1.1e-5 and the reference's
# card-vs-host spread 6.6e-6
RWKV_GRAD_EPS = 1.0
RWKV_GRAD_SWEEP = (1e-3, 1e-1, 10.0)
# a planted fault the check at RWKV_GRAD_EPS must catch: dv x (1 + this)
# out of the backward kernel
RWKV_FAULT = 1e-2


def _wkv_inputs(b, s, dtype, seed, decay=None):
    """r, k, v (B, 64, S, 64) in ``dtype``; log_w fp32, -exp(N(0, 0.5^2))
    (the model at init gives -1) or ``decay`` plus small noise; u (64, 64)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, RWKV_H, s, RWKV_D)
    r, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    noise = torch.randn(shape, device="cuda", generator=gen)
    lw = -torch.exp(0.5 * noise) if decay is None else decay + 0.01 * noise
    u = 0.5 * torch.randn(RWKV_H, RWKV_D, device="cuda", generator=gen)
    return r, k, v, lw, u


def _rel_err(a, ref, scale=None) -> float:
    """max |a - ref| over ``scale`` (default max |ref|)."""
    scale = ref.float().abs().max().item() if scale is None else scale
    return (a.float() - ref.float()).abs().max().item() / max(scale, 1e-30)


def _wkv_pairs(q: int) -> int:
    return q * (q - 1) // 2


def wkv6_fwd_work(b, s, q, elt) -> tuple:
    """(bytes, operations) of one forward call without carries at (B, 64,
    S, 64), chunk q: r, k, v, y in ``elt`` bytes and log_w in fp32 read or
    written once, u read and the fp32 state written once; per chunk 4
    operations and
    one exp per pairwise term (Q (Q - 1) / 2 x D), Q D ((Q - 1) / 2 + 1 +
    D) multiply-adds for y and Q D^2 for the state update."""
    h, d, nc = RWKV_H, RWKV_D, s // q
    nbytes = (4 * b * h * s * d * elt + b * h * s * d * 4 + h * d * 4
              + b * h * d * d * 4)
    per_chunk = (5 * _wkv_pairs(q) * d + 2 * q * d * ((q - 1) / 2 + 1 + d)
                 + 2 * q * d * d)
    return nbytes, b * h * nc * per_chunk


def wkv6_bwd_work(b, s, q) -> tuple:
    """(bytes, operations) of one backward call, fp32: r, k, v, log_w, dy,
    the carries, dstate, u read once, dr, dk, dv, d_log_w, du written once;
    per chunk p (Q^2 D multiply-adds), the scores and dr, dk's pairwise sums
    (4 + 5 + 5 operations and one exp per pairwise term each), the state
    terms of dr and dk, dv and the cotangent update (Q D^2, Q D^2,
    Q D (D + (Q - 1) / 2), Q D^2 multiply-adds)."""
    h, d, nc = RWKV_H, RWKV_D, s // q
    nbytes = (5 * b * h * s * d * 4 + b * h * (nc + 1) * d * d * 4
              + h * d * 4 + 4 * b * h * s * d * 4 + b * h * d * 4)
    per_chunk = (2 * q * q * d + 14 * _wkv_pairs(q) * d + 6 * q * d * d
                 + 2 * q * d * (d + (q - 1) / 2))
    return nbytes, b * h * nc * per_chunk


def check_scan_fwd(kernel, plain, args, chunk, what, rtol) -> dict:
    """{y, state, carries}: relative errors of a chunked-scan forward
    kernel (WKV-6, SSD) against its plain version on the same inputs.  fp32
    y within ``rtol`` of max |y|; bf16 y within :func:`bf16_tolerance` plus
    that; the fp32 state and carries within ``rtol``.  Fails on any
    non-finite output."""
    got = kernel(*args, chunk=chunk, return_carries=True)
    ref = plain(*args, chunk=chunk, return_carries=True)
    torch.cuda.synchronize()
    name = kernel.__name__
    check(all(bool(torch.isfinite(t.float()).all()) for t in got),
          f"{name} {what}: non-finite output")
    errs = {}
    for out, a, e in zip(("y", "state", "carries"), got, ref):
        tol = rtol * e.float().abs().max().item()
        if out == "y" and a.dtype == torch.bfloat16:
            tol = tol + bf16_tolerance(a, e) - 2e-5
        check(bool(((a.float() - e.float()).abs() <= tol).all()),
              f"{name} {out} {what}: {_rel_err(a, e)}")
        errs[out] = _rel_err(a, e)
    return errs


def check_wkv6_fwd(r, k, v, lw, u, chunk, what, rtol=WKV_RTOL) -> dict:
    from repro_torch.kernels.rwkv6 import wkv6_fwd, wkv6_fwd_plain
    return check_scan_fwd(wkv6_fwd, wkv6_fwd_plain, (r, k, v, lw, u), chunk,
                          what, rtol)


def _kernel_shape(b, s, chunk):
    """(B, S, chunk) a chunked-scan kernel sees for a (B, S) input: the
    chunk clamped to S and S padded to a multiple of it
    (``chunk_padding``)."""
    from repro_torch.kernels import chunk_padding
    q, pad = chunk_padding(s, chunk)
    return b, s + pad, q


def _wkv_kernel_shape(b, s):
    return _kernel_shape(b, s, RWKV_CHUNK)


def phase_wkv6_fwd(prefills, train_shapes) -> tuple:
    """Holds the forward kernel against its plain version at the serving
    prefills (B 1, S 256/384/512), every (batch, S) of the RWKV training
    plan and its eval, one bf16 case, S below a chunk, S off a chunk
    multiple (through the padding wrapper), and log_w near -54.6; times it
    at the largest prefill and at the full-length training batch."""
    from repro_torch.kernels.rwkv6 import wkv6, wkv6_fwd, wkv6_fwd_plain
    errs, checked = {}, set()
    for i, (b, s) in enumerate(sorted(set(prefills) | set(train_shapes))):
        kb, ks, q = _wkv_kernel_shape(b, s)
        errs[f"{b}x{s}"] = check_wkv6_fwd(*_wkv_inputs(kb, ks, torch.float32,
                                                       i), q, f"{b}x{s}")
        checked.add((kb, ks, q))
    errs["bf16_2x256"] = check_wkv6_fwd(
        *_wkv_inputs(2, 256, torch.bfloat16, 50), RWKV_CHUNK, "bf16")
    errs["short_2x40"] = check_wkv6_fwd(*_wkv_inputs(2, 40, torch.float32, 51),
                                        40, "S < chunk")
    errs["fast_decay_1x256"] = check_wkv6_fwd(
        *_wkv_inputs(1, 256, torch.float32, 52, FAST_DECAY), RWKV_CHUNK,
        "log_w near -54.6", rtol=WKV_FAST_RTOL)
    # S = 100 through the wrapper: zero-padded to 128, sliced back
    r, k, v, lw, u = _wkv_inputs(2, 100, torch.float32, 53)
    y, state = wkv6(r, k, v, lw, u, chunk=RWKV_CHUNK)
    pad = [F.pad(t, (0, 0, 0, 28)) for t in (r, k, v, lw)]
    ry, rstate = wkv6_fwd_plain(*pad, u, chunk=RWKV_CHUNK)
    torch.cuda.synchronize()
    errs["ragged_2x100"] = {"y": _rel_err(y, ry[:, :, :100]),
                            "state": _rel_err(state, rstate)}
    check(max(errs["ragged_2x100"].values()) <= WKV_RTOL, "wkv6 S = 100")

    timing = {}
    for key, b, s in (("serve_1x512", 1, max(s for _, s in prefills)),
                      ("train_8x1024", RWKV_B, S_TRAIN)):
        r, k, v, lw, u = _wkv_inputs(b, s, torch.float32, 60)
        nbytes, ops = wkv6_fwd_work(b, s, RWKV_CHUNK, 4)
        t_bound, by = bound(nbytes, ops, torch.float32)
        timing[key] = {
            "max_abs_err": (wkv6_fwd(r, k, v, lw, u, chunk=RWKV_CHUNK)[0]
                            - wkv6_fwd_plain(r, k, v, lw, u,
                                             chunk=RWKV_CHUNK)[0]
                            ).abs().max().item(),
            **times(lambda: wkv6_fwd(r, k, v, lw, u, chunk=RWKV_CHUNK),
                    lambda: wkv6_fwd_plain(r, k, v, lw, u,
                                           chunk=RWKV_CHUNK),
                    plain_queued=False),
            "library_note": "no one PyTorch call computes WKV-6",
            "bytes": nbytes, "operations": ops, "bound_ms": t_bound,
            "bound_by": by}
        del r, k, v, lw
    torch.cuda.empty_cache()
    emit("wkv6_fwd", rel_err=errs, timing=timing,
         shape=f"H={RWKV_H} D={RWKV_D} chunk<={RWKV_CHUNK}")
    return timing, checked


def check_wkv6_bwd(r, k, v, lw, u, chunk, what, rtol=WKV_RTOL) -> dict:
    """Relative errors of the backward kernel's dr, dk, dv, d_log_w and du
    against the plain reverse scan on the same inputs, carries and nonzero
    cotangents on y and on the final state, and against torch.autograd
    through the plain forward.  Each within
    ``rtol`` of the reference's largest entry; d_log_w against the largest
    |r dr| and |k dk| as well, since it is a suffix sum of differences of
    such terms (under fast decay it is ~0 while they are not)."""
    from repro_torch.kernels.rwkv6 import (wkv6_bwd, wkv6_bwd_plain,
                                           wkv6_fwd_plain)
    b, h, s, d = r.shape
    gen = torch.Generator(device="cuda").manual_seed(s + 7)
    dy = torch.randn(b, h, s, d, device="cuda", generator=gen)
    dstate = torch.randn(b, h, d, d, device="cuda", generator=gen)
    _, _, carries = wkv6_fwd_plain(r, k, v, lw, u, chunk=chunk,
                                   return_carries=True)
    got = wkv6_bwd(r, k, v, lw, u, carries, dy, dstate, chunk=chunk)
    refs = {"plain": wkv6_bwd_plain(r, k, v, lw, u, carries, dy, dstate,
                                    chunk=chunk)}
    del carries
    xs = [t.detach().clone().requires_grad_() for t in (r, k, v, lw, u)]
    y, state = wkv6_fwd_plain(*xs, chunk=chunk)
    refs["autograd"] = torch.autograd.grad(
        (y * dy).sum() + (state * dstate).sum(), xs)
    del y, state, xs
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"wkv6_bwd {what}: non-finite output")
    errs = {}
    for src, ref in refs.items():
        ref = list(ref)
        if src == "plain":
            ref[4] = ref[4].sum(dim=0)
        dlw_scale = max(ref[3].abs().max().item(),
                        (r.float() * ref[0]).abs().max().item(),
                        (k.float() * ref[1]).abs().max().item())
        for name, a, e, scale in zip(
                ("dr", "dk", "dv", "dlw", "du"), got[:4] + (got[4].sum(0),),
                ref, (None, None, None, dlw_scale, None)):
            err = _rel_err(a, e, scale)
            check(err <= rtol, f"wkv6_bwd {name} {what} vs {src}: {err}")
            errs[f"{name}_vs_{src}"] = err
    return errs


def phase_wkv6_bwd(train_shapes) -> tuple:
    """Holds the backward kernel against the plain reverse scan and against
    autograd through the plain forward at every (batch, S) of the training
    plan, and at log_w near -54.6; times it at the full-length batch."""
    from repro_torch.kernels.rwkv6 import (wkv6_bwd, wkv6_bwd_plain,
                                           wkv6_fwd_plain)
    errs, checked = {}, set()
    for i, (b, s) in enumerate(sorted(train_shapes)):
        kb, ks, q = _wkv_kernel_shape(b, s)
        errs[f"{b}x{s}"] = check_wkv6_bwd(
            *_wkv_inputs(kb, ks, torch.float32, 100 + i), q, f"{b}x{s}")
        checked.add((kb, ks, q))
        torch.cuda.empty_cache()
    errs["fast_decay_1x256"] = check_wkv6_bwd(
        *_wkv_inputs(1, 256, torch.float32, 99, FAST_DECAY), RWKV_CHUNK,
        "log_w near -54.6", rtol=WKV_FAST_RTOL)
    b, s = RWKV_B, S_TRAIN
    r, k, v, lw, u = _wkv_inputs(b, s, torch.float32, 61)
    gen = torch.Generator(device="cuda").manual_seed(62)
    dy = torch.randn(r.shape, device="cuda", generator=gen)
    dstate = torch.randn(b, RWKV_H, RWKV_D, RWKV_D, device="cuda",
                         generator=gen)
    _, _, carries = wkv6_fwd_plain(r, k, v, lw, u, chunk=RWKV_CHUNK,
                                   return_carries=True)
    args = (r, k, v, lw, u, carries, dy, dstate)
    nbytes, ops = wkv6_bwd_work(b, s, RWKV_CHUNK)
    t_bound, by = bound(nbytes, ops, torch.float32)
    timing = {"train_8x1024": {
        "max_abs_err": max(
            (a - e).abs().max().item() for a, e in zip(
                wkv6_bwd(*args, chunk=RWKV_CHUNK),
                wkv6_bwd_plain(*args, chunk=RWKV_CHUNK))),
        **times(lambda: wkv6_bwd(*args, chunk=RWKV_CHUNK),
                lambda: wkv6_bwd_plain(*args, chunk=RWKV_CHUNK),
                plain_queued=False),
        "library_note": "no one PyTorch call computes WKV-6's backward",
        "bytes": nbytes, "operations": ops, "bound_ms": t_bound,
        "bound_by": by}}
    del args, r, k, v, lw, dy, dstate, carries
    torch.cuda.empty_cache()
    emit("wkv6_bwd", rel_err=errs, timing=timing)
    return timing, checked


def _wkv_counters():
    from repro_torch.kernels.rwkv6 import wkv6_bwd, wkv6_fwd
    return {"wkv6_fwd": wkv6_fwd, "wkv6_bwd": wkv6_bwd}


def _ssd_counters():
    from repro_torch.kernels.ssd import ssd_bwd, ssd_fwd
    return {"ssd_fwd": ssd_fwd, "ssd_bwd": ssd_bwd}


def _all_counters():
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_paged_fwd)
    return {**_fa_kernels(), "flash_decode_fwd": flash_decode_fwd,
            "flash_decode_paged_fwd": flash_decode_paged_fwd,
            **_wkv_counters(), **_ssd_counters()}


def _zero_counters() -> dict:
    counters = _all_counters()
    for f in counters.values():
        f.launches = 0
    return counters


def _serve_model(model, params, reqs, **kw) -> dict:
    """One engine of 8 slots over ``reqs``, fcfs, as ``_serve`` gives
    gpt2's (the rwkv and zamba phases)."""
    from repro_torch.launch.serve import scheduler_config
    from repro_torch.serve import InferenceEngine
    eng = InferenceEngine(model, params, scheduler_config(
        8, PROMPT_LEN, PROMPT_LEN + GEN, **kw), device="cuda")
    t0 = time.perf_counter()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    s = eng.stats
    return {"engine": eng, "results": results, "stats": s,
            "wall_s": time.perf_counter() - t0,
            "prefill_tok_s": s.prefill_tok_s, "decode_tok_s": s.decode_tok_s,
            "p50_s": s.latency_percentile(50),
            "p95_s": s.latency_percentile(95)}


def phase_engine_rwkv(dev: dict, fwd_checked: set) -> dict:
    """Serves full-depth, full-width rwkv6-7b (fp32, weights from a CUDA
    generator seeded with SEED) in 8 slots: 16 requests from
    ``make_requests``, fcfs.  Checks the launch counts (wkv6_fwd 32 x
    prefill calls, no other kernel), the greedy streams against the same
    engine at rwkv_backend="reference", and serves the first 8 requests
    once more through the router (a paged and a dense replica) and moves
    one request each way between them mid-flight."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import make_requests, scheduler_config
    from repro_torch.models import model_zoo
    from repro_torch.serve import Replica, Router, prefill_split
    cfg = get_arch("rwkv6-7b")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    params = model_zoo.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED),
        torch.device("cuda"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = model_zoo.build_model(cfg)
    plain_model = model_zoo.build_model(cfg.replace(rwkv_backend="reference"))
    reqs = make_requests(cfg, 16, PROMPT_LEN, GEN, seed=SEED)
    _serve_model(model, params, reqs[:2])  # warm-up: first-call costs
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    out = _serve_model(model, params, reqs)
    launches = {n: f.launches for n, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    eng, stats = out["engine"], out["stats"]
    ladder = eng.scheduler.ladder
    replay = sum(len(r.tokens) - prefill_split(len(r.tokens), ladder)
                 for r in reqs)
    want = {n: 0 for n in counters}
    want["wkv6_fwd"] = cfg.n_layers * len(reqs)
    check(launches == want, f"rwkv serve launches {launches} != {want}")
    check(all(r.n_generated == q.max_tokens and r.finish_reason == "length"
              for r, q in zip(out["results"], reqs)),
          "every rwkv request generated its budget")
    prefills = {_wkv_kernel_shape(1, prefill_split(len(r.tokens), ladder))
                for r in reqs}
    check(prefills <= fwd_checked, f"rwkv prefill shapes {prefills} not all "
                                   f"checked in {fwd_checked}")
    plain = _serve_model(plain_model, params, reqs)
    check(_wkv_counters()["wkv6_fwd"].launches == want["wkv6_fwd"],
          "the reference backend launched wkv6_fwd")
    diverged, gaps = check_streams(reqs, out["results"], plain["results"],
                                   plain["engine"], "rwkv")
    # device idle share over a steady decode window (a trace of the whole
    # run holds about a million kernels and takes minutes to read): the
    # first 8 requests admitted, 6 fused steps untraced, 6 traced (their
    # budgets of 32 or more tokens keep all 8 slots live throughout)
    cfg_s = lambda **kw: scheduler_config(8, PROMPT_LEN, PROMPT_LEN + GEN,
                                          **kw)
    window = Replica(model, params, cfg_s(), device="cuda")
    for r in reqs[:8]:
        window.scheduler.submit(r)
    while window.admit():
        pass
    check(len(window.scheduler.active) == 8, "the decode window's slots")
    steps6 = lambda: [window.step() for _ in range(6)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps6()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, names = device_profile(steps6)
    top = {k[:60]: v for k, v in sorted(names.items(),
                                        key=lambda kv: -kv[1])[:6]}
    del window

    # the router: a paged shortest-prompt-first and a dense fcfs replica;
    # paging is a structural no-op (no leaf of the state has a "seq" axis)
    oracle = {r.uid: r.tokens for r in out["results"]}
    paged_kw = dict(paged=True, page_size=PAGE_SIZE, n_pages=N_PAGES)
    reps = [Replica(model, params, cfg_s(policy="shortest-prompt-first",
                                         **paged_kw), device="cuda",
                    name="paged-spf"),
            Replica(model, params, cfg_s(), device="cuda", name="dense")]
    counters = _zero_counters()
    t0 = time.perf_counter()
    routed = Router(reps).run(reqs[:8])
    router_wall = time.perf_counter() - t0
    for r in routed:
        check(r.tokens == oracle[r.uid], f"rwkv router uid {r.uid}")
    moves = {}
    for name, src, dst, req in (("dense_to_paged", reps[1], reps[0],
                                 reqs[0]),
                                ("paged_to_dense", reps[0], reps[1],
                                 reqs[1])):
        src.scheduler.submit(req)
        src.pump()  # admit and one fused step
        src.pump()  # one more step mid-flight
        [slot] = list(src.scheduler.active)
        src.migrate_slot_to(slot, dst)
        check(not src.scheduler.busy, "source kept the request")
        while dst.scheduler.busy:
            dst.pump()
        [res] = dst.take_finished()
        check(res.tokens == oracle[req.uid], f"rwkv migration {name}")
        moves[name] = "stream equal"
    router_launches = {n: f.launches for n, f in counters.items()}
    check(router_launches["wkv6_fwd"] == cfg.n_layers * (8 + 2),
          f"rwkv router launches {router_launches}")
    reps[0].state.alloc.check()
    check(reps[0].state.alloc.pages_in_use == 0, "rwkv pages left in use")
    emit("engine_rwkv", card=dev["nvidia_smi"], arch=cfg.name,
         n_layers=cfg.n_layers, params=model_zoo.param_count(cfg),
         weight_init_s=init_s, prefill_tok_s=out["prefill_tok_s"],
         decode_tok_s=out["decode_tok_s"], p50_ms=out["p50_s"] * 1e3,
         p95_ms=out["p95_s"] * 1e3, prefill_calls=len(reqs),
         fused_steps=stats.decode_steps, replay_steps=replay,
         launches=launches, max_memory_allocated=peak,
         wall_ms=out["wall_s"] * 1e3,
         reference_backend={"decode_tok_s": plain["decode_tok_s"],
                            "prefill_tok_s": plain["prefill_tok_s"],
                            "diverged": diverged, "near_tie_gaps": gaps},
         traced_decode_window={"fused_steps": 6, "live_slots": 8,
                               "wall_ms_untraced": wall,
                               "device_busy_ms": busy,
                               "device_idle_share": 1 - busy / wall,
                               "top_kernels_ms": top},
         router={"wall_ms": router_wall * 1e3,
                 "routed": {r.name: r.stats.admitted for r in reps},
                 "admission_waits": reps[0].state.refusals,
                 "migrations": moves, "launches": router_launches})
    return {"serve_rwkv": {"wkv6_fwd": launches["wkv6_fwd"]},
            "router_rwkv": {"wkv6_fwd": router_launches["wkv6_fwd"]}}


def rwkv_train_config(backend: str = "kernel", remat: str = "none"):
    from repro_torch.configs import (BatchWarmupConfig, OptimizerConfig,
                                     SLWConfig, TrainConfig, get_arch)
    tokens = RWKV_STEPS * RWKV_B * S_TRAIN
    return TrainConfig(
        model=get_arch("rwkv6-7b").replace(n_layers=RWKV_LAYERS,
                                           rwkv_backend=backend),
        optimizer=OptimizerConfig(
            lr=6e-4, schedule="token_cosine", warmup_steps=6,
            warmup_tokens=6 * RWKV_B * S_TRAIN, total_steps=RWKV_STEPS,
            total_tokens=tokens),
        slw=SLWConfig(enabled=True, pacing="linear", start_seq_len=8,
                      duration_steps=12, round_multiple=8, max_buckets=12),
        batch_warmup=BatchWarmupConfig(enabled=True, start_batch=4,
                                       warmup_tokens=tokens // 20),
        seq_len=S_TRAIN, global_batch=RWKV_B, seed=SEED, remat=remat,
        eval_interval=RWKV_STEPS)


def _planted_fault():
    """Patches the WKV6 Function's backward so dv comes out of the kernel
    x (1 + RWKV_FAULT): a wrong backward the gradient check must catch."""
    from unittest import mock

    from repro_torch.kernels.rwkv6 import ops
    real = ops.wkv6_bwd

    def faulty(*args, **kw):
        dr, dk, dv, dlw, du = real(*args, **kw)
        return dr, dk, dv * (1 + RWKV_FAULT), dlw, du
    return mock.patch.object(ops, "wkv6_bwd", faulty)


def _leaf_errs(got, ref, scales) -> list:
    """max |got - ref| / max |ref| per leaf; where ref is 0, whether got
    is not."""
    return [(a - r).abs().max().item() / sc if sc
            else float(a.abs().max().item() > 0)
            for a, r, sc in zip(got, ref, scales)]


def _compare_grads_at_eps(model, plain_backend: dict, params, batch,
                          eps: float, limit: float, needs_grad,
                          planted=None, host: bool = False):
    """Every gradient leaf of one batch through the kernels against the
    reference backend's (``model.cfg`` with ``plain_backend``) on the
    card, both with the norms' eps set to ``eps``: each leaf within
    ``limit`` (``math.inf``: reported only) of the largest entry of the
    reference's, and every leaf that ``needs_grad(name)`` with a nonzero
    one.  The kernels run exactly as at the model's eps.  ``host``: also
    the same reference on the host's CPU (other BLAS, other orders of
    summation), reported as the reference's own spread, which shows the
    conditioning without the kernels.  ``planted``: (patch, fields) of a
    wrong backward that must break ``limit``.  Returns (report, {leaf:
    error})."""
    from repro_torch.models import model_zoo
    from repro_torch.optim.transforms import tree_map
    cfg = model.cfg.replace(norm_eps=eps)
    kernel = model_zoo.build_model(cfg, remat=model.remat)
    plain = model_zoo.build_model(cfg.replace(**plain_backend), remat="full")
    names = _leaf_names(params)
    ref = _grads(plain, params, batch)
    scales = [r.abs().max().item() for r in ref]
    rel = dict(zip(names, _leaf_errs(_grads(kernel, params, batch), ref,
                                     scales)))
    torch.cuda.empty_cache()
    for name, sc in zip(names, scales):
        if needs_grad(name):
            check(sc > 0, f"no gradient reaches {name}")
        check(rel[name] <= limit, f"{cfg.name} gradient {name} at eps {eps}: "
                                  f"{rel[name]} > {limit}")
    worst = max(rel, key=rel.get)
    out = {"eps": eps, "limit": limit if math.isfinite(limit) else None,
           "max_rel_err": rel[worst], "worst_leaf": worst}
    if host:
        t0 = time.perf_counter()
        got = _grads(plain, tree_map(lambda t: t.detach().cpu(), params),
                     {k: v.cpu() for k, v in batch.items()})
        out["host_reference_s"] = time.perf_counter() - t0
        out["reference_host_spread"] = max(_leaf_errs(
            got, [r.cpu() for r in ref], scales))
        del got
    if planted is not None:
        patch, fields = planted
        with patch():
            bad = dict(zip(names, _leaf_errs(_grads(kernel, params, batch),
                                             ref, scales)))
        over = sorted(k for k, v in bad.items() if v > limit)
        check(bool(over), f"the eps {eps} check missed a planted {fields}")
        worst = max(bad, key=bad.get)
        out["planted_fault"] = {**fields, "max_rel_err": bad[worst],
                                "worst_leaf": worst,
                                "leaves_over_limit": len(over)}
    del ref
    torch.cuda.empty_cache()
    return out, rel


def _compare_rwkv_grads(model, params, batch, trained: bool, eps: float,
                        limit: float, host: bool = False,
                        fault: bool = False) -> dict:
    """:func:`_compare_grads_at_eps` against rwkv_backend="reference".  A
    leaf whose reference gradient is 0 (w_lora_a while w_lora_b is still
    0) must be 0 through the kernels too; wr, wk, wv need a gradient, and
    w_lora_a too once w_lora_b has moved (``trained``).  ``fault``: the
    planted dv x (1 + RWKV_FAULT).

    Why ``eps``: at the model's eps (1e-5) the fp32 gradient is
    ill-conditioned; the reference itself moves by up to a few 1e-2 of a
    leaf's largest entry between card and host.  The likely cause is the
    per-head GroupNorm, which makes the loss blind to the size of y at a
    sequence's first token, y_0 = (r_0 . (u * k_0)) v_0, so the gradient
    along that direction is rounding noise, amplified where r_0 . (u * k_0)
    is near 0, and it reaches every leaf.  eps enters only the norms, and
    a large one bounds that amplification."""
    leaves = ("wr", "wk", "wv") + (("w_lora_a",) if trained else ())
    out, rel = _compare_grads_at_eps(
        model, {"rwkv_backend": "reference"}, params, batch, eps, limit,
        lambda name: name.split(".")[-1] in leaves,
        (_planted_fault, {"dv_scale": 1 + RWKV_FAULT}) if fault else None,
        host)
    out["w_lora_a_max_rel_err"] = max(v for k, v in rel.items()
                                      if k.endswith("w_lora_a"))
    return out


def check_parity_steps(ptc, init, res, what: str) -> None:
    """Trains ``ptc`` (the kernels' run's config at a reference backend)
    for PARITY_STEPS steps from ``init`` with fresh optimizer state: no
    kernel launches, the plans of ``res``'s first steps, and its losses
    within PARITY_RTOL (``var_max`` reported)."""
    from repro_torch.launch.train import Trainer
    from repro_torch.optim import transforms as optim_tx
    plain_trainer = Trainer(ptc, eval_batch=EVAL_BATCH, device="cuda")
    plain_trainer.state = None
    torch.cuda.empty_cache()
    tx = optim_tx.build_optimizer(ptc.optimizer)
    plain_trainer.state = {
        "params": init, "opt": tx.init(init),
        "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    counters = _zero_counters()
    plain = plain_trainer.run(max_steps=PARITY_STEPS)
    check(all(f.launches == 0 for f in counters.values()),
          f"the reference {what} run launched a kernel")
    n = PARITY_STEPS
    check(plain.seqlen_history == res.seqlen_history[:n]
          and plain.batch_history == res.batch_history[:n]
          and plain.lr_history == res.lr_history[:n], f"{what} parity plans")
    a, b = np.asarray(res.loss_history[:n]), np.asarray(plain.loss_history)
    rel = {"loss_history": float(np.max(np.abs(a - b) / np.abs(b)))}
    check(rel["loss_history"] <= PARITY_RTOL, f"{what} parity losses: {rel}")
    a = np.asarray(res.var_max_history[:n])
    b = np.asarray(plain.var_max_history)
    rel["var_max_history"] = float(np.max(np.abs(a - b) / np.abs(b)))
    emit(f"train_{what}_parity", steps=n, max_rel_err=rel, rtol=PARITY_RTOL,
         checked=["loss_history"], seqlens=plain.seqlen_history,
         batches=plain.batch_history)
    del plain_trainer
    torch.cuda.empty_cache()


def phase_train_rwkv(dev: dict, fwd_checked: set, bwd_checked: set) -> dict:
    """Trains rwkv6-7b at full width cut to 4 layers through the Trainer
    (weights from a CUDA generator seeded with SEED): 20 SLW steps and one
    full-length eval, then 3 full-length steps untraced and 3 under the
    profiler.  Against rwkv_backend="reference": every gradient leaf of the
    first step's batch at the initial weights and of the last step's
    (8 x 1024) at the trained weights, at the norms' eps raised to
    RWKV_GRAD_EPS, and reported only at the model's own and at those of
    RWKV_GRAD_SWEEP (see :func:`_compare_rwkv_grads`),
    then the first 8 steps' losses from the same initial weights.  The reference runs
    with remat "full" (recomputing each block changes no arithmetic): its
    pairwise (B, H, Q, Q, D) decay tensors, kept for autograd, would need
    some 17 GB a layer at 8 x 1024."""
    from repro_torch.core.regulators import predict_trajectory
    from repro_torch.launch.train import Trainer
    from repro_torch.models import model_zoo
    from repro_torch.optim import transforms as optim_tx
    tc = rwkv_train_config()
    trainer = Trainer(tc, eval_batch=RWKV_EVAL, device="cuda")
    init = optim_tx.tree_map(lambda t: t.detach().clone(),
                             trainer.state["params"])
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    res = trainer.run()
    launches = {n: f.launches for n, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    n_layers = tc.model.n_layers

    check(res.steps == RWKV_STEPS and not res.diverged, "rwkv trained 20 "
                                                        "steps")
    check(all(math.isfinite(x) for x in res.loss_history),
          "rwkv finite losses")
    plans = predict_trajectory(tc, RWKV_STEPS)
    ran = list(zip(res.seqlen_history, res.batch_history, res.lr_history))
    check(ran == [(p.seq_len, p.batch_size, p.lr) for p in plans],
          "the rwkv run's plans are predict_trajectory's")
    n_evals = len(res.val_ppl_history)
    check(n_evals == 1, f"{n_evals} rwkv evals")
    want = {n: 0 for n in counters}
    want["wkv6_fwd"] = n_layers * (RWKV_STEPS + n_evals)
    want["wkv6_bwd"] = n_layers * RWKV_STEPS
    check(launches == want, f"rwkv train launches {launches} != {want}")
    shapes = {_wkv_kernel_shape(p.batch_size, p.seq_len) for p in plans}
    check(shapes <= bwd_checked, f"bwd shapes {shapes - bwd_checked}")
    shapes.add(_wkv_kernel_shape(RWKV_EVAL, S_TRAIN))
    check(shapes <= fwd_checked, f"fwd shapes {shapes - fwd_checked}")

    full = [i for i, s in enumerate(res.seqlen_history) if s == S_TRAIN]
    durations = trainer.watchdog.durations
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
    emit("train_rwkv", card=dev["nvidia_smi"], arch=tc.model.name,
         n_layers=n_layers, params=model_zoo.param_count(tc.model),
         steps=res.steps, tokens=res.tokens, full_length_steps=len(full),
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

    # gradients: the kernel model against the reference one, leaf by leaf,
    # at the first step's batch and the initial weights, and at the last
    # step's (full-length) batch and the trained weights
    trained = trainer.state["params"]
    trainer.state = None  # frees the Adam moments
    torch.cuda.empty_cache()
    grads = {}
    for weights, i, is_trained in ((init, 0, False),
                                   (trained, RWKV_STEPS - 1, True)):
        batch, _ = trainer.stack.apply(trainer.pipeline.batch_at(i), plans[i])
        batch = trainer.to_device(batch)
        rows = {"weights": "trained" if is_trained else "initial"}
        for eps in (RWKV_GRAD_EPS, tc.model.norm_eps, *RWKV_GRAD_SWEEP):
            strict = eps == RWKV_GRAD_EPS
            rows[f"eps_{eps:g}"] = _compare_rwkv_grads(
                trainer.model, weights, batch, is_trained, eps,
                GRAD_RTOL if strict else math.inf, host=not is_trained,
                fault=strict)
        grads[f"{len(batch['tokens'])}x{plans[i].seq_len}"] = rows
    emit("train_rwkv_grads", leaves=len(_leaf_names(init)), batches=grads)
    del trained, trainer, weights
    torch.cuda.empty_cache()

    # the first 8 steps with the reference backend from the same weights
    check_parity_steps(rwkv_train_config("reference", remat="full"), init,
                       res, "rwkv")
    del init
    return {"wkv6_fwd": launches["wkv6_fwd"],
            "wkv6_bwd": launches["wkv6_bwd"]}


# ---------------------------------------------------------------------------
# Zamba-2: the SSD kernels, serving and training zamba2-2.7b at full width
# ---------------------------------------------------------------------------

SSD_H, SSD_P, SSD_N, SSD_CHUNK = 80, 64, 64, 128  # zamba2-2.7b's SSD
# training: zamba2-2.7b at full width and depth, remat "full", global batch
# 8 of sequences of 1024, SLW linear from 8 over 12 steps, batch warmup
# from 4, 20 steps, one eval of 8 sequences
ZAMBA_B, ZAMBA_STEPS, ZAMBA_EVAL = 8, 20, 8
# the SSD kernels against their plain versions, fp32: each output within
# this fraction of the plain output's largest entry (fixed before the first
# run: fp32 sums over up to 128 rows and 64 channels in another order)
SSD_RTOL = 1e-4
# cum past -1000 within a chunk (dt near 4, a near -3): its fp32 ulp is
# 6e-5, and a pairwise exponent is a difference of two such sums
SSD_DEEP_RTOL = 2e-3
# a planted fault the zamba gradient check must catch: the backward kernel's
# per-head dB x (1 + this)
SSD_FAULT = 1e-2
# the zamba gradients, kernel path against the reference SSD backend on the
# card: every leaf of two batches within GRAD_RTOL of the leaf's largest
# entry at the norms' eps raised to this, and only reported at the model's
# 1e-5.  At 1e-5 the fp32 gradient of 54 layers and 9 shared-block
# applications is too ill-conditioned for a fixed 1e-4 (PERF.md, section 6,
# Zamba-2): the first run failed there (embed 1.00013e-4) with every kernel
# check passed; the host-vs-card spread of the reference itself, reported
# at 1e-5, shows the conditioning without the kernels.  As for rwkv, eps
# enters only the norms and a large one bounds the amplification
ZAMBA_GRAD_EPS = 1.0


def _ssd_inputs(b, s, dtype, seed, deep: bool = False):
    """x (B, 80, S, 64) in ``dtype``; dt = softplus(N(0, 1)) fp32 and a =
    -exp(N(0, 0.5^2)) (the model at init: dt_bias 0, a_log 0), or with
    ``deep`` dt near 4 and a near -3; B, C (B, S, 64) of scale 0.5."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, SSD_H, s, SSD_P, device="cuda", generator=gen)
    raw = torch.randn(b, SSD_H, s, device="cuda", generator=gen)
    dt = F.softplus(raw + (4.0 if deep else 0.0))
    a = -torch.exp(0.5 * torch.randn(SSD_H, device="cuda", generator=gen))
    a = a - 2.0 if deep else a
    b_in, c_in = (0.5 * torch.randn(b, s, SSD_N, device="cuda",
                                    generator=gen) for _ in range(2))
    return x.to(dtype), dt, a, b_in.to(dtype), c_in.to(dtype)


def _ssd_kernel_shape(b, s):
    return _kernel_shape(b, s, SSD_CHUNK)


def _causal(q: int) -> int:
    return q * (q + 1) // 2


def ssd_fwd_work(b, s, q, elt) -> tuple:
    """(bytes, operations) of one forward call without carries at (B, 80,
    S, 64), chunk q: x, y in ``elt`` bytes, B, C (shared by the heads)
    read once, dt fp32, a, and the fp32 state written once; per chunk and
    head the causal half of the scores and of the intra-chunk product
    (Q (Q + 1) / 2 (N + P) multiply-adds) and one exp per causal pair, the
    carried-state term and the state update (2 Q N P multiply-adds): the
    reference's own count (``benchmarks/bench_kernels.py:104``) with the
    causal half and the exps."""
    h, p, n, nc = SSD_H, SSD_P, SSD_N, s // q
    nbytes = (2 * b * h * s * p * elt + 2 * b * s * n * elt + b * h * s * 4
              + h * 4 + b * h * n * p * 4)
    per_chunk = 2 * _causal(q) * (n + p) + _causal(q) + 4 * q * n * p
    return nbytes, b * h * nc * per_chunk


def ssd_bwd_work(b, s, q) -> tuple:
    """(bytes, operations) of one backward call, fp32: x, dt, B, C, the
    carries, dy, dstate read once, dx, ddt, dlog and the per-head dB, dC
    written once; per chunk and head the causal halves of the scores, of
    M^T dy, of dy xdt^T and of w B and w^T C (Q (Q + 1) / 2 (3 N + 2 P)
    multiply-adds), two exps per causal pair, and six (Q, N, P) products
    (the state terms of dx, dB, dC, u, t2, and the cotangent update)."""
    h, p, n, nc = SSD_H, SSD_P, SSD_N, s // q
    nbytes = (3 * b * h * s * p * 4 + 2 * b * s * n * 4 + 3 * b * h * s * 4
              + b * h * (nc + 1) * n * p * 4 + h * 4
              + 2 * b * h * s * n * 4)
    per_chunk = (2 * _causal(q) * (3 * n + 2 * p) + 2 * _causal(q)
                 + 12 * q * n * p)
    return nbytes, b * h * nc * per_chunk


def check_ssd_fwd(x, dt, a, b_in, c_in, chunk, what, rtol=SSD_RTOL) -> dict:
    from repro_torch.kernels.ssd import ssd_fwd, ssd_fwd_plain
    return check_scan_fwd(ssd_fwd, ssd_fwd_plain, (x, dt, a, b_in, c_in),
                          chunk, what, rtol)


def phase_ssd_fwd(prefills, train_shapes) -> tuple:
    """Holds the forward kernel against its plain version at the serving
    prefills (B 1, S 256/384/512), every (batch, S) of the zamba training
    plan and its eval, one bf16 case, S below a chunk, S off a chunk
    multiple (through the padding wrapper), and cum past -1000 within a
    chunk; times it at the largest prefill and at the full-length batch."""
    from repro_torch.kernels.ssd import ssd, ssd_fwd, ssd_fwd_plain
    errs, checked = {}, set()
    for i, (b, s) in enumerate(sorted(set(prefills) | set(train_shapes))):
        kb, ks, q = _ssd_kernel_shape(b, s)
        errs[f"{b}x{s}"] = check_ssd_fwd(*_ssd_inputs(kb, ks, torch.float32,
                                                      i), q, f"{b}x{s}")
        checked.add((kb, ks, q))
    errs["bf16_2x256"] = check_ssd_fwd(
        *_ssd_inputs(2, 256, torch.bfloat16, 50), SSD_CHUNK, "bf16")
    errs["short_2x40"] = check_ssd_fwd(*_ssd_inputs(2, 40, torch.float32, 51),
                                       40, "S < chunk")
    deep = _ssd_inputs(1, 256, torch.float32, 52, deep=True)
    cum_min = (deep[1][..., :SSD_CHUNK] * deep[2][None, :, None]).sum(
        dim=-1).min().item()
    check(cum_min < -1000, f"deep decay reaches only {cum_min}")
    errs["deep_decay_1x256"] = dict(
        check_ssd_fwd(*deep, SSD_CHUNK, "cum past -1000",
                      rtol=SSD_DEEP_RTOL), cum_min=cum_min)
    # S = 300 through the wrapper: zero-padded to 384, sliced back
    x, dt, a, b_in, c_in = _ssd_inputs(2, 300, torch.float32, 53)
    y, state = ssd(x, dt, a, b_in, c_in, chunk=SSD_CHUNK)
    ry, rstate = ssd_fwd_plain(F.pad(x, (0, 0, 0, 84)), F.pad(dt, (0, 84)),
                               a, F.pad(b_in, (0, 0, 0, 84)),
                               F.pad(c_in, (0, 0, 0, 84)), chunk=SSD_CHUNK)
    torch.cuda.synchronize()
    errs["ragged_2x300"] = {"y": _rel_err(y, ry[:, :, :300]),
                            "state": _rel_err(state, rstate)}
    check(max(errs["ragged_2x300"].values()) <= SSD_RTOL, "ssd S = 300")

    timing = {}
    for key, b, s in (("serve_1x512", 1, max(s for _, s in prefills)),
                      ("train_8x1024", ZAMBA_B, S_TRAIN)):
        b, s, q = _ssd_kernel_shape(b, s)
        x, dt, a, b_in, c_in = _ssd_inputs(b, s, torch.float32, 60)
        nbytes, ops = ssd_fwd_work(b, s, q, 4)
        t_bound, by = bound(nbytes, ops, torch.float32)
        timing[key] = {
            "max_abs_err": (ssd_fwd(x, dt, a, b_in, c_in, chunk=q)[0]
                            - ssd_fwd_plain(x, dt, a, b_in, c_in,
                                            chunk=q)[0]).abs().max().item(),
            **times(lambda: ssd_fwd(x, dt, a, b_in, c_in, chunk=q),
                    lambda: ssd_fwd_plain(x, dt, a, b_in, c_in, chunk=q),
                    plain_queued=False),
            "library_note": "no one PyTorch call computes the SSD scan",
            "bytes": nbytes, "operations": ops, "bound_ms": t_bound,
            "bound_by": by}
        del x, dt, a, b_in, c_in
    torch.cuda.empty_cache()
    emit("ssd_fwd", rel_err=errs, timing=timing,
         shape=f"H={SSD_H} P={SSD_P} N={SSD_N} chunk<={SSD_CHUNK}")
    return timing, checked


def _ssd_function_grads(fn, xs, dy, dstate) -> list:
    """dx, ddt, dA, dB, dC of (y . dy) + (state . dstate) through ``fn``."""
    ts = [t.detach().clone().requires_grad_() for t in xs]
    y, state = fn(*ts)
    return list(torch.autograd.grad((y.float() * dy).sum()
                                    + (state * dstate).sum(), ts))


def check_ssd_bwd(x, dt, a, b_in, c_in, chunk, what) -> dict:
    """Relative errors of dx, ddt, dA, dB and dC through the SSD Function
    (the backward kernel, then the reductions over b, s and H outside it)
    against the plain reverse scan with the same reductions and against
    torch.autograd through the plain forward; nonzero cotangents on y and
    on the final state.  Each within SSD_RTOL of the reference's largest
    entry."""
    from repro_torch.kernels.ssd import (SSD, ssd_bwd_plain, ssd_fwd_plain)
    b, h, s, p = x.shape
    gen = torch.Generator(device="cuda").manual_seed(s + 7)
    dy = torch.randn(b, h, s, p, device="cuda", generator=gen)
    dstate = torch.randn(b, h, SSD_N, p, device="cuda", generator=gen)
    xs = (x, dt, a, b_in, c_in)
    got = _ssd_function_grads(lambda *t: SSD.apply(*t, chunk), xs, dy,
                              dstate)
    _, _, carries = ssd_fwd_plain(*xs, chunk=chunk, return_carries=True)
    dx, ddt, dlog, db_h, dc_h = ssd_bwd_plain(*xs, carries, dy, dstate,
                                              chunk=chunk)
    refs = {"plain": [dx, ddt, torch.einsum("bhs,bhs->h", dt, dlog),
                      db_h.sum(dim=1), dc_h.sum(dim=1)],
            "autograd": _ssd_function_grads(
                lambda *t: ssd_fwd_plain(*t, chunk=chunk), xs, dy, dstate)}
    del carries, dx, ddt, dlog, db_h, dc_h
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"ssd_bwd {what}: non-finite output")
    errs = {}
    for src, ref in refs.items():
        for name, g, e in zip(("dx", "ddt", "dA", "dB", "dC"), got, ref):
            err = _rel_err(g, e)
            check(err <= SSD_RTOL, f"ssd_bwd {name} {what} vs {src}: {err}")
            errs[f"{name}_vs_{src}"] = err
    return errs


def phase_ssd_bwd(train_shapes) -> tuple:
    """Holds the backward kernel, through the SSD Function's reductions,
    against the plain reverse scan and against autograd through the plain
    forward at every (batch, S) of the training plan; times the kernel at
    the full-length batch."""
    from repro_torch.kernels.ssd import ssd_bwd, ssd_bwd_plain, ssd_fwd_plain
    errs, checked = {}, set()
    for i, (b, s) in enumerate(sorted(train_shapes)):
        kb, ks, q = _ssd_kernel_shape(b, s)
        errs[f"{b}x{s}"] = check_ssd_bwd(
            *_ssd_inputs(kb, ks, torch.float32, 100 + i), q, f"{b}x{s}")
        checked.add((kb, ks, q))
        torch.cuda.empty_cache()
    b, s, q = _ssd_kernel_shape(ZAMBA_B, S_TRAIN)
    xs = _ssd_inputs(b, s, torch.float32, 61)
    gen = torch.Generator(device="cuda").manual_seed(62)
    dy = torch.randn(xs[0].shape, device="cuda", generator=gen)
    dstate = torch.randn(b, SSD_H, SSD_N, SSD_P, device="cuda", generator=gen)
    _, _, carries = ssd_fwd_plain(*xs, chunk=q, return_carries=True)
    args = (*xs, carries, dy, dstate)
    nbytes, ops = ssd_bwd_work(b, s, q)
    t_bound, by = bound(nbytes, ops, torch.float32)
    timing = {"train_8x1024": {
        "max_abs_err": max(
            (g - e).abs().max().item() for g, e in zip(
                ssd_bwd(*args, chunk=q), ssd_bwd_plain(*args, chunk=q))),
        **times(lambda: ssd_bwd(*args, chunk=q),
                lambda: ssd_bwd_plain(*args, chunk=q), plain_queued=False),
        "library_note": "no one PyTorch call computes the SSD backward",
        "bytes": nbytes, "operations": ops, "bound_ms": t_bound,
        "bound_by": by}}
    del args, xs, dy, dstate, carries
    torch.cuda.empty_cache()
    emit("ssd_bwd", rel_err=errs, timing=timing)
    return timing, checked


def _zamba_weights():
    """zamba2-2.7b at full depth and width, fp32 weights drawn on the card
    from a CUDA generator seeded with SEED, and the seconds that took."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model_zoo
    cfg = get_arch("zamba2-2.7b")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    params = model_zoo.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED),
        torch.device("cuda"))
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def _replay_steps(reqs, ladder) -> int:
    from repro_torch.serve import prefill_split
    return sum(len(r.tokens) - prefill_split(len(r.tokens), ladder)
               for r in reqs)


def phase_engine_zamba(dev: dict, fwd_checked: set, fd_checked: set,
                       pd_checked: set) -> dict:
    """Serves full-depth, full-width zamba2-2.7b (fp32, weights from a CUDA
    generator seeded with SEED) in 8 slots of 576: 16 requests from
    ``make_requests``, fcfs.  Checks the launch counts (ssd_fwd 54 x
    prefill calls; flash_decode_fwd 9 x (fused + replay steps); no other
    kernel), the greedy streams against the same engine at
    ssm_backend="reference", decode_backend="reference", and serves the
    first 4 requests once more through the router (a paged replica, whose
    shared-block KV lives in pages, and a dense one) and moves one request
    each way between them mid-flight (fewer than the rwkv phase's 8: a
    fused zamba step takes the host ~90 ms)."""
    from repro_torch.launch.serve import make_requests, scheduler_config
    from repro_torch.models import model_zoo
    from repro_torch.serve import Replica, Router, prefill_split
    cfg, params, init_s = _zamba_weights()
    groups = cfg.n_layers // cfg.attn_every
    model = model_zoo.build_model(cfg)
    plain_model = model_zoo.build_model(cfg.replace(
        ssm_backend="reference", decode_backend="reference"))
    reqs = make_requests(cfg, 16, PROMPT_LEN, GEN, seed=SEED)
    # warm-up (first-call costs) and the decode window's load: prompts cut
    # to their prefill bucket, so that no replay step (~90 ms each) runs
    at_bucket = [dataclasses.replace(r, tokens=r.tokens[:prefill_split(
        len(r.tokens), scheduler_config(8, PROMPT_LEN,
                                        PROMPT_LEN + GEN).ladder())])
                 for r in reqs[:8]]
    _serve_model(model, params, [dataclasses.replace(at_bucket[3],
                                                     max_tokens=4)])
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    out = _serve_model(model, params, reqs)
    launches = {n: f.launches for n, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    eng, stats = out["engine"], out["stats"]
    ladder = eng.scheduler.ladder
    replay = _replay_steps(reqs, ladder)
    want = {n: 0 for n in counters}
    want["ssd_fwd"] = cfg.n_layers * len(reqs)
    want["flash_decode_fwd"] = groups * (stats.decode_steps + replay)
    check(launches == want, f"zamba serve launches {launches} != {want}")
    check(all(r.n_generated == q.max_tokens and r.finish_reason == "length"
              for r, q in zip(out["results"], reqs)),
          "every zamba request generated its budget")
    prefills = {_ssd_kernel_shape(1, prefill_split(len(r.tokens), ladder))
                for r in reqs}
    check(prefills <= fwd_checked, f"zamba prefill shapes {prefills} not "
                                   f"all checked in {fwd_checked}")
    cache_len = eng.cfg.cache_len
    check({(8, cache_len, ZAMBA_D), (1, cache_len, ZAMBA_D)} <= fd_checked,
          "zamba decode shapes not checked")
    counters = _zero_counters()
    plain = _serve_model(plain_model, params, reqs)
    check(all(f.launches == 0 for f in counters.values()),
          "the reference backends launched a kernel")
    diverged, gaps = check_streams(reqs, out["results"], plain["results"],
                                   plain["engine"], "zamba")
    plain_rates = {"decode_tok_s": plain["decode_tok_s"],
                   "prefill_tok_s": plain["prefill_tok_s"]}
    del plain
    # device idle share over a steady decode window: the first 8 requests
    # (at their buckets) admitted, 6 fused steps untraced, 6 traced
    cfg_s = lambda **kw: scheduler_config(8, PROMPT_LEN, PROMPT_LEN + GEN,
                                          **kw)
    window = Replica(model, params, cfg_s(), device="cuda")
    for r in at_bucket:
        window.scheduler.submit(r)
    while window.admit():
        pass
    check(len(window.scheduler.active) == 8, "the decode window's slots")
    steps6 = lambda: [window.step() for _ in range(6)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps6()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, names = device_profile(steps6)
    top = {k[:60]: v for k, v in sorted(names.items(),
                                        key=lambda kv: -kv[1])[:6]}
    del window

    # the router: a paged shortest-prompt-first replica (the shared block's
    # attn_k / attn_v in a pool of pages) and a dense fcfs one
    oracle = {r.uid: r.tokens for r in out["results"]}
    paged_kw = dict(paged=True, page_size=PAGE_SIZE, n_pages=N_PAGES)
    reps = [Replica(model, params, cfg_s(policy="shortest-prompt-first",
                                         **paged_kw), device="cuda",
                    name="paged-spf"),
            Replica(model, params, cfg_s(), device="cuda", name="dense")]
    check(reps[0].cache["attn_k"].shape[1:3] == (N_PAGES, PAGE_SIZE),
          "the paged replica's KV is a pool of pages")
    counters = _zero_counters()
    t0 = time.perf_counter()
    routed = Router(reps).run(reqs[:4])
    router_wall = time.perf_counter() - t0
    for r in routed:
        check(r.tokens == oracle[r.uid], f"zamba router uid {r.uid}")
    peak_pages, moves = 0, {}
    for name, src, dst, req in (("dense_to_paged", reps[1], reps[0],
                                 reqs[0]),
                                ("paged_to_dense", reps[0], reps[1],
                                 reqs[1])):
        src.scheduler.submit(req)
        src.pump()  # admit and one fused step
        src.pump()  # one more step mid-flight
        [slot] = list(src.scheduler.active)
        peak_pages = max(peak_pages, reps[0].state.alloc.pages_in_use)
        src.migrate_slot_to(slot, dst)
        peak_pages = max(peak_pages, reps[0].state.alloc.pages_in_use)
        check(not src.scheduler.busy, "source kept the request")
        while dst.scheduler.busy:
            dst.pump()
        [res] = dst.take_finished()
        check(res.tokens == oracle[req.uid], f"zamba migration {name}")
        moves[name] = "stream equal"
    router_launches = {n: f.launches for n, f in counters.items()}
    admitted = reqs[:4] + reqs[:2]
    want = {n: 0 for n in counters}
    want["ssd_fwd"] = cfg.n_layers * len(admitted)
    want["flash_decode_paged_fwd"] = groups * reps[0].stats.decode_steps
    want["flash_decode_fwd"] = groups * (reps[1].stats.decode_steps
                                         + _replay_steps(admitted, ladder))
    check(router_launches == want,
          f"zamba router launches {router_launches} != {want}")
    check(peak_pages > 0, "the paged replica held no page mid-flight")
    check((8, -(-cache_len // PAGE_SIZE), PAGE_SIZE, N_PAGES, ZAMBA_D)
          in pd_checked, "zamba paged shape not checked")
    reps[0].state.alloc.check()
    check(reps[0].state.alloc.pages_in_use == 0, "zamba pages left in use")
    emit("engine_zamba", card=dev["nvidia_smi"], arch=cfg.name,
         n_layers=cfg.n_layers, params=model_zoo.param_count(cfg),
         weight_init_s=init_s, prefill_tok_s=out["prefill_tok_s"],
         decode_tok_s=out["decode_tok_s"], p50_ms=out["p50_s"] * 1e3,
         p95_ms=out["p95_s"] * 1e3, prefill_calls=len(reqs),
         fused_steps=stats.decode_steps, replay_steps=replay,
         launches=launches, max_memory_allocated=peak,
         wall_ms=out["wall_s"] * 1e3,
         reference_backends={**plain_rates, "diverged": diverged,
                             "near_tie_gaps": gaps},
         traced_decode_window={"fused_steps": 6, "live_slots": 8,
                               "wall_ms_untraced": wall,
                               "device_busy_ms": busy,
                               "device_idle_share": 1 - busy / wall,
                               "top_kernels_ms": top},
         router={"wall_ms": router_wall * 1e3,
                 "routed": {r.name: r.stats.admitted for r in reps},
                 "admission_waits": reps[0].state.refusals,
                 "pages_in_use_mid_flight": peak_pages,
                 "table_uploads": reps[0].state.table_uploads,
                 "migrations": moves, "launches": router_launches})
    del reps, model, plain_model, params, eng, out
    torch.cuda.empty_cache()
    return {"serve_zamba": {k: launches[k] for k in
                            ("ssd_fwd", "flash_decode_fwd")},
            "router_zamba": {k: router_launches[k] for k in
                             ("ssd_fwd", "flash_decode_fwd",
                              "flash_decode_paged_fwd")}}


def zamba_train_config(backend: str = "kernel"):
    from repro_torch.configs import (BatchWarmupConfig, OptimizerConfig,
                                     SLWConfig, TrainConfig, get_arch)
    tokens = ZAMBA_STEPS * ZAMBA_B * S_TRAIN
    return TrainConfig(
        model=get_arch("zamba2-2.7b").replace(ssm_backend=backend),
        optimizer=OptimizerConfig(
            lr=6e-4, schedule="token_cosine", warmup_steps=6,
            warmup_tokens=6 * ZAMBA_B * S_TRAIN, total_steps=ZAMBA_STEPS,
            total_tokens=tokens),
        slw=SLWConfig(enabled=True, pacing="linear", start_seq_len=8,
                      duration_steps=12, round_multiple=8, max_buckets=12),
        batch_warmup=BatchWarmupConfig(enabled=True, start_batch=4,
                                       warmup_tokens=tokens // 20),
        seq_len=S_TRAIN, global_batch=ZAMBA_B, seed=SEED, remat="full",
        eval_interval=ZAMBA_STEPS)


def _planted_ssd_fault():
    """Patches the SSD Function's backward so the per-head dB comes out of
    the kernel x (1 + SSD_FAULT): a wrong backward the gradient check must
    catch."""
    from unittest import mock

    from repro_torch.kernels.ssd import ops
    real = ops.ssd_bwd

    def faulty(*args, **kw):
        dx, ddt, dlog, db_h, dc_h = real(*args, **kw)
        return dx, ddt, dlog, db_h * (1 + SSD_FAULT), dc_h
    return mock.patch.object(ops, "ssd_bwd", faulty)


SSM_LEAVES = ("wx", "wb", "wc", "wdt", "a_log", "dt_bias")


def _compare_zamba_grads(model, params, batch, eps: float, limit: float,
                         host: bool = False, fault: bool = False) -> dict:
    """:func:`_compare_grads_at_eps` against ssm_backend="reference", remat
    "full" on both: the Mamba-2 projections, a_log and dt_bias of every
    layer need a gradient.  ``fault``: the planted dB x (1 + SSD_FAULT)."""
    out, _ = _compare_grads_at_eps(
        model, {"ssm_backend": "reference"}, params, batch, eps, limit,
        lambda name: name.split(".")[-1] in SSM_LEAVES,
        (_planted_ssd_fault, {"db_scale": 1 + SSD_FAULT}) if fault else None,
        host)
    return out


def phase_train_zamba(dev: dict, fwd_checked: set, bwd_checked: set) -> dict:
    """Trains zamba2-2.7b at full width and depth through the Trainer
    (remat "full", weights from a CUDA generator seeded with SEED): 20 SLW
    steps and one full-length eval, then 2 full-length steps untraced and
    2 under the profiler (6.5 s each).  Against ssm_backend="reference": every gradient
    leaf of the first step's batch at the initial weights and of the last
    step's (8 x 1024) at the trained weights, at the norms' eps raised to
    ZAMBA_GRAD_EPS with a planted fault that must break the limit, and
    reported only at the model's own; then the first 8 steps' losses from
    the same initial weights.  The weights
    kept for those comparisons wait on the host: two more 9.7 GB copies
    beside the trainer's 38.8 GB of state and its activations would not
    fit on the card."""
    from repro_torch.core.regulators import predict_trajectory
    from repro_torch.launch.train import Trainer
    from repro_torch.models import model_zoo
    from repro_torch.optim import transforms as optim_tx
    tc = zamba_train_config()
    trainer = Trainer(tc, eval_batch=ZAMBA_EVAL, device="cuda")
    to_host = lambda tree: optim_tx.tree_map(
        lambda t: t.detach().to("cpu", copy=True), tree)
    to_card = lambda tree: optim_tx.tree_map(lambda t: t.to("cuda"), tree)
    init = to_host(trainer.state["params"])
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    res = trainer.run()
    launches = {n: f.launches for n, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    n_layers = tc.model.n_layers

    check(res.steps == ZAMBA_STEPS and not res.diverged,
          "zamba trained 20 steps")
    check(all(math.isfinite(x) for x in res.loss_history),
          "zamba finite losses")
    plans = predict_trajectory(tc, ZAMBA_STEPS)
    ran = list(zip(res.seqlen_history, res.batch_history, res.lr_history))
    check(ran == [(p.seq_len, p.batch_size, p.lr) for p in plans],
          "the zamba run's plans are predict_trajectory's")
    n_evals = len(res.val_ppl_history)
    check(n_evals == 1, f"{n_evals} zamba evals")
    # remat "full": each step runs every layer's forward twice (the
    # recompute in the backward launches the kernel again)
    want = {n: 0 for n in counters}
    want["ssd_fwd"] = n_layers * (2 * ZAMBA_STEPS + n_evals)
    want["ssd_bwd"] = n_layers * ZAMBA_STEPS
    check(launches == want, f"zamba train launches {launches} != {want}")
    shapes = {_ssd_kernel_shape(p.batch_size, p.seq_len) for p in plans}
    check(shapes <= bwd_checked, f"bwd shapes {shapes - bwd_checked}")
    shapes.add(_ssd_kernel_shape(ZAMBA_EVAL, S_TRAIN))
    check(shapes <= fwd_checked, f"fwd shapes {shapes - fwd_checked}")

    full = [i for i, s in enumerate(res.seqlen_history) if s == S_TRAIN]
    durations = trainer.watchdog.durations
    full_s = [durations[i] for i in full]
    full_tokens = sum(res.batch_history[i] * S_TRAIN for i in full)

    def steps2():
        for _ in range(2):
            trainer.run_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps2()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, names = device_profile(steps2)
    top = {k[:60]: v for k, v in sorted(names.items(),
                                        key=lambda kv: -kv[1])[:8]}
    emit("train_zamba", card=dev["nvidia_smi"], arch=tc.model.name,
         n_layers=n_layers, params=model_zoo.param_count(tc.model),
         steps=res.steps, tokens=res.tokens, full_length_steps=len(full),
         tokens_per_s_full_length=full_tokens / sum(full_s),
         p50_step_ms_full_length=float(np.median(full_s)) * 1e3,
         first_loss=res.loss_history[0], last_loss=res.loss_history[-1],
         val_ppl=res.val_ppl_history, n_compiles=res.n_compiles,
         launches=launches, max_memory_allocated=peak,
         wall_s=res.wall_time_s,
         traced_2_full_steps={"wall_ms_untraced": wall,
                              "device_busy_ms": busy,
                              "device_idle_share": 1 - busy / wall,
                              "top_kernels_ms": top})

    # gradients: the kernel model against the reference one, leaf by leaf,
    # at the first step's batch and the initial weights, and at the last
    # step's (full-length) batch and the trained weights
    trained = to_host(trainer.state["params"])
    trainer.state = None  # frees the params and the Adam moments
    torch.cuda.empty_cache()
    grads = {}
    for weights, i, is_trained in ((init, 0, False),
                                   (trained, ZAMBA_STEPS - 1, True)):
        batch, _ = trainer.stack.apply(trainer.pipeline.batch_at(i), plans[i])
        batch = trainer.to_device(batch)
        params = to_card(weights)
        grads[f"{len(batch['tokens'])}x{plans[i].seq_len}"] = {
            "weights": "trained" if is_trained else "initial",
            f"eps_{ZAMBA_GRAD_EPS:g}": _compare_zamba_grads(
                trainer.model, params, batch, ZAMBA_GRAD_EPS, GRAD_RTOL,
                fault=True),
            f"eps_{tc.model.norm_eps:g}": _compare_zamba_grads(
                trainer.model, params, batch, tc.model.norm_eps, math.inf,
                host=not is_trained)}
        del params
        torch.cuda.empty_cache()
    emit("train_zamba_grads", leaves=len(_leaf_names(init)),
         norm_eps=tc.model.norm_eps, batches=grads)
    del trained, trainer, weights
    torch.cuda.empty_cache()

    # the first 8 steps with the reference backend from the same weights
    check_parity_steps(zamba_train_config("reference"), to_card(init), res,
                       "zamba")
    del init
    return {"ssd_fwd": launches["ssd_fwd"], "ssd_bwd": launches["ssd_bwd"]}



def main() -> int:
    dev = phase_device()
    phase_fa_design(phase_build())
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
    pd_timing, pd_checked = phase_flash_decode_paged(main_lengths,
                                                     PROMPT_LEN + GEN)
    paged_launches = phase_engine_paged(dev, engine, fa_checked, fd_checked,
                                        pd_checked)
    router_launches = phase_router(engine)
    serve_launches = engine["launches"]
    del engine
    torch.cuda.empty_cache()

    from repro_torch.core.regulators import predict_trajectory
    train_shapes = {(p.batch_size, p.seq_len) for p in predict_trajectory(
        train_config(), TRAIN_STEPS)} | {(EVAL_BATCH, S_TRAIN)}
    bwd_timing, bwd_checked = phase_flash_attention_bwd(train_shapes)
    train = phase_train(dev, bwd_checked)
    phase_train_parity(train)
    train_launches = train["launches"]
    del train
    torch.cuda.empty_cache()
    bf16_launches = phase_grads_bf16()
    torch.cuda.empty_cache()

    from repro_torch.launch.serve import scheduler_config
    from repro_torch.serve import prefill_split
    ladder = scheduler_config(8, PROMPT_LEN, PROMPT_LEN + GEN).ladder()
    rwkv_prefills = {(1, prefill_split(len(r.tokens), ladder))
                     for r in make_requests(get_arch("rwkv6-7b"), 16,
                                            PROMPT_LEN, GEN, seed=SEED)}
    rwkv_train_shapes = {(p.batch_size, p.seq_len) for p in
                         predict_trajectory(rwkv_train_config(), RWKV_STEPS)}
    wkv_fwd_timing, wkv_fwd_checked = phase_wkv6_fwd(
        rwkv_prefills, rwkv_train_shapes | {(RWKV_EVAL, S_TRAIN)})
    wkv_bwd_timing, wkv_bwd_checked = phase_wkv6_bwd(rwkv_train_shapes)
    rwkv_serve = phase_engine_rwkv(dev, wkv_fwd_checked)
    torch.cuda.empty_cache()
    rwkv_train = phase_train_rwkv(dev, wkv_fwd_checked, wkv_bwd_checked)
    torch.cuda.empty_cache()

    zamba_prefills = {(1, prefill_split(len(r.tokens), ladder))
                      for r in make_requests(get_arch("zamba2-2.7b"), 16,
                                             PROMPT_LEN, GEN, seed=SEED)}
    zamba_train_shapes = {(p.batch_size, p.seq_len) for p in
                          predict_trajectory(zamba_train_config(),
                                             ZAMBA_STEPS)}
    ssd_fwd_timing, ssd_fwd_checked = phase_ssd_fwd(
        zamba_prefills, zamba_train_shapes | {(ZAMBA_EVAL, S_TRAIN)})
    ssd_bwd_timing, ssd_bwd_checked = phase_ssd_bwd(zamba_train_shapes)
    zamba_serve = phase_engine_zamba(dev, ssd_fwd_checked, fd_checked,
                                     pd_checked)
    torch.cuda.empty_cache()
    zamba_train = phase_train_zamba(dev, ssd_fwd_checked, ssd_bwd_checked)

    src = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/"
    by_path = {"serve": serve_launches, "serve_paged": paged_launches,
               "router": router_launches, "train": train_launches,
               "grads_bf16": bf16_launches,
               **rwkv_serve, "train_rwkv": rwkv_train, **zamba_serve,
               "train_zamba": zamba_train}
    rows = [("flash_attention_fwd", "flash_attention_fwd.cu",
             "flash_attention/kernel.py:168", fa_timing["float32_1x512"]),
            ("flash_attention_bwd_preprocess", "flash_attention_bwd.cu",
             "flash_attention/kernel.py:310", bwd_timing["preprocess"]),
            ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
             "flash_attention/kernel.py:326", bwd_timing["dq"]),
            ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
             "flash_attention/kernel.py:348", bwd_timing["dkv"]),
            ("flash_decode_fwd", "flash_decode.cu",
             "flash_decode/kernel.py:109", fd_timing["float32_main"]),
            ("flash_decode_paged_fwd", "flash_decode.cu",
             "flash_decode/kernel.py:247", pd_timing["float32_main"]),
            ("wkv6_fwd", "wkv6.cu", "rwkv6/kernel.py:113",
             wkv_fwd_timing["serve_1x512"]),
            ("wkv6_bwd", "wkv6.cu", "rwkv6/kernel.py:235",
             wkv_bwd_timing["train_8x1024"]),
            ("ssd_fwd", "ssd.cu", "ssd/kernel.py:116",
             ssd_fwd_timing["serve_1x512"]),
            ("ssd_bwd", "ssd.cu", "ssd/kernel.py:234",
             ssd_bwd_timing["train_8x1024"])]
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
