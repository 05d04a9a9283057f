#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` from this
checkout, reads the registers, spills and tensor-core (HMMA) instructions
of the kernels redesigned for the tensor cores (flash attention, the SSD
and WKV-6 passes) from ``-Xptxas -v`` and their SASS, and the registers,
stack and spills of every flash-decode instance (none may spill where a
serving path runs it), checks that each decode call at the fused steps'
shapes is one kernel in a trace and gives the same bits twice, holds
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
* the paper's experiments on GPT-2 117M at full width through the same
  kernels: Table 1's baseline at the training run's LR and at 4x, the
  joint SLW recipe and the variance-gated LR throttle at 4x (30 steps
  each; plans against ``predict_trajectory``, the throttle's LRs replayed
  on the host), Table 3's Pearson correlation of the loss ratio with the
  Adam variance max against ``scipy.stats.pearsonr``, and the §4 tuner on
  12-step probes; then the SLW arm again with checkpoints, a crash at step
  15 under a ``TrainSupervisor``, the resume from the step-10 checkpoint
  on the card (steps 11-30 against the uninterrupted arm) and a corrupted
  newest checkpoint quarantined in favour of the one before;
* per-leaf telemetry and the gradient noise scale on GPT-2 117M at full
  width (phase ``telemetry_gns``): the joint recipe with per-leaf
  telemetry and the GNS step (4 emulated shards, the direction sketch
  and the precursor), the same under the ``critical_batch`` regulator
  from 2 rows, and SM3 and Shampoo; the reference's 16 labels, the
  per-leaf vectors recomposing the scalars, the sharded gradient against
  the single pass, one GNS step against the flash kernels' plain
  versions, and the launch counts;
* divergence recovery and fault injection on GPT-2 117M at full width
  (phase ``recovery``): a NaN planted in q, k and v must leave the flash
  kernels' outputs non-finite wherever the plain versions' are; then a
  fault matrix (a stall, a NaN, a parameter spike and a one-block
  gradient spike) survived by rollbacks, the NaN step against its
  plain-kernel twin and the gradient spike against its twin without the
  spike on a cloned state; a rolled-back spike replayed bit for bit, a
  second restore of the snapshot giving the first's bits; a crash between
  a checkpoint's payload and its rename under a supervisor, a drain that
  spills the rollback ring and a resume that refills it bit for bit, NaNs
  rolled back onto a refilled snapshot; and the GNS precursor's events
  snapshotting and cooling the LR; with the ring's snapshot, materialize,
  rollback, spill and load times;
* RWKV-6: the WKV-6 forward and backward kernels against their plain
  versions (and the backward against autograd through the plain forward)
  at every shape the RWKV paths give them, then full-width rwkv6-7b cut
  to 8 of its 32 layers served from 8 slots (launch counts, greedy streams against the
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
  paths give them, cum past -1000 included; then full-width zamba2-2.7b
  cut to 12 of its 54 layers served from 8 slots (launch counts, greedy streams against
  the plain reference backends, the router with a replica whose shared
  attention KV really lives in pages, and a migration each way), and
  trained 36 layers deep with remat "full" for 20 SLW steps (finite
  losses, plans, launch counts, every gradient leaf of two batches and 8
  steps' losses against the reference SSD backend, and a planted fault in
  the backward that the gradient check must catch);
* deepseek-moe-16b (the MoE family): the flash kernels at head dim 128
  (forward at every prefill, forward and backward at every training
  shape), the GQA Function at the other presets' (D, G) and the decode
  kernels, dense and paged, at (128, 1), (128, 4), (128, 6), (64, 3) and
  (80, 8); then the model at full width cut to 14 of its 28 layers (fp32
  weights drawn on the card) served from 8 slots (launch counts, greedy
  streams against a twin engine with the plain backends on the same
  weight tensors, its top-k routing pinned to the kernel engine's, the
  prefills' dropped fraction, the idle share of a decode window), and at
  full width cut to 4 layers trained for 20 SLW steps with remat "full"
  (plans, finite losses, launch counts, the router's metrics a step,
  every gradient leaf of two batches against the blockwise backend under
  pinned routing, and a planted fault in the backward that the gradient
  check must catch); the flash kernels at qwen3-32b's head dim 80 timed;
* the distributed slice on a one-rank NCCL group and a (1, 1) mesh
  (phase ``distributed``): 8 SLW steps of the ``fsdp`` rules' sharded
  train step against the unsharded one from the train phase's initial
  state (every loss and parameter, the flash launch counts),
  ``flash_decode_sharded`` on the decode kernel and 4 virtual sequence
  shards' kernel partials merged on the one card against
  ``reference_decode``, 20 error-feedback compressed all-reduces of a
  gpt2-117m gradient, and ``model_flops`` against ``roofline.op_cost``'s
  count of one 16 x 1024 step with its share of the fp32 peak.
* the paper's GPT-2 1.5B at full width and depth (48 layers, d 1600, 25
  heads of 64; weights drawn on the card): the flash kernels at 25 heads
  (forward at every prefill, forward and backward at every training
  shape, decode at G = 1); 8 SLW steps of 8 x 1024 and one eval through
  the Trainer under remat "dots" (plans, finite losses, each layer's
  forward kernel launched twice a step); the remat policies "none",
  "dots" and "full" side by side on one 4 x 1024 batch (peak memory,
  time, the "dots" and "full" gradients against "none"'s); then 8
  requests of up to 512 tokens served on the trained weights, 32 greedy
  tokens each, against a plain twin on the same weight tensors.  The
  rwkv6-7b and zamba2-2.7b serving phases end with one loss-and-gradient
  pass under remat "none" and "dots" on their weights (``remat_dots_*``:
  gradients bit-equal, the forward kernels' launches doubled).
* the fused AdamW kernel (phase ``fused_adamw``): one step of the default
  chain's fused route over every parameter leaf of deepseek-moe-16b's
  benchmark stage (4 layers, 2.771 B parameters) and of gpt2-1.5b (1.559
  B), timed against its bound (8 N x 4 bytes at 3.35 TB/s) and the chain
  it replaces, with the memory each allocates beyond the state.

A NaN planted in q, k or v must leave the flash forward and backward
kernels' and the two decode kernels' outputs non-finite wherever their
plain versions' are (``check_nan_propagation``,
``check_decode_nan_propagation``).

Phases print one line each.  The second-to-last line lists each kernel
with its error, times and bound; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the run
exits non-zero and prints no result.  Imports nothing of JAX or of the
JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
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

from repro_torch.roofline import hw  # noqa: E402

# the H100 SXM's data-sheet peaks (``repro_torch.roofline.hw``): HBM
# bytes/s; dense FLOP/s by input type (fp32 on the CUDA cores, bf16 and
# TF32 on the tensor cores)
HBM_BYTES_S = hw.HBM_BW
PEAK_FLOPS = {torch.float32: hw.PEAK_FLOPS_FP32,
              torch.bfloat16: hw.PEAK_FLOPS_BF16}
TF32_FLOPS = hw.PEAK_FLOPS_TF32
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
    TF32 products (error-compensated TF32: the flash-attention, SSD and
    WKV-6 kernels)."""
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
# the SSD kernels' tensor-core passes (the state passing between them is
# elementwise on the CUDA cores): chunk-local states, then the outputs
SSD_TENSOR_CORE_KERNELS = {"ssd": ("ssd_chunk_state_kernel",
                                   "ssd_fwd_out_kernel",
                                   "ssd_bwd_out_kernel")}
# the same passes of the WKV-6 kernels, each in three dtype instances (r, k,
# v / log_w: template argument 0, 1, 2)
WKV_TENSOR_CORE_KERNELS = {"wkv6": ("wkv6_chunk_state_kernel",
                                    "wkv6_fwd_out_kernel",
                                    "wkv6_bwd_out_kernel")}
WKV_DTYPES = ("f32/f32", "bf16/f32", "bf16/bf16")


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
    """``kernel<f32|bf16, D>`` from a mangled template instance name; the
    SSD kernels ``kernel<f32|bf16>``, the chunk-state pass with its
    direction; the WKV-6 kernels ``kernel<r/log_w dtypes>`` (and the
    direction)."""
    if kernel.startswith("wkv6_"):
        dt = WKV_DTYPES[int(re.search(r"ILi(\d)E", mangled).group(1))]
        if kernel == "wkv6_chunk_state_kernel":
            return f"{kernel}<{dt},{'fwd' if 'Lb1E' in mangled else 'bwd'}>"
        return f"{kernel}<{dt}>"
    t = "bf16" if "bfloat16" in mangled else "f32"
    if kernel.startswith("ssd_"):
        if kernel == "ssd_chunk_state_kernel":
            return f"{kernel}<{t},{'fwd' if 'Lb1E' in mangled else 'bwd'}>"
        return f"{kernel}<{t}>"
    d = re.search(r"Li(\d+)E", mangled).group(1)
    return f"{kernel}<{t},{d}>"


def _tensor_core_instances(build: dict, table: dict) -> dict:
    """{instance: HMMA count, kinds, ptxas line} of every instance of the
    kernels ``table`` names, from the built libraries' SASS."""
    found = {}
    for lib_name, kernels in table.items():
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
    return found


def phase_fa_design(build: dict) -> dict:
    """Each instance of the kernels redesigned for the tensor cores (flash
    attention, and the SSD and WKV-6 passes that run products): the
    registers and spills ``-Xptxas -v`` reported and the tensor-core (HMMA)
    instructions in its SASS.  Fails if one has none, or if its SASS cannot
    be read."""
    found = _tensor_core_instances(build, FA_TENSOR_CORE_KERNELS)
    want = {f"{k}<{t},{d}>" for ks in FA_TENSOR_CORE_KERNELS.values()
            for k in ks for t in ("f32", "bf16") for d in (64, 80, 128)}
    check(set(found) == want, f"kernel instances {sorted(found)} != "
                              f"{sorted(want)}")
    ssd = _tensor_core_instances(build, SSD_TENSOR_CORE_KERNELS)
    want = {f"ssd_chunk_state_kernel<{t},{d}>" for t in ("f32", "bf16")
            for d in ("fwd", "bwd")} | {
        f"{k}<{t}>" for k in ("ssd_fwd_out_kernel", "ssd_bwd_out_kernel")
        for t in ("f32", "bf16")}
    check(set(ssd) == want, f"ssd kernel instances {sorted(ssd)} != "
                            f"{sorted(want)}")
    wkv = _tensor_core_instances(build, WKV_TENSOR_CORE_KERNELS)
    want = {f"wkv6_chunk_state_kernel<{t},{d}>" for t in WKV_DTYPES
            for d in ("fwd", "bwd")} | {
        f"{k}<{t}>" for k in ("wkv6_fwd_out_kernel", "wkv6_bwd_out_kernel")
        for t in WKV_DTYPES}
    check(set(wkv) == want, f"wkv6 kernel instances {sorted(wkv)} != "
                            f"{sorted(want)}")
    for name, v in {**found, **ssd, **wkv}.items():
        check(v["hmma"] > 0, f"{name}: no tensor-core instruction in SASS")
    emit("fa_design", kernels=found, ssd_kernels=ssd, wkv6_kernels=wkv)
    return found


# the flash-decode kernel's instances: decode_kernel<T, D, G, PAGED>
DECODE_INSTANCE = re.compile(
    r"decode_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELb([01])E")
PTXAS_USE = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads.*Used (\d+) registers")
# the instances the serving paths run: fp32, G 1, gpt2's D 64 and zamba2's
# D 80, dense and paged; deepseek-moe-16b's D 128, dense
DECODE_PATH_INSTANCES = {f"decode_kernel<f32,{d},1,{kind}>" for d in (64, 80)
                         for kind in ("dense", "paged")} | {
    "decode_kernel<f32,128,1,dense>"}  # deepseek-moe-16b's


def phase_decode_design(build: dict) -> dict:
    """Registers, stack frame and spills of every flash-decode instance from
    ``-Xptxas -v``; fails on a stack frame or a spill in an instance a
    serving path runs, or if the build's ptxas lines were not captured."""
    info = build["ptxas"].get("flash_decode", {})
    found = {}
    for mangled, line in info.items():
        inst, use = DECODE_INSTANCE.search(mangled), PTXAS_USE.search(line)
        if inst is None:
            continue
        t, d, g, paged = inst.groups()
        name = (f"decode_kernel<{'f32' if t == 'f' else 'bf16'},{d},{g},"
                f"{'paged' if paged == '1' else 'dense'}>")
        check(use is not None, f"{name}: no ptxas usage line in {line!r}")
        stack, spill_st, spill_ld, regs = map(int, use.groups())
        found[name] = {"registers": regs, "stack_bytes": stack,
                       "spill_store_bytes": spill_st,
                       "spill_load_bytes": spill_ld}
    check(len(found) == 2 * 3 * 6 * 2, f"{len(found)} flash-decode instances "
          f"in the build log, want 72 (a prebuilt library logs none: remove "
          f"build/repro_torch_kernels)")
    for name in DECODE_PATH_INSTANCES:
        v = found[name]
        check(v["stack_bytes"] == 0 and v["spill_store_bytes"] == 0
              and v["spill_load_bytes"] == 0, f"{name} spills: {v}")
    emit("decode_design", path_instances=sorted(DECODE_PATH_INSTANCES),
         kernels=found)
    return found


def kernels_in_trace(fn, calls: int, attempts: int = 3) -> list:
    """Names of the device kernels ``calls`` calls of ``fn`` ran, from a
    CUDA-only ``torch.profiler`` trace: the kernels between two spin
    kernels (``torch.cuda._sleep``) launched around the calls, in start
    order, so that records of earlier kernels a trace may carry do not
    count.  A trace without both spin kernels is taken again."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted((e.start_ns(), e.name())
                        for e in prof.profiler.kineto_results.events()
                        if e.device_type() == cuda)
        marks = [i for i, (_, name) in enumerate(events)
                 if "spin_kernel" in name]
        if len(marks) >= 2:
            return [name for _, name in events[marks[-2] + 1:marks[-1]]]
    raise RuntimeError(f"check failed: no trace of {attempts} held both "
                       f"spin kernels around the calls")


def check_one_launch(fn, what: str, calls: int = 10) -> str:
    """Each wrapper call is one kernel, ``decode_kernel``, in a trace."""
    names = kernels_in_trace(fn, calls)
    check(len(names) == calls and all("decode_kernel" in n for n in names),
          f"{what}: {calls} calls ran {names}")
    return names[0]


def check_rerun(fn, what: str) -> bool:
    """Two calls on the same inputs give the same bits (no atomics)."""
    first, again = fn(), fn()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"{what}: two runs differ")
    return True


def _attn_inputs(b, s, dtype, seed, h=H, d=D):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b * h, s, d, device="cuda", generator=gen).to(dtype)
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
    """Checks the kernel on an edge-case cache of 1024 (G 1, 3 and 4, and
    G 6 at head dim 128) and at the serving path's shapes: the fused step's
    8 slots at ``main_lengths`` and a prompt's replay, one slot, both over
    ``cache_len``; the same at zamba2's head dim 80 (32 heads, G 1), with
    a ragged set of lengths off multiples of 32 besides.  Times it at 1024,
    on the fused step, and on zamba2's fused step."""
    lengths = [0, 1, 127, 128, 1000, 1024, 600, 5]
    cases = [(8, 1024, g, lengths) for g in (1, 3, 4)] + [
        (8, cache_len, 1, main_lengths), (1, cache_len, 1, [cache_len - 149])]
    zamba = [(8, cache_len, main_lengths), (1, cache_len, [cache_len - 149]),
             (8, cache_len, [0, 1, 31, 129, cache_len, 300, 545, 77])]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, s, g, ln) in enumerate(cases):
            key = f"{str(dtype)[6:]}_{b}x{s}_g{g}"
            errs[key] = check_decode(*_decode_inputs(b, s, g, dtype, ln, i),
                                     key)
        # G 6 at D 128 (qwen2-1.5b's grouping)
        key = f"{str(dtype)[6:]}_8x1024_g6_d128"
        errs[key] = check_decode(*_decode_inputs(8, 1024, 6, dtype, lengths,
                                                 10, H, 128), key)
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
    page sizes 16 and 64, G 1, 3 and 4 (and G 6 at head dim 128), over
    lengths 0, 1, one page, one past a page and the full table, with -1
    inside rows (past the length and inside it) and at their tails, and at
    the paged engine's shape: 8 slots, 9 pages of 64, a pool of 48.  Times
    the engine's shape."""
    errs, checked = {}, set()
    for dtype in (torch.float32, torch.bfloat16):
        for ps in (16, 64):
            mp = -(-cache_len // ps)
            lengths = [0, 1, ps, ps + 1, mp * ps, 2 * ps + 5, 1, 2 * ps]
            for g, d in ((1, D), (3, D), (4, D), (6, 128)):
                key = f"{str(dtype)[6:]}_ps{ps}_g{g}" + (
                    f"_d{d}" if d != D else "")
                # row 5: a hole inside its length; row 6: no page at all;
                # row 7: a hole past its length, then an owned page
                q, k, v, table, lens = _paged_inputs(
                    lengths, ps, mp, 64, g, dtype, ps + g,
                    holes=[(5, 1), (6, 0)], d=d)
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


def phase_decode_launches(main_lengths, cache_len: int) -> dict:
    """At the gpt2 and zamba2 fused steps' shapes, dense and paged: two
    calls of each decode kernel give the same bits, and each call is one
    kernel in a ``torch.profiler`` trace.  Runs before any long trace: a
    trace of a few kernels taken after one of a whole engine run came back
    empty."""
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_paged_fwd)
    lengths, free = paged_main_lengths(main_lengths)
    mp = -(-cache_len // PAGE_SIZE)
    out = {}
    for key, h, d in (("float32_main", H, D),
                      ("float32_zamba_main", ZAMBA_H, ZAMBA_D)):
        for kind, call in (
                ("dense", functools.partial(flash_decode_fwd, *_decode_inputs(
                    8, cache_len, 1, torch.float32, main_lengths, 4, h, d))),
                ("paged", functools.partial(
                    flash_decode_paged_fwd, *_paged_inputs(
                        lengths, PAGE_SIZE, mp, N_PAGES, 1, torch.float32, 7,
                        holes=[(i, 0) for i in free], h=h, d=d)))):
            what = f"{kind} {key}"
            out[f"{kind}_{key}"] = {
                "bitwise_identical_reruns": check_rerun(call, what),
                "trace_kernel": check_one_launch(call, what)}
    emit("decode_launches", **out)
    return out


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


def _bwd_bounds(bh: int, s: int, tensor_cores: bool = True,
                d: int = D) -> dict:
    """(least ms, what bounds it) of each backward kernel and of all three,
    fp32, causal over the whole length: each input read once and each
    output written once; 2 D operations per (query, key) pair below the
    diagonal for each product a kernel does (dQ kernel: S, dP, dQ; dK/dV
    kernel: S, dP, dV, dK; five distinct), as three TF32 products on the
    tensor cores (:func:`tc_bound`) or on the CUDA cores.  The delta
    kernel runs on the CUDA cores."""
    row, tile = bh * s * 4, bh * s * d * 4
    pair_ops = 2 * d * _causal_pairs(bh, s)
    f32 = torch.float32
    bound_fn = (tc_bound if tensor_cores
                else lambda nbytes, flops: bound(nbytes, flops, f32))
    return {"preprocess": bound(2 * tile + row, 2 * bh * s * d, f32),
            "dq": bound_fn(5 * tile + 2 * row, 3 * pair_ops),
            "dkv": bound_fn(6 * tile + 2 * row, 4 * pair_ops),
            "all": bound_fn(8 * tile + row, 5 * pair_ops + 2 * bh * s * d)}


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


def _adamw():
    from repro_torch.kernels.fused_adamw import fused_adamw
    return fused_adamw


def _train_kernels():
    """The counters a training phase resets and reads: the flash-attention
    kernels' and the fused AdamW kernel's."""
    return {**_fa_kernels(), "fused_adamw": _adamw()}


def _fused_launches(tc, steps: int) -> int:
    """Launches of the fused AdamW kernel in ``steps`` optimizer steps of
    ``tc``: one a step where its chain has the fused route, else none."""
    from repro_torch.optim.transforms import build_optimizer
    return steps if build_optimizer(tc.optimizer).fused is not None else 0


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
    kernels = _train_kernels()
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
    want = _want_launches(n_layers, TRAIN_STEPS, n_evals,
                          _fused_launches(tc, TRAIN_STEPS))
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
         val_ppl=res.val_ppl_history,
         launches=launches, max_memory_allocated=peak,
         wall_s=res.wall_time_s,
         traced_3_full_steps={"wall_ms_untraced": wall,
                              "device_busy_ms": busy,
                              "device_idle_share": 1 - busy / wall,
                              "top_kernels_ms": top,
                              "flash_kernels_ms": fa_ms})
    return {"init": init, "result": res, "launches": launches,
            "tokens_per_s": full_tokens / sum(full_s), "peak": peak}


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
    adamw = _adamw().launches
    plain = trainer.run(max_steps=PARITY_STEPS)
    check({name: f.launches for name, f in kernels.items()} == before,
          "the blockwise run launched a flash-attention kernel")
    adamw = _adamw().launches - adamw
    check(adamw == _fused_launches(tc, PARITY_STEPS),
          f"the blockwise run launched the fused AdamW kernel {adamw} times")
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

# the paper's experiments at full width (Table 1, Fig. 1 / Table 3, §4):
# four arms of PAPER_STEPS steps on train_config()'s shapes, the aggressive
# ones at 4x its LR; then the low-cost tuner on short probes of the joint
# recipe at that LR
PAPER_STEPS = TRAIN_STEPS
PAPER_LR = 4 * 6e-4
PROBE_STEPS, PROBE_EVAL, PROBE_WARMUP = 12, 4, 3
PROBE_GRID, PROBE_T_RANGE = (8, 32, 128), (1, 4)
# the checkpoint phase: slw_4x under a supervisor, a crash mid-warmup
CKPT_INTERVAL, CKPT_KEEP, CKPT_FAIL = 10, 3, 15
# a resumed step's loss against the uninterrupted run's (fixed before the
# first run: the same inputs through the same kernels on one card give the
# same bits; this is the room allowed if an op of the step is not
# bit-reproducible, its cause to be written down)
RESUME_RTOL = 1e-6
# Pearson's p against scipy.stats.pearsonr (both float64)
PEARSON_RTOL = 1e-9


def paper_arms() -> dict:
    """name -> TrainConfig of phase ``paper``'s arms: the baseline at
    train_config()'s LR and at 4x (no SLW, no batch warmup: every step
    16 x 1024), the joint recipe of train_config() at 4x, and the 4x
    baseline with the variance-gated LR throttle."""
    from repro_torch.launch import paper
    base = train_config()
    four = lambda tc: dataclasses.replace(tc, optimizer=dataclasses.replace(
        tc.optimizer, lr=PAPER_LR))
    plain = dataclasses.replace(
        base, slw=dataclasses.replace(base.slw, enabled=False),
        batch_warmup=dataclasses.replace(base.batch_warmup, enabled=False))
    return {"baseline": plain, "baseline_4x": four(plain),
            "slw_4x": four(base), "throttle_4x": paper.with_throttle(
                four(plain))}


def probe_base():
    """The tuner's probe: the joint recipe at PAPER_LR for PROBE_STEPS steps
    with PROBE_WARMUP steps of LR warmup (the tuner sets its SLW)."""
    base = paper_arms()["slw_4x"]
    return dataclasses.replace(base, optimizer=dataclasses.replace(
        base.optimizer, warmup_steps=PROBE_WARMUP,
        warmup_tokens=PROBE_WARMUP * B_TRAIN * S_TRAIN,
        total_steps=PROBE_STEPS,
        total_tokens=PROBE_STEPS * B_TRAIN * S_TRAIN))


def probe_configs() -> list:
    """Every config the tuner can probe on its finite grid."""
    base = probe_base()
    return [dataclasses.replace(base, slw=dataclasses.replace(
        base.slw, enabled=True, start_seq_len=s0, duration_steps=m * PROBE_WARMUP))
            for s0 in PROBE_GRID
            for m in range(PROBE_T_RANGE[0], PROBE_T_RANGE[1] + 1)]


def paper_shapes() -> set:
    """Every (batch, seq) phases ``paper`` and ``checkpoint`` can run."""
    from repro_torch.core.regulators import predict_trajectory
    runs = [(tc, PAPER_STEPS) for tc in paper_arms().values()]
    runs += [(tc, PROBE_STEPS) for tc in probe_configs()]
    return {(p.batch_size, p.seq_len) for tc, n in runs
            for p in predict_trajectory(tc, n)} | {(EVAL_BATCH, S_TRAIN)}


def _run_shapes(res) -> set:
    return set(zip(res.batch_history, res.seqlen_history)) | {
        (EVAL_BATCH, S_TRAIN)}


def _want_launches(n_layers: int, steps: int, evals: int,
                   fused: int) -> dict:
    """The :func:`_train_kernels` counts of ``steps`` training passes and
    ``evals`` evals of ``n_layers`` layers and ``fused`` fused AdamW
    steps."""
    want = {name: n_layers * steps for name in _fa_kernels()}
    want["flash_attention_fwd"] += n_layers * evals
    want["fused_adamw"] = fused
    return want


def phase_paper(dev: dict, checked: set) -> dict:
    """Table 1's arms at full width, the Table 3 correlation of the 4x
    baseline and the §4 tuner on short probes, on the flash kernels."""
    from repro_torch.core.regulators import (StepPlan, StepTelemetry,
                                             VarianceLRThrottle,
                                             predict_trajectory)
    from repro_torch.core.tuning import tune_slw
    from repro_torch.launch import paper
    from repro_torch.launch.train import TrainerHook
    from scipy import stats

    class KeepParams(TrainerHook):
        def on_run_end(self, tr):
            self.params = tr.state["params"]

    kernels = _train_kernels()
    n_layers = train_config().model.n_layers
    for f in kernels.values():
        f.launches = 0
    arms, results, steps, evals, fused = {}, {}, 0, 0, 0
    keep = KeepParams()
    for name, tc in paper_arms().items():
        hooks = [keep] if name == "slw_4x" else None
        _, res, wall = paper.run_arm(name, tc, "cuda", eval_batch=EVAL_BATCH,
                                     hooks=hooks)
        steps += res.steps
        evals += len(res.val_ppl_history)
        fused += _fused_launches(tc, res.steps)
        check(res.steps == PAPER_STEPS, f"{name}: {res.steps} steps")
        check(_run_shapes(res) <= checked, f"{name}: shapes "
              f"{_run_shapes(res) - checked} not checked")
        results[name] = res
        arms[name] = paper.arm_stats(res, wall)
        torch.cuda.empty_cache()
    for name in ("baseline", "baseline_4x", "slw_4x"):
        plans = [(p.seq_len, p.batch_size, p.lr) for p in
                 predict_trajectory(paper_arms()[name], PAPER_STEPS)]
        ran = list(zip(results[name].seqlen_history,
                       results[name].batch_history,
                       results[name].lr_history))
        check(ran == plans, f"{name}: the executed plans are "
              "predict_trajectory's")
    check(all(math.isfinite(x) for x in results["slw_4x"].loss_history),
          "slw_4x: finite losses")

    # the throttle's LRs: the scheduled LR times the scale a fresh
    # throttle computes on the host from the arm's own var_max, exactly
    tc = paper_arms()["throttle_4x"]
    sched = predict_trajectory(paper_arms()["baseline_4x"], PAPER_STEPS)
    res = results["throttle_4x"]
    replay = VarianceLRThrottle(tc.regulators[-1])
    scales = []
    for plan, lr, v in zip(sched, res.lr_history, res.var_max_history):
        got = replay.plan(StepTelemetry(), StepPlan(
            seq_len=plan.seq_len, batch_size=plan.batch_size, lr=plan.lr))
        check(got.lr == lr, f"throttle_4x: lr {lr} != replayed {got.lr}")
        scales.append(replay.scale)
        replay.observe(StepTelemetry(var_max=v), 0)
    arms["throttle_4x"].update(throttled_steps=sum(s < 1.0 for s in scales),
                               min_scale=min(scales))

    # Table 3: Pearson(loss ratio, var_max) of the 4x baseline
    base4 = results["baseline_4x"]
    r, p = paper.correlation(base4)["var_max"]
    ratios = paper.loss_ratios(base4)
    ref = stats.pearsonr(ratios, np.asarray(base4.var_max_history))
    p_rel = abs(p - float(ref[1])) / float(ref[1])
    check(p_rel <= PEARSON_RTOL, f"pearson p {p} vs scipy {ref[1]}")
    r_l1, p_l1 = paper.correlation(base4)["var_l1"]

    # §4: the low-cost tuner, each probe PROBE_STEPS steps
    probes = []
    tuned = tune_slw(paper.tuner_probe(probe_base(), PROBE_EVAL, "cuda",
                                       runs=probes),
                     probe_base().slw, warmup_steps=PROBE_WARMUP,
                     seqlen_s_grid=PROBE_GRID,
                     t_multiple_range=PROBE_T_RANGE)
    check(tuned.probe_runs <= len(PROBE_GRID) + 3,
          f"{tuned.probe_runs} probes")
    for res in probes:
        check(res.steps == PROBE_STEPS, f"probe: {res.steps} steps")
        check(_run_shapes(res) <= checked,
              f"probe: shapes {_run_shapes(res) - checked} not checked")
        steps += res.steps
        evals += len(res.val_ppl_history)
        fused += _fused_launches(probe_base(), res.steps)
    launches = {name: f.launches for name, f in kernels.items()}
    want = _want_launches(n_layers, steps, evals, fused)
    check(launches == want, f"paper launches {launches} != {want}")
    probe_tokens = sum(res.tokens for res in probes)
    emit("paper", card=dev["nvidia_smi"], steps=PAPER_STEPS, lr=PAPER_LR,
         arms=arms,
         pearson_baseline_4x={"var_max": {"r": r, "p": p,
                                          "scipy_p": float(ref[1]),
                                          "p_rel_err": p_rel},
                              "var_l1": {"r": r_l1, "p": p_l1}},
         tuner={"trials": tuned.trials, "seqlen_s": tuned.seqlen_s,
                "duration": tuned.duration, "probe_runs": tuned.probe_runs,
                "probe_tokens": probe_tokens,
                "probe_share_of_slw_4x": probe_tokens
                / results["slw_4x"].tokens,
                "probe_val_ppl": [[p for _, p in res.val_ppl_history]
                                  for res in probes]},
         launches=launches)
    return {"launches": launches, "slw_4x": results["slw_4x"],
            "slw_4x_params": keep.params}


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


def phase_checkpoint(dev: dict, paper_out: dict, checked: set) -> dict:
    """The joint recipe at 4x with checkpoints every CKPT_INTERVAL steps
    under a supervisor, a crash at step CKPT_FAIL, the resume from the
    step-10 checkpoint on the card, then a corrupted newest checkpoint
    quarantined in favour of the one before."""
    import shutil
    import tempfile
    from repro_torch import bridge
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.fault_tolerance import (RetryPolicy,
                                                         TrainSupervisor)
    from repro_torch.launch.train import Trainer

    kernels = _train_kernels()
    for f in kernels.values():
        f.launches = 0
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tc = dataclasses.replace(
            paper_arms()["slw_4x"], checkpoint_dir=ckpt_dir,
            checkpoint_interval=CKPT_INTERVAL, keep_checkpoints=CKPT_KEEP)
        saves, attempts = [], []

        def run(resume: bool) -> str:
            tr = Trainer(tc, eval_batch=EVAL_BATCH, stop_on_nan=False,
                         fail_at_step=None if resume else CKPT_FAIL,
                         device="cuda")
            save = tr.save_checkpoint

            def timed_save():
                t0 = time.perf_counter()
                save()
                saves.append((tr.step, time.perf_counter() - t0))
            tr.save_checkpoint = timed_save
            try:
                t0 = time.perf_counter()
                restored = tr.resume() if resume else None
                attempts.append({"resume": resume, "restored": restored,
                                 "restore_s": time.perf_counter() - t0,
                                 "device": str(tr.state["params"]["embed"]
                                               .device)})
                steps0 = tr.step
                res = tr.run()
                attempts[-1].update(result=res, first_step=steps0,
                                    params=tr.state["params"])
                return f"ok:{res.steps}"
            finally:
                # timed_save refers to tr: without this the cycle keeps the
                # trainer's state on the card until a full collection
                del tr.save_checkpoint

        sup = TrainSupervisor(policy=RetryPolicy(max_retries=1))
        out = sup.run(run)
        launches = {name: f.launches for name, f in kernels.items()}
        check(out == f"ok:{PAPER_STEPS}", f"supervised run: {out}")
        check(sup.restarts == 1 and [f["error"] for f in sup.failures] == [
            f"RuntimeError: injected failure at step {CKPT_FAIL}"],
            f"failures {sup.failures}")
        last = attempts[-1]
        check(last["restored"] == CKPT_INTERVAL and last["first_step"]
              == CKPT_INTERVAL, f"resumed from {last['restored']}")
        check(last["device"].startswith("cuda"), "restored onto the card")
        res = last["result"]
        ref = paper_out["slw_4x"]
        n = PAPER_STEPS - CKPT_INTERVAL
        check(_run_shapes(res) <= checked, "checkpoint shapes not checked")
        plans = lambda r, lo: list(zip(r.seqlen_history[lo:],
                                       r.batch_history[lo:],
                                       r.lr_history[lo:]))
        check(len(res.loss_history) == n
              and plans(res, 0) == plans(ref, CKPT_INTERVAL),
              "resumed plans != the uninterrupted run's")
        a = np.asarray(res.loss_history)
        b = np.asarray(ref.loss_history[CKPT_INTERVAL:])
        loss_rel = float(np.max(np.abs(a - b) / np.abs(b)))
        check(loss_rel <= RESUME_RTOL, f"resumed losses: {loss_rel}")
        from repro_torch.optim.transforms import tree_leaves
        params_err = max((x - y).abs().max().item() for x, y in zip(
            tree_leaves(last["params"]),
            tree_leaves(paper_out["slw_4x_params"])))
        # the steps run: CKPT_FAIL before the crash, n after, one eval
        want = _want_launches(train_config().model.n_layers,
                              CKPT_FAIL + n, len(res.val_ppl_history),
                              _fused_launches(tc, CKPT_FAIL + n))
        check(launches == want, f"checkpoint launches {launches} != {want}")
        steps_saved = sorted(s for s, _ in saves)
        check(steps_saved == [10, 20, 30], f"saved at {steps_saved}")
        newest = Path(ckpt_dir) / f"step_{PAPER_STEPS:012d}"
        nbytes = _dir_bytes(newest)
        n_leaves = len(list(newest.glob("*.npy")))
        disk = sum(_dir_bytes(p) for p in Path(ckpt_dir).iterdir())
        check(disk < 5e9, f"{disk} bytes on disk")

        # a flipped byte in the newest checkpoint's largest leaf
        largest = max(newest.glob("*.npy"), key=lambda f: f.stat().st_size)
        with open(largest, "r+b") as f:
            f.seek(-1, 2)
            byte = f.read(1)[0]
            f.seek(-1, 2)
            f.write(bytes([byte ^ 0xFF]))
        mgr = CheckpointManager(ckpt_dir, CKPT_KEEP)
        t0 = time.perf_counter()
        step, tree, host = mgr.restore_latest(
            bridge.abstract_train_state(tc.model, tc.optimizer))
        restore_s = time.perf_counter() - t0
        check(step == 2 * CKPT_INTERVAL and [q[0] for q in mgr.quarantined]
              == [PAPER_STEPS] and "crc32" in mgr.quarantined[0][2]
              and (Path(ckpt_dir) / f"corrupt.{newest.name}").is_dir(),
              f"restore_latest: step {step}, {mgr.quarantined}")
        check(host["controller"]["step"] == step, "host state's step")
        emit("checkpoint", card=dev["nvidia_smi"],
             failures=[f["error"] for f in sup.failures],
             resumed_from=last["restored"],
             steps_after_resume=n, plans_equal=True,
             losses_bit_identical=bool(np.array_equal(a, b)),
             loss_max_rel_err=loss_rel, rtol=RESUME_RTOL,
             final_params_max_abs_diff=params_err,
             val_ppl=res.val_ppl_history,
             uninterrupted_val_ppl=ref.val_ppl_history,
             checkpoint_bytes=nbytes, disk_bytes=disk,
             save_s={str(s): t for s, t in saves},
             resume_s=last["restore_s"],
             restore_latest_s=restore_s, leaves=n_leaves,
             quarantined=[q[0] for q in mgr.quarantined],
             fell_back_to=step, launches=launches)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches


# phase telemetry_gns: per-leaf telemetry, the GNS step and the optimizer
# extras at full gpt2-117m width on train_config()'s joint recipe
# Shampoo's arm runs 4 steps (refreshes at steps 0 and 3) since the MoE
# phases came: each refresh takes ~14 s of host-bound eigh
GNS_STEPS, OPT_STEPS, SHAMPOO_STEPS, SHAMPOO_INTERVAL = 30, 10, 4, 3
GNS_SHARDS, GNS_WINDOW, GNS_DIM, GNS_MIN_BATCH = 4, 12, 16, 2
# the reference's labels of gpt2-117m (repro.core.telemetry.param_labels;
# tests/test_torch_telemetry.py holds the port's equal to them)
GPT2_LABELS = (
    "embed", "final_norm/bias", "final_norm/scale", "layers/attn/wk",
    "layers/attn/wo", "layers/attn/wq", "layers/attn/wv", "layers/ln1/bias",
    "layers/ln1/scale", "layers/ln2/bias", "layers/ln2/scale",
    "layers/mlp/b_down", "layers/mlp/b_up", "layers/mlp/w_down",
    "layers/mlp/w_up", "pos_embed")
# fixed before the first run: the per-leaf vectors reduce the scalars'
# own sums per group, so they recompose them to fp32 rounding
GNS_SUM_RTOL = 1e-5
# fixed before the first run: the sharded step's full-batch gradient
# against the single pass, leaf by leaf within this x max |single-pass
# leaf| (fp32, 12 layers, token-weighted sums in another order), as
# GRAD_RTOL holds flash against plain attention
GNS_GRAD_RTOL = 1e-4
# fixed before the first run: one GNS step on the flash kernels against
# the same step on their plain versions.  The per-leaf vectors and the
# pair are sums of squares, norms and maxima of gradients that agree to
# GRAD_RTOL of a leaf's largest entry, dominated by the large entries:
# within GNS_PLAIN_RTOL relative.  The sketch's buckets are signed sums
# that cancel: within GNS_SKETCH_RTOL of each row's largest entry.
GNS_PLAIN_RTOL = 1e-4
GNS_SKETCH_RTOL = 1e-3


def telemetry_arms() -> dict:
    """name -> (TrainConfig, steps) of phase ``telemetry_gns``: the joint
    recipe of train_config() with per-leaf telemetry and GNS (4 shards,
    precursor window 12, sketch dim 16); the same with the critical_batch
    regulator from 2 rows; and SM3 and Shampoo (refresh every 3 steps)
    with per-leaf telemetry, 10 and 4 steps, one eval each."""
    from repro_torch.configs import GNSConfig, RegulatorSpec
    from repro_torch.core.regulators import auto_specs
    base = train_config()
    per_leaf = dataclasses.replace(base.optimizer, telemetry_level="per_leaf")
    gns = GNSConfig(enabled=True, shards=GNS_SHARDS,
                    precursor_window=GNS_WINDOW, precursor_dim=GNS_DIM,
                    min_batch=GNS_MIN_BATCH)
    arm = dataclasses.replace(base, optimizer=per_leaf, gns=gns)
    short = lambda opt, steps: dataclasses.replace(
        base, optimizer=opt, eval_interval=steps)
    return {
        "gns": (arm, GNS_STEPS),
        "gns_batch": (dataclasses.replace(arm, regulators=auto_specs(arm) + (
            RegulatorSpec(kind="critical_batch"),)), GNS_STEPS),
        "sm3": (short(dataclasses.replace(per_leaf, optimizer="sm3"),
                      OPT_STEPS), OPT_STEPS),
        "shampoo": (short(dataclasses.replace(
            per_leaf, optimizer="shampoo",
            shampoo_interval=SHAMPOO_INTERVAL), SHAMPOO_STEPS),
            SHAMPOO_STEPS)}


def _shard_rows(gns, b: int) -> int:
    """Rows of one forward: a shard's under GNS, else the batch's."""
    from repro_torch.launch.steps import _gns_shard_count
    k = _gns_shard_count(gns, b) if gns.enabled else 1
    return b // k


def telemetry_shapes() -> set:
    """Every (rows, seq) phase ``telemetry_gns`` can run a forward at:
    each planned step's shard and the evals.  The gns_batch arm's batch
    follows the measured noise scale, capped by a batch warmup that
    follows its own tokens, so any batch from GNS_MIN_BATCH to the full
    one at each planned seq len (SLW is open loop)."""
    from repro_torch.core.regulators import predict_trajectory
    arms = telemetry_arms()
    shapes = {(EVAL_BATCH, S_TRAIN)}
    for name, (tc, steps) in arms.items():
        plans = predict_trajectory(arms["gns"][0] if name == "gns_batch"
                                   else tc, steps)
        for p in plans:
            batches = (range(GNS_MIN_BATCH, tc.global_batch + 1)
                       if name == "gns_batch" else (p.batch_size,))
            shapes |= {(_shard_rows(tc.gns, b), p.seq_len) for b in batches}
    return shapes


def _opt_bytes(opt) -> int:
    from repro_torch.optim.transforms import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(opt)
               if t is not None)


def _plain_flash():
    """A patch of the flash Function's module onto the kernels' plain
    versions."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import kernel, ops
    return mock.patch.multiple(
        ops, flash_attention_fwd=kernel.flash_attention_fwd_plain,
        flash_attention_bwd=kernel.flash_attention_bwd_plain)


def _gns_checks(tc) -> dict:
    """On one 16 x 1024 batch from fresh weights: the sharded path's
    full-batch gradient against the single pass, and one GNS step on the
    flash kernels against the same step on their plain versions."""
    from repro_torch.core.telemetry import leaf_groups, split_metrics
    from repro_torch.launch.steps import make_train_step, sharded_grads
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.transforms import tree_leaves
    tr = Trainer(tc, eval_batch=EVAL_BATCH, device="cuda")
    batch = tr.to_device(tr.pipeline.batch_at(0))
    params = tr.state["params"]
    names = _leaf_names(params)
    grads, _, _ = sharded_grads(tr.model, params, batch, GNS_SHARDS)
    single = _grads(tr.model, params, batch)
    grad_rel = {}
    for name, g, s in zip(names, grads, single):
        grad_rel[name] = (g - s).abs().max().item() / s.abs().max().item()
        check(grad_rel[name] <= GNS_GRAD_RTOL,
              f"sharded gradient {name}: {grad_rel[name]}")
    del grads, single
    init = _clone_state(tr.state)
    step = make_train_step(tr.model, tc.optimizer, gns=tc.gns)
    lr, clip = float(np.float32(6e-4)), 1.0
    _, out = step(_clone_state(init), batch, lr, clip)
    flash_s, flash_v = split_metrics(out)
    with _plain_flash():
        _, out = make_train_step(tr.model, tc.optimizer, gns=tc.gns)(
            _clone_state(init), batch, lr, clip)
    plain_s, plain_v = split_metrics(out)
    del out, init, tr, step
    plain_rel = {}
    for k in ("gns_small_sq", "gns_big_sq", "grad_norm", "var_max", "loss"):
        plain_rel[k] = abs(flash_s[k] - plain_s[k]) / abs(plain_s[k])
        check(plain_rel[k] <= GNS_PLAIN_RTOL, f"plain {k}: {plain_rel[k]}")
    for k, ref in plain_v.items():
        err = np.abs(flash_v[k] - ref)
        if k == "gns_sketch":
            rel = float(np.max(err.max(1) / np.abs(ref).max(1)))
            check(rel <= GNS_SKETCH_RTOL, f"plain sketch: {rel}")
        else:  # a zero-initialized bias has a param norm of 0 on both
            rel = float(np.max(err / np.maximum(np.abs(ref), 1e-30)))
            check(rel <= GNS_PLAIN_RTOL, f"plain leaf {k}: {rel}")
        plain_rel[f"leaf_{k}"] = rel
    return {"sharded_grad_max_rel": max(grad_rel.values()),
            "plain_max_rel": plain_rel,
            "labels": leaf_groups(params).labels}


def phase_telemetry_gns(dev: dict, checked: set, train_tokens_s: float
                        ) -> dict:
    """The four arms of :func:`telemetry_arms` through the Trainer on the
    flash kernels, with the checks of :func:`_gns_checks` first."""
    from repro_torch.core.regulators import predict_trajectory
    from repro_torch.gns import GNSEstimator
    from repro_torch.launch.train import Trainer, TrainerHook

    held = torch.cuda.memory_allocated()
    arms = telemetry_arms()
    checks = _gns_checks(arms["gns"][0])
    check(checks["labels"] == GPT2_LABELS, f"labels {checks['labels']}")
    torch.cuda.empty_cache()

    class Record(TrainerHook):
        def __init__(self):
            self.rows = []

        def on_step_end(self, tr, tele, plan, metrics):
            crit = (tr.stack["critical_batch"] if "critical_batch"
                    in tr.stack else None)
            self.rows.append((tele, plan, None if crit is None else (
                crit.est.b_noise, crit.batch)))

    kernels = _train_kernels()
    n_layers = train_config().model.n_layers
    total = {name: 0 for name in kernels}
    out = {}
    for name, (tc, steps) in arms.items():
        for f in kernels.values():
            f.launches = 0
        rec = Record()
        tr = Trainer(tc, eval_batch=EVAL_BATCH, hooks=[rec], device="cuda")
        res = tr.run(max_steps=steps)
        launches = {k: f.launches for k, f in kernels.items()}
        for k in total:
            total[k] += launches[k]
        check(res.steps == steps and not res.diverged, f"{name}: {res.steps}")
        check(all(math.isfinite(x) for x in res.loss_history),
              f"{name}: finite losses")
        check(len(res.val_ppl_history) == 1, f"{name}: one eval")
        check(tr.leaf_labels == GPT2_LABELS, f"{name}: labels")
        shapes = {(_shard_rows(tc.gns, b), s) for b, s in zip(
            res.batch_history, res.seqlen_history)} | {(EVAL_BATCH, S_TRAIN)}
        check(shapes <= checked, f"{name}: shapes {shapes - checked}")
        # each forward is one launch of each kernel a layer: k shards a
        # GNS step, one pass otherwise, and the eval's forward
        passes = sum(b // _shard_rows(tc.gns, b) for b in res.batch_history)
        want = _want_launches(n_layers, passes, 1,
                              _fused_launches(tc, res.steps))
        check(launches == want, f"{name}: launches {launches} != {want}")
        plans = [(p.seq_len, p.batch_size, p.lr)
                 for p in predict_trajectory(tc, steps)]
        ran = list(zip(res.seqlen_history, res.batch_history,
                       res.lr_history))
        if name == "gns_batch":
            # the seq lens are the open-loop plan's; the batch starts at
            # GNS_MIN_BATCH, never shrinks and stays under the full one
            check(res.seqlen_history == [s for s, _, _ in plans],
                  f"{name}: seq lens")
            bs = res.batch_history
            check(bs[0] == GNS_MIN_BATCH and all(
                b1 <= b2 <= tc.global_batch for b1, b2 in zip(bs, bs[1:])),
                f"{name}: batches {bs}")
        else:
            check(ran == plans, f"{name}: the executed plans are "
                  "predict_trajectory's")
        pairs = 0
        for tele, _, _ in rec.rows:
            pl = tele.per_leaf
            g = float(np.sqrt(np.sum(np.square(
                pl["grad_norm"].astype(np.float64)))))
            check(abs(g - tele.grad_norm) <= GNS_SUM_RTOL * tele.grad_norm,
                  f"{name}: sqrt(sum leaf_grad_norm^2) {g} != "
                  f"{tele.grad_norm}")
            if math.isfinite(tele.gns_b_small):
                pairs += 1
                for k in ("gns_small_sq", "gns_big_sq"):
                    s = float(np.sum(pl[k].astype(np.float64)))
                    ref = getattr(tele, k)
                    check(abs(s - ref) <= GNS_SUM_RTOL * ref,
                          f"{name}: per-leaf {k} sums to {s} != {ref}")
        durations = tr.watchdog.durations
        full = [i for i, s in enumerate(res.seqlen_history) if s == S_TRAIN]
        tokens_s = (sum(res.batch_history[i] * S_TRAIN for i in full)
                    / sum(durations[i] for i in full)) if full else None
        big = sorted(range(len(GPT2_LABELS)), key=lambda i: -tr_numel(
            tr.state["params"], GPT2_LABELS[i]))[:4]
        first, last = rec.rows[0][0].per_leaf, rec.rows[-1][0].per_leaf
        row = {"steps": res.steps, "tokens": res.tokens,
               "tokens_per_s_full_length": tokens_s,
               "val_ppl": res.val_ppl_history,
               "first_loss": res.loss_history[0],
               "last_loss": res.loss_history[-1],
               "batches": res.batch_history, "gns_pairs": pairs,
               "var_max_largest_groups": {
                   GPT2_LABELS[i]: [float(first["var_max"][i]),
                                    float(last["var_max"][i])]
                   for i in big},
               "precursor_events": res.precursor_events,
               "opt_state_bytes": _opt_bytes(tr.state["opt"]),
               "launches": launches, "wall_s": res.wall_time_s}
        if tc.gns.enabled:
            est = GNSEstimator(tc.gns.ema_window, tc.gns.warmup_obs)
            traj = []
            for tele, _, crit in rec.rows:
                if math.isfinite(tele.gns_b_small):
                    est.update(tele.per_leaf["gns_small_sq"],
                               tele.per_leaf["gns_big_sq"],
                               tele.gns_b_small, tele.gns_b_big)
                traj.append(est.b_noise if crit is None else crit[0])
            row["b_noise"] = traj
        if name == "shampoo":
            # the refresh runs at Adam counts 1, 4: steps 0, 3
            refresh = [durations[i] for i in range(0, steps,
                                                   SHAMPOO_INTERVAL)]
            rest = [durations[i] for i in range(steps)
                    if i % SHAMPOO_INTERVAL]
            row.update(step_s=list(durations), refresh_ms=(
                float(np.median(refresh)) - float(np.median(rest))) * 1e3)
        out[name] = row
        del tr, rec
        torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - held
    check(left < 2**26, f"phase telemetry_gns left {left} bytes allocated")
    emit("telemetry_gns", card=dev["nvidia_smi"], labels=len(GPT2_LABELS),
         **{k: v for k, v in checks.items() if k != "labels"},
         train_tokens_per_s_full_length=train_tokens_s,
         sm3_vs_adamw_state_bytes=[out["sm3"]["opt_state_bytes"],
                                   out["gns"]["opt_state_bytes"]],
         arms=out, launches=total)
    return total


# phase recovery: divergence recovery and fault injection at full gpt2-117m
# width on train_config()'s joint recipe, four arms
# (1) the fault matrix; the stall sits at step 12: the watchdog flags a
# straggler only once it holds 8 durations (fault_tolerance.py:80)
RECOVERY_MATRIX = ("stall@12:0.5,nan_grad@8,spike@16:64.0,"
                   "grad_spike@22:1000|layers/attn")
RECOVERY_MAX_RETRIES = 5
# (2) an exact replay: a spike, rolled back with a no-op intervention
RECOVERY_REPLAY = "spike@10:64.0"
# (3) a crash between the checkpoint's payload and its rename, under a
# supervisor; a drain; a resume with the ring refilled; two NaNs at one
# step make the rollback fall back to a refilled snapshot
RECOVERY_CKPT_INTERVAL, RECOVERY_CRASH, RECOVERY_DRAIN = 5, 10, 17
RECOVERY_AFTER_RESUME = "nan_grad@18,nan_grad@18"
# (4) the reference's precursor scenario (tests/test_gns.py:501-528)
RECOVERY_PRECURSOR = "spike@12:2.0,spike@22:32.0"
# the grad_spike step's raw per-leaf gradient norms against its twin step's
# on a cloned state: the attention groups' x1000, the others' x1 (fixed
# before the first run: the same inputs through the same kernels, the
# norms of gradients scaled exactly; the room is the norms' fp32 rounding)
GRAD_SPIKE_RTOL = 1e-5
# an arm's device max_memory_allocated against phase train's
PEAK_SLACK = 1.05


def recovery_shapes() -> set:
    """Every (rows, seq) the recovery arms can run a forward at.  A second
    rollback clamps the seq len a ladder rung down, which moves the
    token-driven batch warmup off its plan, so: any batch of the warmup at
    any bucket of the ladder, whole and as the GNS arm's shards."""
    from repro_torch.core.regulators import build_stack
    tc = train_config()
    ladder = build_stack(tc)["seqlen"].curriculum.ladder
    gns = telemetry_arms()["gns"][0].gns
    rows = {r for b in range(tc.batch_warmup.start_batch, B_TRAIN + 1)
            for r in (b, _shard_rows(gns, b))}
    return {(r, s) for r in rows for s in ladder} | {(EVAL_BATCH, S_TRAIN)}


def check_nan_propagation() -> dict:
    """A NaN planted in one element of q, of k and of v at the training
    shape (16 x 1024, fp32): the forward kernel's o and lse and the three
    backward kernels' dq, dk and dv (each on its own path's forward) are
    non-finite wherever the plain versions' are, among the outputs that
    depend on the planted element (those the plain versions change when
    it moves by 1: a plain einsum also spreads 0 x NaN over masked keys)."""
    from repro_torch.kernels.flash_attention import kernel as K
    q, k, v = _attn_inputs(B_TRAIN, S_TRAIN, torch.float32, 77)
    do = _attn_inputs(B_TRAIN, S_TRAIN, torch.float32, 78)[0]
    where = (5, 2 * S_TRAIN // 3, 17)  # (bh, row, feature) of the NaN

    def run(fwd, bwd, xs):
        o, lse = fwd(*xs)
        return [o, lse, *bwd(*xs, o, lse, do)]

    def planted(i, value):
        xs = [t.clone() for t in (q, k, v)]
        xs[i][where] = value if value is not None else xs[i][where] + 1.0
        return xs

    plain = lambda xs: run(K.flash_attention_fwd_plain,  # noqa: E731
                           K.flash_attention_bwd_plain, xs)
    kernel = lambda xs: run(K.flash_attention_fwd,  # noqa: E731
                            K.flash_attention_bwd, xs)
    base = plain((q, k, v))
    out = {}
    for i, name in enumerate("qkv"):
        moved = plain(planted(i, None))
        p_nan = plain(planted(i, float("nan")))
        k_nan = kernel(planted(i, float("nan")))
        torch.cuda.synchronize()
        for j, out_name in enumerate(("o", "lse", "dq", "dk", "dv")):
            dep = base[j] != moved[j]
            want = ~torch.isfinite(p_nan[j]) & dep
            got = ~torch.isfinite(k_nan[j])
            missed = int((want & ~got).sum())
            out[f"{name}->{out_name}"] = {
                "plain_nonfinite_dependent": int(want.sum()),
                "kernel_nonfinite": int(got.sum()),
                "missed": missed}
            check(missed == 0, f"a NaN in {name}: the kernels' {out_name} is "
                  f"finite at {missed} entries where the plain version's is "
                  f"not")
        del moved, p_nan, k_nan
    return out


def check_decode_nan_propagation(main_lengths, cache_len: int) -> dict:
    """A NaN planted in one element of q, of one k row and of one v row of
    slot 0 on the fused decode step's gpt2 shape (8 slots over
    ``cache_len``, fp32), through the dense kernel and through the paged
    one (its pool at ``paged_main_lengths``): each kernel's o, m and l are
    non-finite wherever its plain version's are, among the outputs that
    depend on the planted element (those the plain version changes when it
    moves by 1)."""
    from repro_torch.kernels.flash_decode import kernel as K
    q, kc, vc, lengths = _decode_inputs(8, cache_len, 1, torch.float32,
                                        main_lengths, 81)
    pl, free = paged_main_lengths(main_lengths)
    pq, pk, pv, table, plen = _paged_inputs(
        pl, PAGE_SIZE, -(-cache_len // PAGE_SIZE), N_PAGES, 1,
        torch.float32, 82, holes=[(i, 0) for i in free])
    head, feat = 5, 17
    row, prow = main_lengths[0] // 2, pl[0] // 2
    page = (int(table[0, prow // PAGE_SIZE]), prow % PAGE_SIZE)
    paths = {
        "dense": (K.flash_decode_fwd_plain, K.flash_decode_fwd,
                  lambda xs: (*xs, lengths), (q, kc, vc),
                  ((0, head, 0, feat), (0, row, head, feat),
                   (0, row, head, feat))),
        "paged": (K.flash_decode_paged_fwd_plain, K.flash_decode_paged_fwd,
                  lambda xs: (*xs, table, plen), (pq, pk, pv),
                  ((0, head, 0, feat), (*page, head, feat),
                   (*page, head, feat)))}
    out = {}
    for path, (plain, kernel, args, xs, wheres) in paths.items():
        base = plain(*args(xs))
        for i, name in enumerate("qkv"):
            def planted(value):
                ys = [t.clone() for t in xs]
                ys[i][wheres[i]] = (value if value is not None
                                    else ys[i][wheres[i]] + 1.0)
                return ys
            moved = plain(*args(planted(None)))
            p_nan = plain(*args(planted(float("nan"))))
            k_nan = kernel(*args(planted(float("nan"))))
            torch.cuda.synchronize()
            for j, out_name in enumerate("oml"):
                want = ~torch.isfinite(p_nan[j]) & (base[j] != moved[j])
                got = ~torch.isfinite(k_nan[j])
                missed = int((want & ~got).sum())
                out[f"{path}:{name}->{out_name}"] = {
                    "plain_nonfinite_dependent": int(want.sum()),
                    "kernel_nonfinite": int(got.sum()), "missed": missed}
                check(missed == 0, f"a NaN in {name}: the {path} decode "
                      f"kernel's {out_name} is finite at {missed} entries "
                      f"where the plain version's is not")
    return out


def _host_copy(state):
    from repro_torch.core.recovery import _tree_map
    return _tree_map(lambda t: t.detach().to("cpu", copy=True), state)


def _to_card(state):
    from repro_torch.core.recovery import _tree_map
    return _tree_map(lambda t: t.to("cuda", copy=True), state)


class _Probe:
    """Timers and records around one trainer's recovery machinery and train
    step (instance attributes over the methods, removed by ``close`` so
    no reference cycle keeps the trainer's state on the card).  Copies the
    state going into the first pass of each step in ``capture`` to the
    host, with the step's batch and arguments."""

    def __init__(self, tr, capture=()):
        self.tr, self.capture = tr, set(capture)
        self.push_ms, self.mat_ms, self.rollback_ms = [], [], []
        self.spill, self.load = [], []
        self.calls, self.captured, self.rollbacks = [], {}, []
        self.precursor, self.restored_from = [], None
        ctrl, ring = tr.recovery, tr.recovery.ring
        self._owners = [(ring, "push"), (ring, "materialize"),
                        (ring, "save"), (ring, "load"), (ctrl, "handle"),
                        (ctrl, "handle_precursor"), (tr, "step_fn")]
        push, mat, save, load = (ring.push, ring.materialize, ring.save,
                                 ring.load)
        handle, precursor, step_fn = (ctrl.handle, ctrl.handle_precursor,
                                      tr.step_fn)

        def timed(fn, into):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                into.append((time.perf_counter() - t0) * 1e3)
                return out
            return call

        ring.push = timed(push, self.push_ms)
        ring.save = timed(save, self.spill)
        ring.load = timed(load, self.load)
        timed_mat = timed(mat, self.mat_ms)

        def materialize(snap, device):
            self.restored_from = snap
            return timed_mat(snap, device)
        ring.materialize = materialize
        timed_handle = timed(handle, self.rollback_ms)

        def on_event(trainer, event):
            self.rollbacks.append((str(event), list(ring.steps)))
            return timed_handle(trainer, event)
        ctrl.handle = on_event

        def on_precursor(trainer, event, **kw):
            precursor(trainer, event, **kw)
            self.precursor.append((str(event), trainer.step,
                                   ring.newest().step,
                                   len(trainer.result.loss_history) - 1))
        ctrl.handle_precursor = on_precursor

        def step(state, batch, lr, clip, **extra):
            s = tr.step
            self.calls.append((s, tuple(sorted(extra))))
            if s in self.capture and s not in self.captured:
                self.captured[s] = (_host_copy(state), batch, lr, clip,
                                    dict(extra))
            return step_fn(state, batch, lr, clip, **extra)
        tr.step_fn = step

    def close(self) -> None:
        for owner, name in self._owners:
            owner.__dict__.pop(name, None)
        self.tr = None


def _recorder():
    """A hook recording each executed step's telemetry and plan, its wall
    time since the last step's end (the step and every hook: snapshots and
    rollbacks included) and whether the watchdog flagged it."""
    from repro_torch.launch.train import TrainerHook

    class Record(TrainerHook):
        def __init__(self):
            self.rows, self._t, self._n = [], None, 0

        def on_run_start(self, tr):
            self._t = time.perf_counter()

        def on_step_end(self, tr, tele, plan, metrics):
            now = time.perf_counter()
            flagged = len(tr.watchdog.straggler_steps) > self._n
            self._n = len(tr.watchdog.straggler_steps)
            self.rows.append({"step": tele.step, "tele": tele,
                              "plan": (plan.seq_len, plan.batch_size,
                                       plan.lr),
                              "wall_s": now - self._t,
                              "watchdog_s": tr.watchdog.durations[-1],
                              "straggler": flagged})
            self._t = now
    return Record()


def _first_pass(rows) -> dict:
    """step -> the row of its first execution."""
    out = {}
    for r in rows:
        out.setdefault(r["step"], r)
    return out


def _arm_common(name, tc, res, launches, peak, train_peak, checked,
                passes=None):
    """The checks every arm of ``tc`` shares: launch counts, checked
    shapes, memory."""
    n_layers = train_config().model.n_layers
    executed = len(res.loss_history)
    want = _want_launches(n_layers, executed if passes is None else passes,
                          len(res.val_ppl_history),
                          _fused_launches(tc, executed))
    check(launches == want, f"recovery {name}: launches {launches} != {want}")
    check(peak <= PEAK_SLACK * train_peak,
          f"recovery {name}: peak {peak} > {PEAK_SLACK} x train's {train_peak}")
    return executed


def _ring_stats(probe) -> dict:
    return {"snapshot_ms_mean": float(np.mean(probe.push_ms))
            if probe.push_ms else None,
            "snapshot_ms_max": max(probe.push_ms, default=None),
            "snapshots": len(probe.push_ms),
            "materialize_ms": probe.mat_ms,
            "rollback_wall_ms": probe.rollback_ms}


def _tokens_per_s(rows, skip) -> dict:
    """Tokens/s over the first passes at the longest seq len run (the full
    length unless a rollback clamped it) of steps not in ``skip``: by the
    watchdog (the step alone) and by the wall (with its hooks, snapshots
    included)."""
    first = [r for s, r in _first_pass(rows).items() if s not in skip]
    seq = max(r["plan"][0] for r in first)
    rs = [r for r in first if r["plan"][0] == seq]
    tokens = sum(r["plan"][1] * seq for r in rs)
    return {"seq_len": seq, "steps": len(rs),
            "watchdog": tokens / sum(r["watchdog_s"] for r in rs),
            "wall": tokens / sum(r["wall_s"] for r in rs)}


def _recovery_matrix(checked, train_peak) -> dict:
    """Arm 1: the fault matrix with per-leaf telemetry."""
    from repro_torch.core.recovery import RecoveryConfig
    from repro_torch.core.telemetry import split_metrics
    from repro_torch.distributed.fault_injection import FaultInjector
    from repro_torch.distributed.fault_tolerance import RetryPolicy
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import Trainer
    tc = train_config()
    tc = dataclasses.replace(tc, optimizer=dataclasses.replace(
        tc.optimizer, telemetry_level="per_leaf"))
    inj = FaultInjector.from_cli(RECOVERY_MATRIX, seed=SEED)
    rec = _recorder()
    tr = Trainer(tc, eval_batch=EVAL_BATCH, hooks=[rec], device="cuda",
                 recovery=RecoveryConfig(policy=RetryPolicy(
                     max_retries=RECOVERY_MAX_RETRIES)),
                 fault_injector=inj)
    probe = _Probe(tr, capture=(7, 8, 22))
    kernels = _train_kernels()
    try:
        for f in kernels.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res = tr.run()
        launches = {n: f.launches for n, f in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        ring_bytes = sum(_opt_bytes(s.state) for s in tr.recovery.ring)
        straggler_steps = tr.watchdog.straggler_steps
        model, labels = tr.model, tr.leaf_labels
        leaf_scales = dict(tr.stack["recovery"].leaf_lr_scales)
    finally:
        probe.close()
        del tr
    torch.cuda.empty_cache()
    executed = _arm_common("matrix", tc, res, launches, peak, train_peak,
                           checked)
    check(res.steps == TRAIN_STEPS and not res.diverged,
          f"matrix: {res.steps} steps, diverged {res.diverged}")
    specs = [str(s) for s in inj.specs]
    check(sorted(res.faults_fired) == sorted(specs),
          f"matrix: fired {res.faults_fired}")
    check(res.rollbacks in (2, 3), f"matrix: {res.rollbacks} rollbacks")
    for (event, ring_steps), restored in zip(
            probe.rollbacks, [e for e in res.recovery_events
                              if e.startswith("restored@")]):
        check(int(restored.split("@")[1]) in ring_steps,
              f"matrix: {restored} after {event}, ring held {ring_steps}")
    shapes = _run_shapes(res)
    check(shapes <= checked, f"matrix: shapes {shapes - checked}")
    first = _first_pass(rec.rows)
    check(first[12]["straggler"], "matrix: the stall at 12 is no straggler")

    # the NaN step and the step before, again on the plain versions
    finite = {}
    for s in (7, 8):
        host, batch, lr, clip, extra = probe.captured[s]
        with _plain_flash():
            _, out = make_train_step(model, tc.optimizer)(
                _to_card(host), batch, lr, clip, **extra)
        m, _ = split_metrics(out)
        tele = first[s]["tele"]
        finite[s] = {"kernels": [tele.loss, tele.grad_norm],
                     "plain": [m["loss"], m["grad_norm"]]}
        del out
    ok = lambda xs: all(math.isfinite(x) for x in xs)  # noqa: E731
    check(ok(finite[7]["kernels"]) and ok(finite[7]["plain"]),
          f"matrix: step 7 {finite[7]}")
    check(not any(math.isfinite(x) for x in finite[8]["kernels"] +
                  finite[8]["plain"]), f"matrix: step 8 {finite[8]}")

    # the grad_spike step against its twin without the grad_scale vector
    host, batch, lr, clip, extra = probe.captured[22]
    check("grad_scale" in extra, "matrix: no grad_scale at step 22")
    scale = extra.pop("grad_scale")
    _, out = make_train_step(model, tc.optimizer)(_to_card(host), batch, lr,
                                                  clip, **extra)
    _, twin = split_metrics(out)
    del out, host, probe.captured
    torch.cuda.empty_cache()
    ratio = (first[22]["tele"].per_leaf["grad_norm"].astype(np.float64)
             / twin["grad_norm"].astype(np.float64))
    want = np.where([lb.startswith("layers/attn") for lb in labels],
                    1000.0, 1.0)
    check(np.array_equal(scale, want.astype(np.float32)),
          f"matrix: grad_scale {scale}")
    ratio_err = float(np.max(np.abs(ratio / want - 1.0)))
    check(ratio_err <= GRAD_SPIKE_RTOL,
          f"matrix: grad_spike ratios {dict(zip(labels, ratio))}")
    scaled = [s for s, keys in probe.calls if "grad_scale" in keys]
    check(scaled == [22], f"matrix: grad_scale went into steps {scaled}")
    blamed = [e for e in res.recovery_events if "leaf=" in e
              and int(e.split("@")[1].split("(")[0]) >= 22]
    check(all("leaf=layers/attn" in e for e in blamed),
          f"matrix: blamed {blamed}")
    with_lr = ["leaf_lr" in keys for _, keys in probe.calls]
    leaf_lr = [s for (s, _), w in zip(probe.calls, with_lr) if w]
    if leaf_scales:  # from the step after the rollback that set it, on
        check(any(with_lr) and all(with_lr[with_lr.index(True):]),
              f"matrix: leaf_lr went into steps {leaf_lr}")
    replayed = executed - TRAIN_STEPS
    return {"rollbacks": res.rollbacks, "events": res.recovery_events,
            "faults": res.faults_fired, "steps_executed": executed,
            "steps_replayed": replayed, "launches": launches,
            "max_memory_allocated": peak, "ring_host_bytes": ring_bytes,
            "straggler_steps": straggler_steps,
            "nan_step_finite": finite, "grad_spike_ratio_max_rel_err":
                ratio_err, "leaf_lr_steps": leaf_lr,
            "leaf_lr_scales": leaf_scales,
            "tokens_per_s": _tokens_per_s(rec.rows, {12, 16, 22}),
            **_ring_stats(probe), "wall_s": res.wall_time_s}


def _recovery_replay(checked, train_peak, clean) -> dict:
    """Arm 2: a spike rolled back with a no-op intervention replays the
    clean run bit for bit; a second restore of the snapshot, three steps
    on, gives the first restore's bits."""
    from repro_torch.core.recovery import RecoveryConfig
    from repro_torch.distributed.fault_injection import FaultInjector
    from repro_torch.launch.train import Trainer, TrainerHook
    from repro_torch.optim.transforms import tree_leaves
    again = {}

    class RestoreAgain(TrainerHook):
        """Keeps the restored state on the host (after the rollback, before
        the next step writes it in place), and at step 12 restores the
        same snapshot again, past the probe's timers."""

        def on_step_end(self, tr, tele, plan, metrics):
            ring = tr.recovery.ring
            if tr.recovery.rollbacks == 1 and "first" not in again:
                again["step"] = tr.recovery._last_restore_step
                again["first"] = _host_copy(tr.state)
            elif tele.step == 12 and "first" in again and "equal" not in again:
                snap = [s for s in ring if s.step == again["step"]][0]
                second = type(ring).materialize(ring, snap, tr.device)
                again["equal"] = all(
                    torch.equal(a.cpu(), b) for a, b in zip(
                        tree_leaves(second), tree_leaves(again.pop("first"))))
                del second

    rec = _recorder()
    tc = train_config()
    tr = Trainer(tc, eval_batch=EVAL_BATCH, device="cuda",
                 hooks=[RestoreAgain(), rec],
                 recovery=RecoveryConfig(lr_backoff=1.0, lr_floor=1.0),
                 fault_injector=FaultInjector.from_cli(RECOVERY_REPLAY,
                                                       seed=SEED))
    probe = _Probe(tr)
    kernels = _train_kernels()
    try:
        for f in kernels.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res = tr.run()
        launches = {n: f.launches for n, f in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
    finally:
        probe.close()
        del tr
    torch.cuda.empty_cache()
    executed = _arm_common("replay", tc, res, launches, peak, train_peak,
                           checked)
    check(res.steps == TRAIN_STEPS and not res.diverged
          and res.rollbacks == 1 and "restored@10" in res.recovery_events,
          f"replay: {res.recovery_events}")
    check(_run_shapes(res) <= checked, "replay: shapes not checked")
    n = TRAIN_STEPS - 10
    plans = lambda r, lo: list(zip(r.seqlen_history[lo:],  # noqa: E731
                                   r.batch_history[lo:], r.lr_history[lo:]))
    check(executed == TRAIN_STEPS + 1 and plans(res, -n) == plans(clean, 10),
          "replay: the replayed plans are not the clean run's")
    bit = res.loss_history[-n:] == clean.loss_history[10:]
    check(bit, "replay: the replayed losses are not the clean run's bits")
    check(again.get("equal") is True and again.get("step") == 10,
          f"replay: a second restore of the snapshot: {again}")
    return {"events": res.recovery_events, "steps_executed": executed,
            "losses_bit_identical": bit, "second_restore_bit_identical":
                again["equal"], "launches": launches,
            "max_memory_allocated": peak, **_ring_stats(probe),
            "tokens_per_s": _tokens_per_s(rec.rows, {10}),
            "val_ppl": res.val_ppl_history,
            "clean_val_ppl": clean.val_ppl_history}


def _recovery_drain(checked, train_peak) -> dict:
    """Arm 3: a crash between a checkpoint's payload and its rename under
    a supervisor, a drain that spills the ring, a resume that refills it,
    and NaNs after the resume rolled back onto a refilled snapshot."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import latest_step
    from repro_torch.core.recovery import RecoveryConfig
    from repro_torch.distributed.fault_injection import FaultInjector
    from repro_torch.distributed.fault_tolerance import (RetryPolicy,
                                                         TrainSupervisor)
    from repro_torch.launch.train import Trainer, TrainerHook
    from repro_torch.optim.transforms import tree_leaves

    class DrainAt(TrainerHook):
        def on_step_start(self, tr):
            if tr.step == RECOVERY_DRAIN:
                tr.request_drain()

    kernels = _train_kernels()
    for f in kernels.values():
        f.launches = 0
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_recovery_")
    try:
        tc = dataclasses.replace(
            train_config(), checkpoint_dir=ckpt_dir,
            checkpoint_interval=RECOVERY_CKPT_INTERVAL, keep_checkpoints=1)
        rc = RecoveryConfig(ring=2)
        inj = FaultInjector.from_cli(f"crash@{RECOVERY_CRASH}:post_tmp",
                                     seed=SEED)
        attempts = []
        torch.cuda.reset_peak_memory_stats()

        def run(resume: bool) -> str:
            attempts.append({
                "tmp_left": (Path(ckpt_dir)
                             / f"tmp.{RECOVERY_CRASH}").is_dir(),
                "latest": latest_step(ckpt_dir)})
            tr = Trainer(tc, eval_batch=EVAL_BATCH, hooks=[DrainAt()],
                         recovery=rc, fault_injector=inj, device="cuda")
            probe = _Probe(tr)
            try:
                restored = tr.resume() if resume else None
                res = tr.run()
                attempts[-1].update(restored=restored, result=res,
                                    ring=list(tr.recovery.ring),
                                    spill_ms=probe.spill,
                                    **_ring_stats(probe))
                return f"ok:{res.steps}"
            finally:
                probe.close()

        sup = TrainSupervisor(policy=RetryPolicy(max_retries=1))
        out = sup.run(run)
        torch.cuda.empty_cache()
        first = attempts[-1]
        res = first["result"]
        check(out == f"ok:{RECOVERY_DRAIN}" and res.drained,
              f"drain: supervised run {out}")
        check([f["error"] for f in sup.failures] == [
            f"InjectedCrash: injected crash at checkpoint post_tmp (step "
            f"{RECOVERY_CRASH})"], f"drain: failures {sup.failures}")
        check(first["tmp_left"] and first["latest"] == RECOVERY_CKPT_INTERVAL
              and first["restored"] == RECOVERY_CKPT_INTERVAL,
              f"drain: restart {first}")
        ring_dir = Path(ckpt_dir) / "ring"
        spilled = [s.step for s in first["ring"]]
        check(sorted(p.name for p in ring_dir.iterdir()) == [
            f"step_{s:012d}" for s in spilled] and len(spilled) == 2,
            f"drain: ring dir {sorted(p.name for p in ring_dir.iterdir())}")
        check(latest_step(ckpt_dir) == RECOVERY_DRAIN, "drain: checkpoint")
        spill_bytes = sum(_dir_bytes(p) for p in ring_dir.iterdir())
        disk = sum(_dir_bytes(p) for p in Path(ckpt_dir).iterdir()
                   if p.is_dir() and p != ring_dir) + spill_bytes

        # a resume with recovery refills the ring; two NaNs at one step
        # roll back to the run-start snapshot, then to a refilled one
        inj2 = FaultInjector.from_cli(RECOVERY_AFTER_RESUME, seed=SEED)
        tr = Trainer(tc, eval_batch=EVAL_BATCH, recovery=rc,
                     fault_injector=inj2, device="cuda")
        probe = _Probe(tr)
        try:
            check(tr.resume() == RECOVERY_DRAIN, "drain: resume")
            loaded = list(tr.recovery.ring)
            check([s.step for s in loaded] == spilled,
                  f"drain: refilled {[s.step for s in loaded]}")
            for a, b in zip(first["ring"], loaded):
                check(a.tokens_seen == b.tokens_seen
                      and all(torch.equal(x, y) for x, y in zip(
                          tree_leaves(a.state), tree_leaves(b.state))),
                      f"drain: refilled snapshot {b.step} != spilled")
            del first["ring"]
            res2 = tr.run(max_steps=5)
            restored_snap = probe.restored_from
            launches = {n: f.launches for n, f in kernels.items()}
            peak = torch.cuda.max_memory_allocated()
        finally:
            probe.close()
            del tr
        torch.cuda.empty_cache()
        want_events = ["nan_loss@18(loss=nan)", f"restored@{RECOVERY_DRAIN}",
                       "nan_loss@18(loss=nan)", f"restored@{spilled[-1]}"]
        check(res2.recovery_events == want_events and not res2.diverged,
              f"drain: after the resume {res2.recovery_events}")
        check(any(restored_snap is s for s in loaded),
              "drain: the last restore was not a refilled snapshot")
        check(_run_shapes(res) | _run_shapes(res2) <= checked,
              "drain: shapes not checked")
        # executed: the crashed run's steps, the restart's, the resumed run's
        executed = (RECOVERY_CRASH + len(res.loss_history)
                    + len(res2.loss_history))
        want = _want_launches(train_config().model.n_layers, executed,
                              len(res.val_ppl_history)
                              + len(res2.val_ppl_history),
                              _fused_launches(tc, executed))
        check(launches == want, f"drain: launches {launches} != {want}")
        check(peak <= PEAK_SLACK * train_peak, f"drain: peak {peak}")
        return {"failures": [f["error"] for f in sup.failures],
                "restart_from": first["restored"],
                "tmp_left_behind": first["tmp_left"],
                "ring_spilled": spilled, "ring_spill_ms": first["spill_ms"],
                "ring_spill_bytes": spill_bytes,
                "ring_load_ms": probe.load, "disk_bytes": disk,
                "events_after_resume": res2.recovery_events,
                "steps_executed": executed, "launches": launches,
                "max_memory_allocated": peak,
                "restart": {k: v for k, v in first.items()
                            if k not in ("result", "tmp_left", "latest")},
                "after_resume": _ring_stats(probe)}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _recovery_precursor(checked, train_peak) -> dict:
    """Arm 4: GNS with recovery on the reference's precursor scenario;
    every precursor event pushes a snapshot and cools the LR."""
    from repro_torch.core.recovery import RecoveryConfig
    from repro_torch.distributed.fault_injection import FaultInjector
    from repro_torch.distributed.fault_tolerance import RetryPolicy
    from repro_torch.launch.train import Trainer
    tc = telemetry_arms()["gns"][0]
    rec = _recorder()
    tr = Trainer(tc, eval_batch=EVAL_BATCH, hooks=[rec], device="cuda",
                 recovery=RecoveryConfig(policy=RetryPolicy(max_retries=3)),
                 fault_injector=FaultInjector.from_cli(RECOVERY_PRECURSOR,
                                                       seed=SEED))
    probe = _Probe(tr)
    reg = tr.stack["recovery"]
    plans = []  # (lr in, lr out, lr_scale, cool_scale, cool_ttl) a step
    reg_plan = reg.plan

    def plan(tele, p):
        lr_in, state = p.lr, (reg.lr_scale, reg.cool_scale, reg.cool_ttl)
        out = reg_plan(tele, p)
        plans.append((lr_in, out.lr, *state))
        return out
    reg.plan = plan
    kernels = _train_kernels()
    try:
        for f in kernels.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        res = tr.run()
        launches = {n: f.launches for n, f in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
    finally:
        probe.close()
        del reg.plan, tr, reg
    torch.cuda.empty_cache()
    passes = sum(b // _shard_rows(tc.gns, b) for b in res.batch_history)
    _arm_common("precursor", tc, res, launches, peak, train_peak, checked,
                passes=passes)
    check(res.steps == TRAIN_STEPS and not res.diverged,
          f"precursor: {res.steps} steps, diverged {res.diverged}")
    shapes = {(_shard_rows(tc.gns, b), s) for b, s in zip(
        res.batch_history, res.seqlen_history)} | {(EVAL_BATCH, S_TRAIN)}
    check(shapes <= checked, f"precursor: shapes {shapes - checked}")
    check([e for e, *_ in probe.precursor] == res.precursor_events,
          "precursor: an event did not reach the controller")
    for event, step, newest, _ in probe.precursor:
        check(newest == step, f"precursor: {event} at step {step}, newest "
              f"snapshot {newest}")
    factor, ttl = (tc.gns.precursor_cooldown_factor,
                   tc.gns.precursor_cooldown_steps)
    check(len(plans) == len(res.lr_history) and all(
        out == lr for (_, out, *_), lr in zip(plans, res.lr_history)),
        "precursor: the planned LRs are not the steps' LRs")
    # the ttl executed steps after each event (a window that a rollback
    # cuts is reported, not held: the restore merges the cool-down state)
    order = [r["step"] for r in rec.rows]
    cooled = []
    for event, _, _, j in probe.precursor:
        window = list(range(j + 1, min(j + 1 + ttl, len(plans))))
        cut = any(order[i] <= order[i - 1] for i in window)
        held = all(plans[i][1] == plans[i][0] * (plans[i][2] * factor)
                   and plans[i][4] > 0 for i in window)
        check(cut or held, f"precursor: {event}: the LR of the next {ttl} "
              f"steps is not the planned LR x {factor}")
        cooled.append({"event": event, "steps": len(window), "cut": cut})
    events = [e for e in res.recovery_events
              if not e.startswith(("precursor@", "restored@"))]
    pre = [int(e.split("@")[1].split("(")[0]) for e in res.precursor_events]
    det = [int(e.split("@")[1].split("(")[0]) for e in events]
    return {"precursor_events": res.precursor_events,
            "recovery_events": res.recovery_events,
            "rollbacks": res.rollbacks, "cooled_windows": cooled,
            "precursor_before_detector": bool(pre and (not det
                                                       or pre[0] < det[0])),
            "steps_executed": len(res.loss_history), "launches": launches,
            "max_memory_allocated": peak, **_ring_stats(probe),
            "wall_s": res.wall_time_s}


def phase_recovery(dev: dict, checked: set, train: dict) -> dict:
    """Divergence recovery and fault injection on full-width gpt2-117m
    through the flash kernels: the kernels' NaN propagation, then the four
    arms (fault matrix, exact replay, crash/drain/ring, precursor)."""
    nan = check_nan_propagation()
    torch.cuda.empty_cache()
    clean, train_peak = train["result"], train["peak"]
    arms = {"matrix": _recovery_matrix(checked, train_peak)}
    arms["replay"] = _recovery_replay(checked, train_peak, clean)
    arms["drain"] = _recovery_drain(checked, train_peak)
    arms["precursor"] = _recovery_precursor(checked, train_peak)
    total = {name: sum(a["launches"][name] for a in arms.values())
             for name in _train_kernels()}
    emit("recovery", card=dev["nvidia_smi"], nan_propagation=nan,
         train_tokens_per_s_full_length=train["tokens_per_s"],
         train_max_memory_allocated=train_peak, arms=arms, launches=total)
    return total


def tr_numel(params, label: str) -> int:
    """Elements of the group ``label`` of a params tree."""
    from repro_torch.core.telemetry import leaf_groups
    from repro_torch.optim.transforms import tree_leaves
    groups, leaves = leaf_groups(params), tree_leaves(params)
    return sum(leaves[i].numel()
               for i in groups.members[groups.labels.index(label)])


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
# serving: rwkv6-7b at full width cut to 8 of its 32 layers.  The serving
# phases are host-bound (one step issues every layer's kernels) and took
# 112-149 s at full depth, the most of any phase and the most varying
# between machines; the depth cut keeps the script inside its time limit
# (16 layers before the MoE phases came, 8 since)
RWKV_SERVE_LAYERS = 8
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
# model's own eps only reported.  At the
# model's eps no fixed limit both passes the kernels and catches a wrong
# backward: on the H100 (PERF.md, §6) the reference itself moved 4.1e-3
# and 4.8e-2 between card and host there, and the kernel path's distance
# to it on the trained batch read 2.4e-2, more than the planted fault's
# 1e-2; at eps 1 the kernel path read at most 1.1e-5 and the reference's
# card-vs-host spread 6.6e-6
RWKV_GRAD_EPS = 1.0
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
        t_bound, by = tc_bound(nbytes, ops)
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
            "bound_by": by,
            "cuda_core_bound_ms": bound(nbytes, ops, torch.float32)[0]}
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
    plan, and at log_w near -54.6; checks two runs at the full-length batch
    bit for bit and times it there."""
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
    # no atomics, du summed over the chunks in a fixed order: two backward
    # calls give the same bits
    first = wkv6_bwd(*args, chunk=RWKV_CHUNK)
    second = wkv6_bwd(*args, chunk=RWKV_CHUNK)
    identical = all(torch.equal(a, e) for a, e in zip(first, second))
    check(identical, "two wkv6_bwd runs at 8 x 1024 differ")
    del first, second
    nbytes, ops = wkv6_bwd_work(b, s, RWKV_CHUNK)
    t_bound, by = tc_bound(nbytes, ops)
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
        "bound_by": by,
        "cuda_core_bound_ms": bound(nbytes, ops, torch.float32)[0]}}
    del args, r, k, v, lw, dy, dstate, carries
    torch.cuda.empty_cache()
    emit("wkv6_bwd", rel_err=errs, timing=timing,
         bitwise_identical_reruns=identical)
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
    return {**_train_kernels(), "flash_decode_fwd": flash_decode_fwd,
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


def phase_engine_rwkv(dev: dict, fwd_checked: set, bwd_checked: set,
                      remat_shape: tuple) -> dict:
    """Serves rwkv6-7b at full width, RWKV_SERVE_LAYERS deep (fp32, weights
    from a CUDA generator seeded with SEED) in 8 slots: 16 requests from
    ``make_requests``, fcfs.  Checks the launch counts (wkv6_fwd layers x
    prefill calls, no other kernel), the greedy streams against the same
    engine at rwkv_backend="reference", and serves the first 8 requests
    once more through the router (a paged and a dense replica) and moves
    one request each way between them mid-flight.  Then remat "dots" on
    the same weights at ``remat_shape`` (:func:`check_remat_dots`)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import make_requests, scheduler_config
    from repro_torch.models import model_zoo
    from repro_torch.serve import Replica, Router, prefill_split
    cfg = get_arch("rwkv6-7b").replace(n_layers=RWKV_SERVE_LAYERS)
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
    kshape = _wkv_kernel_shape(*remat_shape)
    check(kshape in fwd_checked and kshape in bwd_checked,
          f"rwkv remat shape {kshape} not checked")
    remat = check_remat_dots(cfg, params, remat_shape, "rwkv")
    emit("remat_dots_rwkv6", arch=cfg.name, rtol=REMAT_RTOL, **remat)
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
            "router_rwkv": {"wkv6_fwd": router_launches["wkv6_fwd"]},
            "remat_dots_rwkv": _summed(remat["launches_none"],
                                       remat["launches_dots"])}


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
    model kernel launches (the fused AdamW kernel one a step, as in the
    kernels' run), the plans of ``res``'s first steps, and its losses
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
    launches = {k: f.launches for k, f in counters.items() if f.launches}
    want = {"fused_adamw": _fused_launches(ptc, PARITY_STEPS)}
    check(launches == {k: v for k, v in want.items() if v},
          f"the reference {what} run launched {launches}")
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
    RWKV_GRAD_EPS, and reported only at the model's own (see
    :func:`_compare_rwkv_grads`), then the first 8 steps' losses from the same initial weights.  The reference runs
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
    want["fused_adamw"] = _fused_launches(tc, RWKV_STEPS)
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
         val_ppl=res.val_ppl_history,
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
        for eps in (RWKV_GRAD_EPS, tc.model.norm_eps):
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
    return {k: launches[k] for k in ("wkv6_fwd", "wkv6_bwd", "fused_adamw")}


# ---------------------------------------------------------------------------
# Zamba-2: the SSD kernels, serving and training zamba2-2.7b at full width
# ---------------------------------------------------------------------------

SSD_H, SSD_P, SSD_N, SSD_CHUNK = 80, 64, 64, 128  # zamba2-2.7b's SSD
# training: zamba2-2.7b at full width, remat "full", global batch
# 8 of sequences of 1024, SLW linear from 8 over 12 steps, batch warmup
# from 4, 20 steps, one eval of 8 sequences
ZAMBA_B, ZAMBA_STEPS, ZAMBA_EVAL = 8, 20, 8
# cut to 36 of its 54 layers (6 of 9 shared-block groups) for the gpt2-1.5b
# phases (PR 25); full depth from PR 15 to PR 24 (58.2 GB peak)
ZAMBA_TRAIN_LAYERS = 36
# serving: zamba2-2.7b at full width cut to 12 of its 54 Mamba-2 layers (2
# of its 9 shared-block groups), for the same reason as RWKV_SERVE_LAYERS
# (140-189 s at full depth; 18 layers before the MoE phases, 12 since)
ZAMBA_SERVE_LAYERS = 12
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
        t_bound, by = tc_bound(nbytes, ops)
        timing[key] = {
            "max_abs_err": (ssd_fwd(x, dt, a, b_in, c_in, chunk=q)[0]
                            - ssd_fwd_plain(x, dt, a, b_in, c_in,
                                            chunk=q)[0]).abs().max().item(),
            **times(lambda: ssd_fwd(x, dt, a, b_in, c_in, chunk=q),
                    lambda: ssd_fwd_plain(x, dt, a, b_in, c_in, chunk=q),
                    plain_queued=False),
            "library_note": "no one PyTorch call computes the SSD scan",
            "bytes": nbytes, "operations": ops, "bound_ms": t_bound,
            "bound_by": by,
            "cuda_core_bound_ms": bound(nbytes, ops, torch.float32)[0]}
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
    # no atomics: two backward calls give the same bits
    first, second = ssd_bwd(*args, chunk=q), ssd_bwd(*args, chunk=q)
    identical = all(torch.equal(u, v) for u, v in zip(first, second))
    check(identical, "two ssd_bwd runs at 8 x 1024 differ")
    del first, second
    nbytes, ops = ssd_bwd_work(b, s, q)
    t_bound, by = tc_bound(nbytes, ops)
    timing = {"train_8x1024": {
        "max_abs_err": max(
            (g - e).abs().max().item() for g, e in zip(
                ssd_bwd(*args, chunk=q), ssd_bwd_plain(*args, chunk=q))),
        **times(lambda: ssd_bwd(*args, chunk=q),
                lambda: ssd_bwd_plain(*args, chunk=q), plain_queued=False),
        "library_note": "no one PyTorch call computes the SSD backward",
        "bytes": nbytes, "operations": ops, "bound_ms": t_bound,
        "bound_by": by,
        "cuda_core_bound_ms": bound(nbytes, ops, torch.float32)[0]}}
    del args, xs, dy, dstate, carries
    torch.cuda.empty_cache()
    emit("ssd_bwd", rel_err=errs, timing=timing,
         bitwise_identical_reruns=identical)
    return timing, checked


def _zamba_weights():
    """zamba2-2.7b at full width, ZAMBA_SERVE_LAYERS deep, fp32 weights
    drawn on the card from a CUDA generator seeded with SEED, and the
    seconds that took."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model_zoo
    cfg = get_arch("zamba2-2.7b").replace(n_layers=ZAMBA_SERVE_LAYERS)
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
                       pd_checked: set, bwd_checked: set,
                       remat_shape: tuple) -> dict:
    """Serves zamba2-2.7b at full width, ZAMBA_SERVE_LAYERS deep (fp32,
    weights from a CUDA generator seeded with SEED) in 8 slots of 576: 16
    requests from ``make_requests``, fcfs.  Checks the launch counts
    (ssd_fwd layers x prefill calls; flash_decode_fwd groups x (fused +
    replay steps); no other kernel), the greedy streams against the same engine at
    ssm_backend="reference", decode_backend="reference", and serves the
    first 4 requests once more through the router (a paged replica, whose
    shared-block KV lives in pages, and a dense one) and moves one request
    each way between them mid-flight (fewer than the rwkv phase's 8: a
    fused zamba step takes the host ~90 ms).  Then remat "dots" on the
    same weights at ``remat_shape`` (:func:`check_remat_dots`)."""
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
    del reps, model, plain_model, eng, out
    torch.cuda.empty_cache()
    kshape = _ssd_kernel_shape(*remat_shape)
    check(kshape in fwd_checked and kshape in bwd_checked,
          f"zamba remat shape {kshape} not checked")
    remat = check_remat_dots(cfg, params, remat_shape, "zamba")
    emit("remat_dots_zamba2", arch=cfg.name, rtol=REMAT_RTOL, **remat)
    del params
    torch.cuda.empty_cache()
    return {"serve_zamba": {k: launches[k] for k in
                            ("ssd_fwd", "flash_decode_fwd")},
            "router_zamba": {k: router_launches[k] for k in
                             ("ssd_fwd", "flash_decode_fwd",
                              "flash_decode_paged_fwd")},
            "remat_dots_zamba": _summed(remat["launches_none"],
                                        remat["launches_dots"])}


def zamba_train_config(backend: str = "kernel"):
    from repro_torch.configs import (BatchWarmupConfig, OptimizerConfig,
                                     SLWConfig, TrainConfig, get_arch)
    tokens = ZAMBA_STEPS * ZAMBA_B * S_TRAIN
    return TrainConfig(
        model=get_arch("zamba2-2.7b").replace(
            n_layers=ZAMBA_TRAIN_LAYERS, ssm_backend=backend),
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
                         fault: bool = False) -> dict:
    """:func:`_compare_grads_at_eps` against ssm_backend="reference", remat
    "full" on both: the Mamba-2 projections, a_log and dt_bias of every
    layer need a gradient.  ``fault``: the planted dB x (1 + SSD_FAULT)."""
    out, _ = _compare_grads_at_eps(
        model, {"ssm_backend": "reference"}, params, batch, eps, limit,
        lambda name: name.split(".")[-1] in SSM_LEAVES,
        (_planted_ssd_fault, {"db_scale": 1 + SSD_FAULT}) if fault else None)
    return out


def phase_train_zamba(dev: dict, fwd_checked: set, bwd_checked: set) -> dict:
    """Trains zamba2-2.7b at full width, ZAMBA_TRAIN_LAYERS deep, through
    the Trainer (remat "full", weights from a CUDA generator seeded with
    SEED): 20 SLW steps and one full-length eval, then 2 full-length steps
    untraced and 2 under the profiler.  Against ssm_backend="reference":
    every gradient leaf of the first step's batch at the initial weights
    and of the last step's (8 x 1024) at the trained weights, at the
    norms' eps raised to ZAMBA_GRAD_EPS with a planted fault that must
    break the limit (the report at the model's own eps went for the
    gpt2-1.5b phases); then the first 8 steps' losses from the same
    initial weights.  The weights kept for those comparisons wait on the
    host: at full depth two more 9.7 GB copies beside the trainer's 38.8
    GB of state and its activations would not fit on the card."""
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
    want["fused_adamw"] = _fused_launches(tc, ZAMBA_STEPS)
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
         val_ppl=res.val_ppl_history,
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
        key = f"{len(batch['tokens'])}x{plans[i].seq_len}"
        grads[key] = {
            "weights": "trained" if is_trained else "initial",
            f"eps_{ZAMBA_GRAD_EPS:g}": _compare_zamba_grads(
                trainer.model, params, batch, ZAMBA_GRAD_EPS, GRAD_RTOL,
                fault=True)}
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
    return {k: launches[k] for k in ("ssd_fwd", "ssd_bwd", "fused_adamw")}


# ---------------------------------------------------------------------------
# deepseek-moe-16b: the flash kernels at head dim 128 and the other presets'
# (D, G), then the MoE family served at full width, 14 of its 28 layers
# deep, and trained at full width, 4 layers deep
# ---------------------------------------------------------------------------

MOE_H, MOE_D = 16, 128  # deepseek-moe-16b: 16 heads of 128, kv 16
MOE_TRAIN_LAYERS, MOE_B, MOE_STEPS, MOE_EVAL = 4, 8, 20, 8
# serving depth: 14 of its 28 layers since PR 25 (for the gpt2-1.5b
# phases; all 28, 67.5 GB of weights, in PR 23-24: host-bound, 92-142 s)
MOE_SERVE_LAYERS = 14
# the other presets' attention shapes (head dim, group size, kv heads):
# llava-next-mistral-7b, qwen2-1.5b, smollm-360m and qwen3-32b
PRESET_DG = {"llava-next-mistral-7b": (128, 4, 8), "qwen2-1.5b": (128, 6, 2),
             "smollm-360m": (64, 3, 5), "qwen3-32b": (80, 8, 8)}
# fixed before the first run: the ops-level GQA Function (the kernels on
# expanded heads, dK/dV summed over each group in fp32) against autograd
# through the blockwise backend, as GRAD_RTOL holds them in the models
GQA_RTOL = 1e-4
# a dv x (1 + MOE_FAULT) planted in the flash backward that the MoE
# gradient check must catch
MOE_FAULT = 1e-2


def moe_config(n_layers: int = 0):
    """deepseek-moe-16b on the flash and decode kernels (the preset stays
    on blockwise and the plain decode, as the reference's does)."""
    from repro_torch.configs import get_arch
    cfg = get_arch("deepseek-moe-16b").replace(attn_backend="flash",
                                               decode_backend="kernel")
    return cfg.replace(n_layers=n_layers) if n_layers else cfg


def moe_train_config(attn_backend: str = "flash"):
    from repro_torch.configs import (BatchWarmupConfig, OptimizerConfig,
                                     SLWConfig, TrainConfig)
    tokens = MOE_STEPS * MOE_B * S_TRAIN
    return TrainConfig(
        model=moe_config(MOE_TRAIN_LAYERS).replace(attn_backend=attn_backend),
        optimizer=OptimizerConfig(
            lr=6e-4, schedule="token_cosine", warmup_steps=6,
            warmup_tokens=6 * MOE_B * S_TRAIN, total_steps=MOE_STEPS,
            total_tokens=tokens),
        slw=SLWConfig(enabled=True, pacing="linear", start_seq_len=8,
                      duration_steps=12, round_multiple=8, max_buckets=12),
        batch_warmup=BatchWarmupConfig(enabled=True, start_batch=4,
                                       warmup_tokens=tokens // 20),
        seq_len=S_TRAIN, global_batch=MOE_B, seed=SEED, remat="full",
        eval_interval=MOE_STEPS)


class PinnedRouting:
    """Top-k routing is discontinuous: flash and plain attention differ by
    ~1e-6, enough to flip an assignment near a tie between the k-th and
    the next expert, and one flip moves the capacity ranking of every
    later assignment of that expert in the row.  ``record()`` keeps each
    routing call's experts (in call order) from one run; ``replay()``
    gives another run those experts, with gates from its own
    probabilities at them, and counts the assignments its own top-k would
    have chosen otherwise.  ``record()`` also keeps the dropped fraction
    of every multi-token call (the prefills)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe = moe
        self.top_k, self.ffn = moe.top_k_experts, moe.apply_moe_ffn
        self.idx, self.dropped, self.mode = [], [], None
        self.calls, self.flips, self.assignments = 0, None, 0

    def _top_k(self, probs, k):
        if self.mode == "record":
            gate, idx = self.top_k(probs, k)
            self.idx.append(idx)
            return gate, idx
        check(self.calls < len(self.idx), "the replaying run routed more "
              "often than the recorded one")
        idx = self.idx[self.calls]
        self.calls += 1
        check(idx.shape == probs.shape[:-1] + (k,), f"routing call "
              f"{self.calls}: shape {tuple(idx.shape)} != {probs.shape}")
        own = self.top_k(probs, k)[1]
        kept = (own[..., :, None] == idx[..., None, :]).any(-1).sum()
        self.flips = own.numel() - kept if self.flips is None \
            else self.flips + own.numel() - kept
        self.assignments += own.numel()
        return probs.gather(-1, idx), idx

    def _ffn(self, params, x, cfg, with_aux=True):
        if self.mode != "record" or x.shape[1] == 1:
            return self.ffn(params, x, cfg, with_aux)
        y, aux = self.ffn(params, x, cfg)
        self.dropped.append(aux["dropped_frac"].detach())
        return y, aux if with_aux else None

    @contextlib.contextmanager
    def _patched(self, mode: str):
        from unittest import mock
        self.mode = mode
        try:
            with mock.patch.object(self.moe, "top_k_experts", self._top_k), \
                    mock.patch.object(self.moe, "apply_moe_ffn", self._ffn):
                yield self
        finally:
            self.mode = None

    def record(self):
        self.idx, self.dropped = [], []
        return self._patched("record")

    def replay(self):
        self.calls, self.flips, self.assignments = 0, None, 0
        return self._patched("replay")

    def replayed(self) -> dict:
        """The last replay: every recorded call used, and its flips."""
        check(self.calls == len(self.idx), f"the replaying run routed "
              f"{self.calls} times, the recorded one {len(self.idx)}")
        return {"routing_calls": self.calls,
                "assignments": self.assignments,
                "own_top_k_differs": int(self.flips or 0)}


def _gqa_check(d: int, g: int, kv: int, seed: int) -> dict:
    """The flash ``torch.autograd.Function`` on (B, S, KV x G, D) against
    autograd through the blockwise backend: o and dq, dk, dv within
    GQA_RTOL of the plain side's largest entry."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.attention import blockwise_attention
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, s = 2, 300
    q = torch.randn(b, s, kv * g, d, device="cuda", generator=gen)
    k, v = (torch.randn(b, s, kv, d, device="cuda", generator=gen)
            for _ in range(2))
    do = torch.randn(b, s, kv * g, d, device="cuda", generator=gen)
    outs = []
    for fn in (flash_attention, blockwise_attention):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*xs, causal=True)
        outs.append([o.detach(), *torch.autograd.grad(o, xs, do)])
    errs = {}
    for name, a, r in zip(("o", "dq", "dk", "dv"), *outs):
        errs[name] = ((a - r).abs().max() / r.abs().max()).item()
        check(errs[name] <= GQA_RTOL, f"GQA d {d} g {g} {name}: "
                                      f"{errs[name]}")
    return errs


def time_flash(h: int, d: int, fwd_shapes, bwd_b: int, what: str) -> dict:
    """The flash kernels at H heads of D, fp32: the forward at each (B, S)
    of ``fwd_shapes`` and the three backward kernels (and all three) at
    ``bwd_b`` x S_TRAIN, each against its plain version on its timed
    inputs, beside its plain version's time, SDPA's (the whole backward
    for the dQ and dK/dV kernels, ``linalg.vecdot`` for delta) and its
    bound."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd, flash_attention_bwd_dkv,
        flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
        flash_attention_bwd_dq_plain, flash_attention_bwd_plain,
        flash_attention_bwd_preprocess,
        flash_attention_bwd_preprocess_plain, flash_attention_fwd,
        flash_attention_fwd_plain)
    timing = {}
    for b, s in fwd_shapes:
        q, k, v = _attn_inputs(b, s, torch.float32, 5, h, d)
        q4, k4, v4 = (t.reshape(b, h, s, d) for t in (q, k, v))
        bh = b * h
        nbytes = 4 * bh * s * d * 4 + bh * s * 4
        flops = 4 * d * _causal_pairs(bh, s)
        t_bound, by = tc_bound(nbytes, flops)
        timing[f"fwd_{b}x{s}"] = {
            "max_abs_err": check_attention(q, k, v,
                                           f"{what} timed {b}x{s}")[0],
            **times(lambda: flash_attention_fwd(q, k, v),
                    lambda: flash_attention_fwd_plain(q, k, v),
                    lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=True)),
            "bound_ms": t_bound, "bound_by": by,
            "cuda_core_bound_ms": bound(nbytes, flops, torch.float32)[0]}
        del q, k, v, q4, k4, v4
    q, k, v = _attn_inputs(bwd_b, S_TRAIN, torch.float32, 5, h, d)
    do = _attn_inputs(bwd_b, S_TRAIN, torch.float32, 6, h, d)[0]
    o, lse = flash_attention_fwd(q, k, v)
    delta = flash_attention_bwd_preprocess(o, do)
    err = dict(zip(("dq", "dk", "dv"), check_attention_bwd(
        q, k, v, o, lse, do, f"{what} timed")))
    q4, k4, v4 = (t.reshape(bwd_b, h, S_TRAIN, d).clone().requires_grad_()
                  for t in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.reshape(bwd_b, h, S_TRAIN, d)
    sdpa_bwd = lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                           retain_graph=True)
    rest = (do, lse, delta)
    sdpa = {"library_ms": device_ms(sdpa_bwd), "library_covers":
            "SDPA's whole backward (all three kernels)"}
    bh = bwd_b * h
    bounds = _bwd_bounds(bh, S_TRAIN, d=d)
    cc = _bwd_bounds(bh, S_TRAIN, False, d=d)
    tag = f"{bwd_b}x{S_TRAIN}"
    for name, kern, plain, e in (
            (f"bwd_preprocess_{tag}",
             lambda: flash_attention_bwd_preprocess(o, do),
             lambda: flash_attention_bwd_preprocess_plain(o, do),
             (delta - flash_attention_bwd_preprocess_plain(o, do)).abs()
             .max().item()),
            (f"bwd_dq_{tag}",
             lambda: flash_attention_bwd_dq(q, k, v, *rest),
             lambda: flash_attention_bwd_dq_plain(q, k, v, *rest),
             err["dq"]),
            (f"bwd_dkv_{tag}",
             lambda: flash_attention_bwd_dkv(q, k, v, *rest),
             lambda: flash_attention_bwd_dkv_plain(q, k, v, *rest),
             max(err["dk"], err["dv"])),
            (f"bwd_all_{tag}",
             lambda: flash_attention_bwd(q, k, v, o, lse, do),
             lambda: flash_attention_bwd_plain(q, k, v, o, lse, do),
             max(err.values()))):
        part = name.split("_")[1]
        t_bound, by = bounds["preprocess" if part == "preprocess" else part]
        timing[name] = {"max_abs_err": e, **times(kern, plain),
                        "bound_ms": t_bound, "bound_by": by}
        if part == "preprocess":
            timing[name]["library_ms"] = device_ms(
                lambda: torch.linalg.vecdot(o, do))
        else:
            timing[name].update(sdpa)
            timing[name]["cuda_core_bound_ms"] = cc[part][0]
    del q, k, v, q4, k4, v4, out4, do, do4, o, lse, delta
    torch.cuda.empty_cache()
    return timing


def phase_flash_d128(prefills, train_shapes, cache_len: int,
                     main_lengths) -> tuple:
    """The flash kernels at deepseek-moe-16b's head dim 128 (16 heads):
    forward at every serving prefill and every training and eval shape,
    the three backward kernels at every training shape, each against its
    plain version; the GQA Function (forward and backward) at each other
    preset's (D, G), qwen3-32b's head dim 80 included; the
    decode kernels, dense and paged, at (128, 1), (128, 4), (128, 6), (64,
    3) and (80, 8) in fp32 and bf16, and at the MoE engine's fused and
    replay shapes.  Times the forward at 1 x 512 and 8 x 1024, the three
    backward kernels at 8 x 1024 and decode on the MoE engine's fused
    step, each beside its plain version, SDPA and its bound."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    h, d = MOE_H, MOE_D
    errs = {}
    for i, (b, s) in enumerate(sorted(prefills | train_shapes)):
        key = f"{b}x{s}"
        q, k, v = _attn_inputs(b, s, torch.float32, 3000 + i, h, d)
        errs[key] = check_attention(q, k, v, f"d128 {key}")
        if (b, s) in train_shapes:
            do = _attn_inputs(b, s, torch.float32, 4000 + i, h, d)[0]
            o, lse = flash_attention_fwd(q, k, v)
            errs[key] += check_attention_bwd(q, k, v, o, lse, do,
                                             f"d128 {key}")
        del q, k, v
    torch.cuda.empty_cache()
    gqa = {name: _gqa_check(dd, g, kv, 50 + i)
           for i, (name, (dd, g, kv)) in enumerate(PRESET_DG.items())}
    lengths = [0, 1, 127, 128, 1000, 1024, 600, 5]
    paged = [0, 1, 127, 128, 700, 1024, 600, 5]
    n_pages = sum(-(-ln // PAGE_SIZE) for ln in paged) + 4
    decode = {}
    dg = [("deepseek-moe-16b", (MOE_D, 1, MOE_H))] + list(PRESET_DG.items())
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, (dd, g, kv)) in enumerate(dg):
            key = f"{str(dtype)[6:]}_{name}_d{dd}_g{g}"
            decode[key] = check_decode(*_decode_inputs(
                8, 1024, g, dtype, lengths, 60 + i, kv, dd), key)
            decode[key + "_paged"] = check_paged(*_paged_inputs(
                paged, PAGE_SIZE, 1024 // PAGE_SIZE, n_pages, g, dtype,
                70 + i, holes=((6, 3),), h=kv, d=dd), key)
    for b, ln in ((8, main_lengths), (1, [cache_len - 149])):
        key = f"float32_moe_{b}x{cache_len}"
        decode[key] = check_decode(*_decode_inputs(
            b, cache_len, 1, torch.float32, ln, 80 + b, h, d), key)

    timing = time_flash(h, d, ((1, 512), (MOE_B, S_TRAIN)), MOE_B, "d128")
    timing["decode_moe_main"] = time_decode(*_decode_inputs(
        8, cache_len, 1, torch.float32, main_lengths, 9, h, d),
        "float32_moe_main")
    torch.cuda.empty_cache()
    emit("flash_d128", shape=f"H={h} D={d} fp32", max_err=errs,
         gqa_max_rel_err=gqa, decode_max_err=decode, timing=timing)
    return timing, ({(b, s, d) for b, s in prefills | train_shapes},
                    {(8, cache_len, d), (1, cache_len, d)})


def _moe_weights(n_layers: int = 0):
    """(config, fp32 params drawn on the card from a CUDA generator seeded
    with SEED, seconds)."""
    from repro_torch.models import model_zoo
    cfg = moe_config(n_layers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model_zoo.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED),
        torch.device("cuda"))
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def phase_engine_moe(dev: dict, fa_checked: set, fd_checked: set) -> dict:
    """Serves deepseek-moe-16b at full width, MOE_SERVE_LAYERS deep (fp32
    weights drawn on the card) in 8 slots of 576: the 16 requests of
    ``make_requests``, fcfs, with routing recorded.  Checks the launch
    counts (flash_attention_fwd layers x prefill calls; flash_decode_fwd
    layers x (fused + replay steps); no other kernel), that every request
    ran its budget, and the greedy streams against a twin engine on the
    same weight tensors with the plain backends, its routing pinned to the
    kernel engine's (:class:`PinnedRouting`); reports the prefills'
    dropped fraction and the device idle share over a steady decode
    window; fails if the phase leaves 64 MiB allocated."""
    from repro_torch.launch.serve import make_requests, scheduler_config
    from repro_torch.models import model_zoo
    from repro_torch.serve import Replica, prefill_split
    held = torch.cuda.memory_allocated()
    cfg, params, init_s = _moe_weights(MOE_SERVE_LAYERS)
    model = model_zoo.build_model(cfg)
    plain_model = model_zoo.build_model(cfg.replace(
        attn_backend="blockwise", decode_backend="reference"))
    reqs = make_requests(cfg, 16, PROMPT_LEN, GEN, seed=SEED)
    cfg_s = lambda **kw: scheduler_config(8, PROMPT_LEN, PROMPT_LEN + GEN,
                                          **kw)
    ladder = cfg_s().ladder()
    at_bucket = [dataclasses.replace(r, tokens=r.tokens[:prefill_split(
        len(r.tokens), ladder)]) for r in reqs[:8]]
    _serve_model(model, params, [dataclasses.replace(at_bucket[3],
                                                     max_tokens=4)])
    pins = PinnedRouting()
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    with pins.record():
        out = _serve_model(model, params, reqs)
    launches = {n: f.launches for n, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    stats, cache_len = out["stats"], out["engine"].cfg.cache_len
    del out["engine"]
    replay = _replay_steps(reqs, ladder)
    want = {n: 0 for n in counters}
    want["flash_attention_fwd"] = cfg.n_layers * len(reqs)
    want["flash_decode_fwd"] = cfg.n_layers * (stats.decode_steps + replay)
    check(launches == want, f"moe serve launches {launches} != {want}")
    check(all(r.n_generated == q.max_tokens and r.finish_reason == "length"
              for r, q in zip(out["results"], reqs)),
          "every moe request generated its budget")
    prefills = {(1, prefill_split(len(r.tokens), ladder), MOE_D)
                for r in reqs}
    check(prefills <= fa_checked, f"moe prefill shapes "
                                  f"{prefills - fa_checked} not checked")
    check({(8, cache_len, MOE_D), (1, cache_len, MOE_D)} <= fd_checked,
          "moe decode shapes not checked")
    dropped = torch.stack(pins.dropped)
    check(len(pins.dropped) == cfg.n_layers * len(reqs),
          f"{len(pins.dropped)} multi-token routing calls")
    counters = _zero_counters()
    with pins.replay():
        plain = _serve_model(plain_model, params, reqs)
    check(all(f.launches == 0 for f in counters.values()),
          "the plain backends launched a kernel")
    pinned = pins.replayed()
    diverged, gaps = check_streams(reqs, out["results"], plain["results"],
                                   plain["engine"], "moe")
    plain_rates = {"decode_tok_s": plain["decode_tok_s"],
                   "prefill_tok_s": plain["prefill_tok_s"]}
    del plain, pins
    torch.cuda.empty_cache()

    # device idle share over a steady decode window: the first 8 requests
    # at their buckets admitted, 6 fused steps untraced, 6 traced
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
    emit("engine_moe", card=dev["nvidia_smi"], arch=cfg.name,
         n_layers=cfg.n_layers, params=model_zoo.param_count(cfg),
         active_params=model_zoo.active_param_count(cfg),
         weight_init_s=init_s, prefill_tok_s=out["prefill_tok_s"],
         decode_tok_s=out["decode_tok_s"], p50_ms=out["p50_s"] * 1e3,
         p95_ms=out["p95_s"] * 1e3, prefill_calls=len(reqs),
         fused_steps=stats.decode_steps, replay_steps=replay,
         launches=launches, max_memory_allocated=peak,
         wall_ms=out["wall_s"] * 1e3,
         prefill_dropped_frac={"mean": dropped.mean().item(),
                               "max": dropped.max().item(),
                               "calls": len(dropped)},
         plain_twin={**plain_rates, "pinned_routing": pinned,
                     "diverged": diverged, "near_tie_gaps": gaps},
         traced_decode_window={"fused_steps": 6, "live_slots": 8,
                               "wall_ms_untraced": wall,
                               "device_busy_ms": busy,
                               "device_idle_share": 1 - busy / wall,
                               "top_kernels_ms": top})
    del model, plain_model, params, out, dropped
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - held
    check(left < 2**26, f"phase engine_moe left {left} bytes allocated")
    return {"serve_moe": {k: launches[k] for k in
                          ("flash_attention_fwd", "flash_decode_fwd")}}


def _planted_flash_fault():
    """Patches the flash Function's backward so dV comes out of the
    kernels x (1 + MOE_FAULT): a wrong backward the gradient check must
    catch."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import ops
    real = ops.flash_attention_bwd

    def faulty(*args, **kw):
        dq, dk, dv = real(*args, **kw)
        return dq, dk, dv * (1 + MOE_FAULT)
    return mock.patch.object(ops, "flash_attention_bwd", faulty)


def _compare_moe_grads(flash_model, plain_model, params, batch) -> dict:
    """Every gradient leaf of one batch through the flash kernels against
    the blockwise backend's, the plain run's routing pinned to the flash
    run's: each leaf within GRAD_RTOL of the plain leaf's largest entry,
    the attention projections, the router and the experts with a nonzero
    one; then the same with a planted dv x (1 + MOE_FAULT), which must
    break the limit."""
    pins = PinnedRouting()
    with pins.record():
        got = _grads(flash_model, params, batch)
    with pins.replay():
        ref = _grads(plain_model, params, batch)
    pinned = pins.replayed()
    names = _leaf_names(params)
    scales = [r.abs().max().item() for r in ref]
    rel = dict(zip(names, _leaf_errs(got, ref, scales)))
    del got
    for name, sc in zip(names, scales):
        if any(k in name for k in (".attn.", ".router", ".w_")):
            check(sc > 0, f"no gradient reaches {name}")
        check(rel[name] <= GRAD_RTOL, f"moe gradient {name}: {rel[name]}")
    with pins.replay(), _planted_flash_fault():
        bad = dict(zip(names, _leaf_errs(_grads(flash_model, params, batch),
                                         ref, scales)))
    over = sorted(k for k, v in bad.items() if v > GRAD_RTOL)
    check(bool(over), "the moe gradient check missed a planted dv fault")
    worst = max(rel, key=rel.get)
    del ref
    torch.cuda.empty_cache()
    return {"max_rel_err": rel[worst], "worst_leaf": worst,
            "attn_max_rel_err": max(v for k, v in rel.items()
                                    if ".attn." in k),
            "router_max_rel_err": max(v for k, v in rel.items()
                                      if k.endswith(".router")),
            "pinned_routing": pinned,
            "planted_fault": {"dv_scale": 1 + MOE_FAULT,
                              "max_rel_err": max(bad.values()),
                              "leaves_over_limit": len(over)}}


def phase_train_moe(dev: dict, fa_checked: set) -> dict:
    """Trains deepseek-moe-16b at full width, MOE_TRAIN_LAYERS of its 28
    layers deep, through the Trainer (remat "full", weights from a CUDA
    generator seeded with SEED): 20 SLW steps and one full-length eval,
    then 2 full-length steps untraced and 2 under the profiler.  Checks the
    plans against ``predict_trajectory``, finite losses and the launch
    counts; then every gradient leaf of the first step's batch at the
    initial weights and of the last step's (8 x 1024) at the trained
    weights against the blockwise backend, routing pinned
    (:func:`_compare_moe_grads`).  The initial weights wait on the host
    meanwhile."""
    from repro_torch.core.regulators import predict_trajectory
    from repro_torch.launch.train import Trainer
    from repro_torch.models import model_zoo
    from repro_torch.optim import transforms as optim_tx
    tc = moe_train_config()
    router = []
    trainer = Trainer(tc, eval_batch=MOE_EVAL, device="cuda",
                      callback=lambda step, m: router.append(
                          [m["load_balance"], m["router_z"],
                           m["dropped_frac"]]))
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

    check(res.steps == MOE_STEPS and not res.diverged, "moe trained 20 steps")
    check(all(math.isfinite(x) for x in res.loss_history), "moe finite losses")
    plans = predict_trajectory(tc, MOE_STEPS)
    ran = list(zip(res.seqlen_history, res.batch_history, res.lr_history))
    check(ran == [(p.seq_len, p.batch_size, p.lr) for p in plans],
          "the moe run's plans are predict_trajectory's")
    n_evals = len(res.val_ppl_history)
    check(n_evals == 1, f"{n_evals} moe evals")
    # remat "full": the backward recomputes each layer's forward
    want = {n: 0 for n in counters}
    for name in _fa_kernels():
        want[name] = n_layers * MOE_STEPS
    want["flash_attention_fwd"] = n_layers * (2 * MOE_STEPS + n_evals)
    want["fused_adamw"] = _fused_launches(tc, MOE_STEPS)
    check(launches == want, f"moe train launches {launches} != {want}")
    shapes = {(p.batch_size, p.seq_len, MOE_D) for p in plans} | {
        (MOE_EVAL, S_TRAIN, MOE_D)}
    check(shapes <= fa_checked, f"moe shapes {shapes - fa_checked}")

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
    emit("train_moe", card=dev["nvidia_smi"], arch=tc.model.name,
         n_layers=n_layers, params=model_zoo.param_count(tc.model),
         steps=res.steps, tokens=res.tokens, full_length_steps=len(full),
         tokens_per_s_full_length=full_tokens / sum(full_s),
         p50_step_ms_full_length=float(np.median(full_s)) * 1e3,
         first_loss=res.loss_history[0], last_loss=res.loss_history[-1],
         val_ppl=res.val_ppl_history,
         launches=launches, max_memory_allocated=peak,
         wall_s=res.wall_time_s,
         router_per_step={"keys": ["load_balance", "router_z",
                                   "dropped_frac"],
                          "seq_len": res.seqlen_history,
                          "values": router[:MOE_STEPS]},
         traced_2_full_steps={"wall_ms_untraced": wall,
                              "device_busy_ms": busy,
                              "device_idle_share": 1 - busy / wall,
                              "top_kernels_ms": top})

    trained = to_host(trainer.state["params"])
    trainer.state = None  # frees the params and the Adam moments
    torch.cuda.empty_cache()
    plain_model = model_zoo.build_model(
        tc.model.replace(attn_backend="blockwise"), remat=tc.remat)
    grads = {}
    for weights, i, is_trained in ((init, 0, False),
                                   (trained, MOE_STEPS - 1, True)):
        batch, _ = trainer.stack.apply(trainer.pipeline.batch_at(i), plans[i])
        batch = trainer.to_device(batch)
        params = to_card(weights)
        grads[f"{len(batch['tokens'])}x{plans[i].seq_len}"] = {
            "weights": "trained" if is_trained else "initial",
            **_compare_moe_grads(trainer.model, plain_model, params, batch)}
        del params
        torch.cuda.empty_cache()
    emit("train_moe_grads", leaves=len(_leaf_names(init)),
         norm_eps=tc.model.norm_eps, rtol=GRAD_RTOL, batches=grads)
    del trained, trainer, init, weights
    torch.cuda.empty_cache()
    return {name: launches[name] for name in _train_kernels()}



# ---------------------------------------------------------------------------
# the distributed slice: the flash kernels at qwen3-32b's head dim 80, then
# the sharded train step, sequence-sharded flash decode, the compressed
# all-reduce and the step's FLOP count on a one-rank NCCL group
# ---------------------------------------------------------------------------

QWEN_H, QWEN_D = 64, 80  # qwen3-32b: 64 heads of 80 (its 8 KV heads reach
#                          the kernels expanded to 64 by the Function)
DIST_STEPS = 8
# the sharded step against the unsharded one on the same card, every loss
# and parameter leaf (within DIST_RTOL x the leaf's largest entry); fixed
# before the first run: on a (1, 1) mesh both run the same kernels and the
# same optimizer chain on the same whole tensors, and only DTensor's own
# reductions (the clip's norm, the variance statistics) may sum in another
# order
DIST_RTOL = 1e-6
# the sharded step (the chain: the fused AdamW route takes no DTensors)
# against the unsharded main path (the fused AdamW kernel): one card run
# read the params 3.75e-6 of a leaf's largest entry apart after the 8
# steps (the losses within 1e-6), since the two optimizers' roundings feed
# the next steps' gradients and Adam's step turns a gradient entry's
# rounding near eps into a visible part of the LR; a sharding fault (a
# missed reduction, a shard's update dropped) moves a leaf by a good part
# of its whole update over the steps, which the phase reports
# (``update_leaf``)
DIST_MAIN_RTOL = 1e-5
DECODE_SHARDS = 4  # virtual sequence shards of the cache on the one card
DECODE_POS = 300  # of 576 rows: shards 0-1 full, 2 holds 12 rows, 3 empty
DECODE_ATOL = 1e-5  # the merged output against reference_decode
EF_SYNCS = 20


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_flash_d80() -> dict:
    """The flash kernels at qwen3-32b's head dim 80 (64 heads, fp32): the
    forward at 1 x 512 and 2 x 1024 and the three backward kernels at 2 x
    1024, each against its plain version and beside its plain version's
    time, SDPA's and its bound.  No path of this script runs them."""
    timing = time_flash(QWEN_H, QWEN_D, ((1, 512), (2, S_TRAIN)), 2, "d80")
    emit("flash_d80", shape=f"H={QWEN_H} (kv 8, expanded) D={QWEN_D} fp32",
         timing=timing)
    return timing


def _dist_steps(step, state, batches, plans) -> tuple:
    """(state, losses, var_max, grad_norm, seconds) of ``step`` over the
    plans."""
    losses, var_max, norms = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch, p in zip(batches, plans):
        state, m = step(state, batch, p.lr, p.grad_clip_scale)
        losses.append(m["loss"])
        var_max.append(m["var_max"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (state, *([float(x) for x in xs] for xs in (losses, var_max,
                                                       norms)), seconds)


def _dist_train(rules, tc, trainer) -> dict:
    """DIST_STEPS SLW steps of the train phase's config from its initial
    state and batches, through the unsharded step (the main path, whose
    optimizer is the fused AdamW kernel), the unsharded step on the chain
    (``fused=None``) and the sharded one (``fsdp`` rules: DTensor leaves,
    so the chain): losses, var_max and every parameter leaf, the sharded
    step against the chain within DIST_RTOL and against the main path
    within DIST_MAIN_RTOL."""
    from repro_torch.core.regulators import predict_trajectory
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import transforms as optim_tx
    plans = predict_trajectory(tc, DIST_STEPS)
    batches = [trainer.to_device(trainer.stack.apply(
        trainer.pipeline.batch_at(i), plans[i])[0]) for i in range(len(plans))]
    tokens = sum(p.batch_size * p.seq_len for p in plans)
    init = trainer.state
    model = trainer.model
    chain = optim_tx.build_optimizer(tc.optimizer)._replace(fused=None)
    kernels = _train_kernels()
    runs = {}
    for name, step, state in (
            ("main", steps_lib.make_train_step(model, tc.optimizer),
             _clone_state(init)),
            ("chain", steps_lib.make_train_step(model, tc.optimizer,
                                                optimizer=chain),
             _clone_state(init)),
            ("sharded", steps_lib.make_train_step(model, tc.optimizer, rules),
             steps_lib.shard_train_state(_clone_state(init), rules, tc.model,
                                         tc.optimizer))):
        for f in kernels.values():
            f.launches = 0
        state, loss, var, norm, seconds = _dist_steps(step, state, batches,
                                                      plans)
        runs[name] = {"params": optim_tx.tree_leaves(steps_lib.unshard_tree(
                          state["params"])), "loss": loss, "var": var,
                      "grad_norm": norm, "seconds": seconds,
                      "launches": {k: f.launches for k, f in kernels.items()},
                      "placements": optim_tx.tree_leaves(state["params"])[0]}
        del state
    flash = tc.model.n_layers * DIST_STEPS
    for name, fused in (("main", _fused_launches(tc, DIST_STEPS)),
                        ("chain", 0), ("sharded", 0)):
        want = _want_launches(tc.model.n_layers, DIST_STEPS, 0, fused)
        check(runs[name]["launches"] == want,
              f"{name} step launches {runs[name]['launches']} != {want}")
    rel = lambda a, b: abs(a - b) / abs(b)
    sharded = runs["sharded"]
    err, bits = {}, None
    for ref, rtol in (("chain", DIST_RTOL), ("main", DIST_MAIN_RTOL)):
        r = runs[ref]
        err[ref] = {
            "loss": max(rel(a, b) for a, b in zip(sharded["loss"], r["loss"])),
            "var_max": max(rel(a, b) for a, b in zip(sharded["var"],
                                                     r["var"])),
            "param_leaf": max(((a - b).abs().max() / b.abs().max()).item()
                              for a, b in zip(sharded["params"],
                                              r["params"]))}
        check(err[ref]["loss"] <= rtol,
              f"sharded losses against the {ref} step: {err[ref]['loss']}")
        check(err[ref]["param_leaf"] <= rtol, f"sharded params against the "
              f"{ref} step: {err[ref]['param_leaf']}")
        if bits is None:
            bits = (sharded["loss"] == r["loss"] and all(
                torch.equal(a, b) for a, b in zip(sharded["params"],
                                                  r["params"])))
    s = {name: r["seconds"] for name, r in runs.items()}
    # each leaf's whole update, max |p_8 - p_0| over max |p_0| (leaves
    # that start at 0 left out): the least and the median
    update = sorted(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(runs["main"]["params"],
                                    optim_tx.tree_leaves(init["params"]))
                    if b.abs().max() > 0)
    update = {"min": update[0], "median": update[len(update) // 2]}
    # where the main path and the chain part: each step's grad_norm (the
    # kernel sums in double, the chain in fp32), relative
    norm_gaps = [rel(a, b) for a, b in zip(runs["main"]["grad_norm"],
                                           runs["chain"]["grad_norm"])]
    return {"steps": DIST_STEPS, "tokens": tokens, "update_leaf": update,
            "grad_norm_gap_main_chain": norm_gaps,
            "plans": [(p.batch_size, p.seq_len) for p in plans],
            "max_rel_err": err["chain"], "max_rel_err_main": err["main"],
            "bits_equal": bits,
            "launches": {**{k: sharded["launches"][k] for k in _fa_kernels()},
                         "fused_adamw": runs["main"]["launches"][
                             "fused_adamw"]},
            "tokens_per_s": {"sharded": tokens / s["sharded"],
                             "unsharded": tokens / s["main"],
                             "unsharded_chain": tokens / s["chain"]},
            "seconds": {"sharded": s["sharded"], "unsharded": s["main"],
                        "unsharded_chain": s["chain"]},
            # the warm-up steps are short (64 to 3,600 tokens): what the
            # sharded step adds to each is DTensor's host dispatch (against
            # the unsharded step on the same chain)
            "host_overhead_ms_per_step": (s["sharded"] - s["chain"])
            / DIST_STEPS * 1e3,
            "placements": str(tuple(sharded["placements"].placements))}


def _dist_decode(mesh, main_lengths, cache_len: int) -> dict:
    """flash_decode_sharded on the kernel backend at gpt2's main lengths
    over the mesh's "data" axis, and DECODE_SHARDS virtual sequence shards
    of the same cache on the one card, each shard's kernel partials merged
    by ``merge_partials``: against ``reference_decode`` and, shard by
    shard, the plain partials."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.compat import (Replicate, Shard,
                                                distribute_tensor)
    from repro_torch.kernels.flash_decode import flash_decode_fwd
    q, kc, vc, lengths = _decode_inputs(8, cache_len, 1, torch.float32,
                                        main_lengths, 90, H, D)
    b = q.shape[0]
    qs = q.reshape(b, 1, H, D)
    kd, vd = (distribute_tensor(t, mesh, [Shard(1), Replicate()])
              for t in (kc, vc))
    fn = coll.flash_decode_sharded(mesh, "data", backend="kernel")
    flash_decode_fwd.launches = 0
    out = fn(qs, kd, vd, lengths)
    launches = flash_decode_fwd.launches
    check(launches == 1, f"flash_decode_sharded launches {launches}")
    ref = coll.reference_decode(qs, kc, vc, lengths)
    errs = {"sharded_main": (out - ref).abs().max().item()}
    sl = cache_len // DECODE_SHARDS
    filled = {}
    for name, pos in (("virtual_main", lengths),
                      ("virtual_300", DECODE_POS)):
        parts, part_errs = [], []
        for r in range(DECODE_SHARDS):
            k_r, v_r = (t[:, r * sl:(r + 1) * sl].contiguous()
                        for t in (kc, vc))
            ln = coll.shard_lengths(pos, r * sl, sl, b, q.device)
            got = coll.local_partials(q.reshape(b, H, D), k_r, v_r, ln, True)
            part_errs.append(check_partials(
                got, coll.local_partials(q.reshape(b, H, D), k_r, v_r, ln,
                                         False), ln, f"{name} shard {r}"))
            parts.append(got)
            filled.setdefault(name, []).append(int(ln.sum()))
        o, m, l = (torch.stack(x) for x in zip(*parts))
        merged = coll.merge_partials(o, m, l, *coll.stacked_reductions())
        ref = coll.reference_decode(qs, kc, vc, pos)
        errs[name] = (merged.reshape(b, 1, H, D) - ref).abs().max().item()
        errs[name + "_partials"] = max(max(e) for e in part_errs)
    # DECODE_POS: two shards full, one partly filled, one empty
    check(filled["virtual_300"] == [b * sl, b * sl, b * (DECODE_POS - 2 * sl),
                                    0], f"shard fill {filled}")
    check(all(v <= DECODE_ATOL for k, v in errs.items()
              if not k.endswith("_partials")), f"sharded decode {errs}")
    return {"max_abs_err": errs, "rows_per_shard": filled,
            "launches": launches}


def _dist_compressed(mesh, grads) -> dict:
    """EF_SYNCS error-feedback syncs of one gradient tree over the mesh's
    "data" axis (NCCL): the running mean against the gradient (relative l2
    error, falling at syncs 1, 5 and EF_SYNCS), the error-feedback identity
    ``mean_n = g - e_n / n``, and one sync's time; then the reference
    test's own property, 40 syncs of a 4-vector within 0.05."""
    from repro_torch.optim.compression import (compressed_allreduce,
                                               init_error_state)
    sync = compressed_allreduce(mesh, "data")
    err = init_error_state(grads)
    acc = [torch.zeros_like(g) for g in grads]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads])).item()
    rel_l2, ms = {}, []
    for n in range(1, EF_SYNCS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, err = sync(grads, err)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        torch._foreach_add_(acc, mean)
        if n in (1, 5, EF_SYNCS):
            diff = [a / n - g for a, g in zip(acc, grads)]
            rel_l2[n] = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(x) for x in diff])).item() / norm
    leaf_scale = [g.abs().max().clamp_min(1e-30) for g in grads]
    ident = max(((a / EF_SYNCS - g + e / EF_SYNCS).abs().max() / s).item()
                for a, g, e, s in zip(acc, grads, err, leaf_scale))
    check(ident <= 1e-5, f"error-feedback identity {ident}")
    check(rel_l2[EF_SYNCS] < rel_l2[5] < rel_l2[1],
          f"the running mean does not converge: {rel_l2}")
    g4 = [torch.tensor([0.5, -0.02, 0.3, -0.7], device="cuda")]
    err4, acc4 = init_error_state(g4), torch.zeros(4, device="cuda")
    for _ in range(40):
        mean4, err4 = sync(g4, err4)
        acc4 += mean4[0]
    dev4 = (acc4 / 40 - g4[0]).abs().max().item()
    check(dev4 <= 0.05, f"the 4-vector's running mean: {dev4}")
    return {"syncs": EF_SYNCS, "leaves": len(grads),
            "rel_l2_err": rel_l2, "identity_err": ident,
            "sync_ms_p50": float(np.median(ms[1:])), "first_sync_ms": ms[0],
            "vector_40_max_err": dev4}


def _timed_steps(step, state, batch, n: int = 3) -> float:
    """ms a step of ``step`` on ``batch``, the mean of ``n`` after one
    untimed step."""
    state, _ = step(state, batch, 1e-5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = step(state, batch, 1e-5)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _dist_flops(tc, trainer, rules) -> dict:
    """The analytic model FLOPs of one B_TRAIN x S_TRAIN training step
    against ``roofline.op_cost``'s count of the same unsharded step (its
    aten ops plus the flash kernels' reported work), and that step's share
    of the fp32 peak (TF32 off) at its measured time; the same step
    through the sharded train step (``rules``), timed beside it."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model_zoo
    from repro_torch.roofline.analysis import model_flops
    from repro_torch.roofline.op_cost import analyze_fn
    batch = trainer.to_device(trainer.pipeline.batch_at(0))
    check(tuple(batch["tokens"].shape) == (B_TRAIN, S_TRAIN),
          f"full-length batch {tuple(batch['tokens'].shape)}")
    step = steps_lib.make_train_step(trainer.model, tc.optimizer)
    state = _clone_state(trainer.state)
    cost, _ = analyze_fn(step, state, batch, 1e-5)
    ms = _timed_steps(step, state, batch)
    del state
    sharded_ms = _timed_steps(
        steps_lib.make_train_step(trainer.model, tc.optimizer, rules),
        steps_lib.shard_train_state(_clone_state(trainer.state), rules,
                                    tc.model, tc.optimizer), batch)
    want = model_flops(tc.model, "train", B_TRAIN, S_TRAIN,
                       model_zoo.active_param_count(tc.model))
    return {"shape": f"{B_TRAIN}x{S_TRAIN}", "model_flops": want,
            "op_cost_flops": cost.flops, "ratio": cost.flops / want,
            "op_cost_bytes": cost.bytes, "flops_by_op": cost.top(6),
            "step_ms": ms, "sharded_step_ms": sharded_ms,
            "sharded_over_unsharded": sharded_ms / ms,
            "fp32_peak_share": cost.flops / (ms * 1e-3 * hw.PEAK_FLOPS_FP32),
            "model_fp32_peak_share": want / (ms * 1e-3
                                             * hw.PEAK_FLOPS_FP32)}


def phase_distributed(dev: dict, train_tokens_s: float, main_lengths,
                      cache_len: int) -> dict:
    """The distributed slice at full gpt2-117m width on a one-rank NCCL
    group and a (1, 1) ("data", "model") mesh: DIST_STEPS SLW steps of
    the sharded train step (``fsdp`` rules) against the unsharded step
    from the train phase's initial state and batches; flash_decode_sharded
    and DECODE_SHARDS virtual shards' kernel partials merged; EF_SYNCS
    compressed all-reduces of a gpt2 gradient tree; the model FLOPs of a
    16 x 1024 step against its op count, and that step's time sharded and
    unsharded.  Fails without NCCL."""
    import torch.distributed as dist
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.train import Trainer
    from repro_torch.optim import transforms as optim_tx
    check(dist.is_available() and dist.is_nccl_available(),
          "torch.distributed has no NCCL")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        backend = dist.get_backend()
        check(backend == "nccl", f"backend {backend}")
        mesh = make_host_mesh((1, 1), ("data", "model"), "cuda")
        rules = ShardingRules.make(mesh, "fsdp")
        tc = train_config()
        trainer = Trainer(tc, eval_batch=EVAL_BATCH, device="cuda")
        train = _dist_train(rules, tc, trainer)
        decode = _dist_decode(mesh, main_lengths, cache_len)
        batch = trainer.to_device(trainer.pipeline.batch_at(0))
        leaves = optim_tx.tree_leaves(trainer.state["params"])
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = trainer.model.loss(trainer.state["params"], batch)
        grads = steps_lib.loss_grads(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        del loss
        compressed = _dist_compressed(mesh, grads)
        del grads
        flops = _dist_flops(tc, trainer, rules)
        del trainer
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    emit("distributed", card=dev["nvidia_smi"], backend=backend, mesh="1x1",
         rules="fsdp", train=train, train_phase_tokens_per_s=train_tokens_s,
         decode=decode, compressed=compressed, flops=flops)
    return {"launches": {**train["launches"],
                         "flash_decode_fwd": decode["launches"]}}


# ---------------------------------------------------------------------------
# the paper's GPT-2 1.5B at full width and depth: the flash kernels at its
# 25 heads, training under remat "dots" (and the three remat policies side
# by side), then serving on the trained weights; and remat "dots" on the
# recurrent families
# ---------------------------------------------------------------------------

XL_H = 25  # gpt2-1.5b: 25 heads of 64 (48 layers, d 1600)
# the paper's recipe at a size one card holds: global batch 8 at S 1024,
# SLW linear from 64 (rounded to 8) over the first 4 steps, 8 steps, one
# full-length eval
XL_B, XL_STEPS, XL_WARMUP, XL_START, XL_EVAL = 8, 8, 4, 64, 8
XL_REMAT_B = 4  # the remat policies side by side: one 4 x 1024 batch
XL_REQUESTS, XL_GEN = 8, 32  # served: 8 requests, 32 greedy tokens each
# "dots" (and "full") against "none", leaf by leaf: the recompute runs the
# same kernels on the same inputs, so the gradients should be bit-equal;
# fixed before the first run, any difference above this share of a leaf's
# largest entry fails
REMAT_RTOL = 1e-6
FWD_KERNELS = ("flash_attention_fwd", "wkv6_fwd", "ssd_fwd")


def xl_config():
    from repro_torch.configs import get_arch
    return get_arch("gpt2-1.5b")


def xl_train_config(remat: str = "dots"):
    """The 1.5B run: AdamW as :func:`train_config`'s, its warmup over the
    SLW steps."""
    from repro_torch.configs import (OptimizerConfig, SLWConfig,
                                     TrainConfig)
    tokens = XL_STEPS * XL_B * S_TRAIN
    return TrainConfig(
        model=xl_config(),
        optimizer=OptimizerConfig(
            lr=6e-4, schedule="token_cosine", warmup_steps=XL_WARMUP,
            warmup_tokens=XL_WARMUP * XL_B * S_TRAIN, total_steps=XL_STEPS,
            total_tokens=tokens),
        slw=SLWConfig(enabled=True, pacing="linear", start_seq_len=XL_START,
                      duration_steps=XL_WARMUP, round_multiple=8,
                      max_buckets=12),
        seq_len=S_TRAIN, global_batch=XL_B, seed=SEED, remat=remat,
        eval_interval=XL_STEPS)


def xl_requests():
    """The XL_REQUESTS prompts of ``make_requests`` cut to their prefill
    buckets (512, 384 and 256 tokens: no replay steps, which at 48
    layers would take the host ~60 ms each), XL_GEN greedy tokens each."""
    from repro_torch.launch.serve import make_requests, scheduler_config
    from repro_torch.serve import prefill_split
    ladder = scheduler_config(8, PROMPT_LEN, PROMPT_LEN + GEN).ladder()
    return [dataclasses.replace(r, tokens=r.tokens[:prefill_split(
        len(r.tokens), ladder)], max_tokens=XL_GEN) for r in make_requests(
            xl_config(), XL_REQUESTS, PROMPT_LEN, XL_GEN, seed=SEED)]


def phase_flash_xl(train_shapes, prefills, cache_len: int) -> tuple:
    """The flash kernels at gpt2-1.5b's 25 heads of 64 (fp32): the forward
    at every serving prefill and training shape, the three backward
    kernels at every training shape, and the decode kernel at G = 1 on
    the fused step (8 slots) and a replay row, each against its plain
    version; times the forward at 1 x 512 and XL_B x 1024, the backward
    kernels at XL_B x 1024 and decode on the fused step."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    errs = {}
    for i, (b, s) in enumerate(sorted(prefills | train_shapes)):
        key = f"{b}x{s}"
        q, k, v = _attn_inputs(b, s, torch.float32, 5000 + i, XL_H, D)
        errs[key] = check_attention(q, k, v, f"xl {key}")
        if (b, s) in train_shapes:
            do = _attn_inputs(b, s, torch.float32, 6000 + i, XL_H, D)[0]
            o, lse = flash_attention_fwd(q, k, v)
            errs[key] += check_attention_bwd(q, k, v, o, lse, do,
                                             f"xl {key}")
        del q, k, v
    lengths = [len(r.tokens) + XL_GEN // 2 for r in xl_requests()]
    decode = {}
    for b, ln in ((8, lengths), (1, [cache_len - 149])):
        key = f"float32_xl_{b}x{cache_len}"
        decode[key] = check_decode(*_decode_inputs(
            b, cache_len, 1, torch.float32, ln, 90 + b, XL_H, D), key)
    torch.cuda.empty_cache()
    timing = time_flash(XL_H, D, ((1, 512), (XL_B, S_TRAIN)), XL_B, "xl")
    timing["decode_xl_main"] = time_decode(*_decode_inputs(
        8, cache_len, 1, torch.float32, lengths, 9, XL_H, D),
        "float32_xl_main")
    torch.cuda.empty_cache()
    emit("flash_gpt2_1p5b", shape=f"H={XL_H} D={D} fp32", max_err=errs,
         decode_max_err=decode, timing=timing)
    return timing, (prefills | train_shapes,
                    {(8, cache_len), (1, cache_len)})


def compare_remat(names, got, ref, what: str) -> dict:
    """Gradients of one policy against another's, leaf by leaf: the
    bit-equal leaves, and the largest difference over the leaf's largest
    entry; fails above REMAT_RTOL."""
    rel, equal = {}, 0
    for name, a, r in zip(names, got, ref):
        if torch.equal(a, r):
            equal += 1
            rel[name] = 0.0
            continue
        rel[name] = ((a - r).abs().max()
                     / r.abs().max().clamp_min(1e-30)).item()
    worst = max(rel, key=rel.get)
    check(rel[worst] <= REMAT_RTOL,
          f"{what}: gradient {worst} off by {rel[worst]} of its largest "
          f"entry")
    return {"leaves": len(rel), "bit_equal_leaves": equal,
            "max_rel_err": rel[worst], "worst_leaf": worst}


def _summed(*counts) -> dict:
    out = {}
    for c in counts:
        for name, n in c.items():
            out[name] = out.get(name, 0) + n
    return out


def _remat_grads(cfg, remat: str, params, batch) -> tuple:
    """(gradients of one loss-and-backward pass under ``remat``, seconds,
    peak bytes above what was allocated before, launches)."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model_zoo
    from repro_torch.optim import transforms as optim_tx
    model = model_zoo.build_model(cfg, remat=remat)
    leaves = optim_tx.tree_leaves(params)
    counters = _zero_counters()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = model.loss(params, batch)
        grads = steps_lib.loss_grads(loss, leaves)
        del loss
    finally:
        for p in leaves:
            p.requires_grad_(False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (grads, seconds, torch.cuda.max_memory_allocated() - base,
            {n: f.launches for n, f in counters.items() if f.launches})


def _remat_shape(train_shapes) -> tuple:
    """The training (batch, S) nearest 2,048 tokens: a small batch the
    kernels were checked at in both directions."""
    return min(train_shapes, key=lambda bs: (abs(bs[0] * bs[1] - 2048), bs))


def check_remat_dots(cfg, params, shape, what: str) -> dict:
    """One loss-and-gradient pass at ``shape`` under remat "none", then
    "dots": every gradient leaf bit-equal or within REMAT_RTOL of its
    largest entry, and under "dots" each forward kernel launched twice as
    often (the backward recomputes it), each backward kernel as often."""
    from repro_torch.models import model_zoo
    b, s = shape
    batch = {k: torch.from_numpy(v).to("cuda").long()
             for k, v in model_zoo.make_train_batch(SEED, cfg, b, s).items()}
    ref, _, _, base = _remat_grads(cfg, "none", params, batch)
    got, _, _, launches = _remat_grads(cfg, "dots", params, batch)
    want = {n: c * (2 if n in FWD_KERNELS else 1) for n, c in base.items()}
    check(bool(base) and launches == want,
          f"{what} remat dots launches {launches} != {want}")
    out = compare_remat(_leaf_names(params), got, ref, f"{what} dots")
    del ref, got
    torch.cuda.empty_cache()
    return {"shape": f"{b}x{s}", "n_layers": cfg.n_layers,
            "launches_none": base, "launches_dots": launches, **out}


def phase_train_xl(dev: dict, checked: set) -> dict:
    """Trains gpt2-1.5b at full width and depth through the Trainer under
    remat "dots" (weights from a CUDA generator seeded with SEED): XL_STEPS
    SLW steps and one full-length eval, then 2 full-length steps untraced
    and 2 under the profiler.  Checks the plans against
    ``predict_trajectory``, finite losses, the launch counts (each layer's
    forward kernel twice a step, the backward recomputing it) and that
    every (batch, S) was checked at 25 heads.  Then the remat policies
    side by side on the trained weights, one XL_REMAT_B x 1024 batch,
    gradients only: each one's peak memory and time, and "dots" and
    "full" against "none" (:func:`compare_remat`).  Returns the trained
    params for the serving phase."""
    from repro_torch.core.regulators import predict_trajectory
    from repro_torch.launch.train import Trainer
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import REMATS
    tc = xl_train_config()
    cfg = tc.model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = Trainer(tc, eval_batch=XL_EVAL, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    res = trainer.run()
    launches = {n: f.launches for n, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    n_layers = cfg.n_layers

    check(res.steps == XL_STEPS and not res.diverged, "xl trained 8 steps")
    check(all(math.isfinite(x) for x in res.loss_history),
          "xl finite losses")
    plans = predict_trajectory(tc, XL_STEPS)
    ran = list(zip(res.seqlen_history, res.batch_history, res.lr_history))
    check(ran == [(p.seq_len, p.batch_size, p.lr) for p in plans],
          "the xl run's plans are predict_trajectory's")
    n_evals = len(res.val_ppl_history)
    check(n_evals == 1, f"{n_evals} xl evals")
    # remat "dots": the backward recomputes each layer's forward kernel
    want = {n: 0 for n in counters}
    for name in _fa_kernels():
        want[name] = n_layers * XL_STEPS
    want["flash_attention_fwd"] = n_layers * (2 * XL_STEPS + n_evals)
    want["fused_adamw"] = _fused_launches(tc, XL_STEPS)
    check(launches == want, f"xl train launches {launches} != {want}")
    shapes = {(p.batch_size, p.seq_len) for p in plans} | {(XL_EVAL,
                                                            S_TRAIN)}
    check(shapes <= checked, f"xl shapes {shapes - checked} not checked")

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
    emit("train_gpt2_1p5b", card=dev["nvidia_smi"], arch=cfg.name,
         n_layers=n_layers, params=model_zoo.param_count(cfg),
         remat=tc.remat, weight_init_s=init_s, steps=res.steps,
         tokens=res.tokens, full_length_steps=len(full),
         tokens_per_s_full_length=full_tokens / sum(full_s),
         p50_step_ms_full_length=float(np.median(full_s)) * 1e3,
         seq_len=res.seqlen_history, losses=res.loss_history,
         val_ppl=res.val_ppl_history,
         launches=launches, max_memory_allocated=peak,
         wall_s=res.wall_time_s,
         traced_2_full_steps={"wall_ms_untraced": wall,
                              "device_busy_ms": busy,
                              "device_idle_share": 1 - busy / wall,
                              "top_kernels_ms": top})

    # the remat policies side by side: the optimizer state goes first
    params = trainer.state["params"]
    trainer.state = None
    del trainer
    torch.cuda.empty_cache()
    check((XL_REMAT_B, S_TRAIN) in checked, "the remat batch's shape")
    batch = {k: torch.from_numpy(v).to("cuda").long()
             for k, v in model_zoo.make_train_batch(
                 SEED, cfg, XL_REMAT_B, S_TRAIN).items()}
    names = _leaf_names(params)
    policies, ref, remat_launches = {}, None, {}
    # "none" first: the others are held against its gradients
    for remat in ("none", *(r for r in REMATS if r != "none")):
        want = {n: n_layers for n in _fa_kernels()}
        want["flash_attention_fwd"] = n_layers * (1 if remat == "none" else 2)
        # the first pass grows the allocator's cache; the second is timed
        first_grads, first, _, first_k = _remat_grads(cfg, remat, params,
                                                      batch)
        del first_grads
        check(first_k == want,
              f"xl {remat} first pass launches {first_k} != {want}")
        grads, seconds, above, ran_k = _remat_grads(cfg, remat, params,
                                                    batch)
        check(ran_k == want, f"xl {remat} launches {ran_k} != {want}")
        policies[remat] = {"ms": seconds * 1e3, "first_pass_ms": first * 1e3,
                           "peak_bytes_above": above,
                           "launches_first_pass": first_k, "launches": ran_k}
        if ref is None:
            ref = grads
        else:
            policies[remat].update(compare_remat(names, grads, ref,
                                                 f"xl {remat}"))
        remat_launches = _summed(remat_launches, first_k, ran_k)
        del grads
        torch.cuda.empty_cache()
    del ref, batch
    torch.cuda.empty_cache()
    emit("remat_gpt2_1p5b", card=dev["nvidia_smi"],
         batch=f"{XL_REMAT_B}x{S_TRAIN}", rtol=REMAT_RTOL,
         policies=policies)
    return {"params": params, "launches": {
        "train_gpt2_1p5b": {n: launches[n] for n in _train_kernels()},
        "remat_gpt2_1p5b": remat_launches}}


def phase_serve_xl(dev: dict, params, fa_checked: set,
                   fd_checked: set) -> dict:
    """Serves gpt2-1.5b at full width and depth on the trained weights in
    8 slots of 576: the XL_REQUESTS prompts of :func:`xl_requests`,
    XL_GEN greedy tokens each, fcfs.  Checks the launch counts
    (flash_attention_fwd layers x prefill calls, flash_decode_fwd layers x
    (fused + replay steps), no other kernel), that every shape was
    checked at 25 heads, and the greedy streams against a twin engine on
    the same weight tensors with the plain backends; reports the idle
    share of a steady decode window; fails if the phase leaves 64 MiB
    allocated beyond the weights."""
    from repro_torch.launch.serve import scheduler_config
    from repro_torch.models import model_zoo
    from repro_torch.serve import Replica, prefill_split
    held = torch.cuda.memory_allocated()
    cfg = xl_config()
    model = model_zoo.build_model(cfg)
    plain_model = model_zoo.build_model(cfg.replace(
        attn_backend="blockwise", decode_backend="reference"))
    reqs = xl_requests()
    cfg_s = scheduler_config(8, PROMPT_LEN, PROMPT_LEN + GEN)
    ladder = cfg_s.ladder()
    _serve_model(model, params, [dataclasses.replace(reqs[3],
                                                     max_tokens=4)])
    counters = _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    out = _serve_model(model, params, reqs)
    launches = {n: f.launches for n, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    stats, cache_len = out["stats"], out["engine"].cfg.cache_len
    del out["engine"]
    replay = _replay_steps(reqs, ladder)
    want = {n: 0 for n in counters}
    want["flash_attention_fwd"] = cfg.n_layers * len(reqs)
    want["flash_decode_fwd"] = cfg.n_layers * (stats.decode_steps + replay)
    check(launches == want, f"xl serve launches {launches} != {want}")
    check(all(r.n_generated == XL_GEN and r.finish_reason == "length"
              for r in out["results"]), "every xl request generated 32")
    prefills = {(1, prefill_split(len(r.tokens), ladder)) for r in reqs}
    check(prefills <= fa_checked,
          f"xl prefill shapes {prefills - fa_checked} not checked")
    decodes = {(8, cache_len)} | ({(1, cache_len)} if replay else set())
    check(decodes <= fd_checked, f"xl decode shapes {decodes} not checked")
    counters = _zero_counters()
    plain = _serve_model(plain_model, params, reqs)
    check(all(f.launches == 0 for f in counters.values()),
          "the plain backends launched a kernel")
    diverged, gaps = check_streams(reqs, out["results"], plain["results"],
                                   plain["engine"], "xl")
    plain_rates = {"decode_tok_s": plain["decode_tok_s"],
                   "prefill_tok_s": plain["prefill_tok_s"],
                   "p50_ms": plain["p50_s"] * 1e3}
    del plain
    torch.cuda.empty_cache()

    # device idle share over a steady decode window: the 8 requests
    # admitted, 6 fused steps untraced, 6 traced
    window = Replica(model, params, cfg_s, device="cuda")
    for r in reqs[:8]:
        window.scheduler.submit(r)
    while window.admit():
        pass
    check(len(window.scheduler.active) == 8, "the xl decode window's slots")
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
    emit("serve_gpt2_1p5b", card=dev["nvidia_smi"], arch=cfg.name,
         n_layers=cfg.n_layers, heads=cfg.n_heads,
         prefill_tok_s=out["prefill_tok_s"],
         decode_tok_s=out["decode_tok_s"], p50_ms=out["p50_s"] * 1e3,
         p95_ms=out["p95_s"] * 1e3, prefill_calls=len(reqs),
         fused_steps=stats.decode_steps, replay_steps=replay,
         launches=launches, max_memory_allocated=peak,
         wall_ms=out["wall_s"] * 1e3,
         plain_twin={**plain_rates, "diverged": diverged,
                     "near_tie_gaps": gaps},
         traced_decode_window={"fused_steps": 6, "live_slots": 8,
                               "wall_ms_untraced": wall,
                               "device_busy_ms": busy,
                               "device_idle_share": 1 - busy / wall,
                               "top_kernels_ms": top})
    del model, plain_model, out
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - held
    check(left < 2**26, f"phase serve_gpt2_1p5b left {left} bytes allocated")
    return {"serve_gpt2_1p5b": {k: launches[k] for k in
                                ("flash_attention_fwd", "flash_decode_fwd")}}


# the fused AdamW phase's parameter sets: the benchmark's two models
ADAMW_MODELS = (("deepseek-moe-16b", {"n_layers": 4}), ("gpt2-1.5b", {}))


def _adamw_check(tx, shapes, hyper) -> dict:
    """One step of the default AdamW chain ``tx`` from its initial state
    over leaves of ``shapes`` (params N(0, 0.02), gradients N(0, 1e-2)
    from SEED), through the fused route and through the chain (``update``
    + ``apply_updates``) from the same inputs, held at the card test's
    tolerances (``tests/test_torch_fused_adamw.py``): count exact; m and v
    within 2e-6 of the entry plus 2e-6 of the leaf's largest entry; params
    within 2 float32 ulps plus 1e-5 of the LR; the five telemetry scalars
    within 1e-5.  The kernel's p, m and v wait on the host while the chain
    runs, so the card holds one set of both at a time.  Returns the worst
    readings."""
    from repro_torch.kernels.fused_adamw import TELEMETRY, fused_adamw
    from repro_torch.optim import transforms as optim_tx

    def draw(seed, scale):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return optim_tx.tree_map(lambda m: torch.randn(
            m.shape, generator=gen, device="cuda") * scale, shapes)
    grads = draw(SEED + 1, 1e-2)  # the kernel leaves them as they are
    params = draw(SEED, 0.02)
    launches = fused_adamw.launches
    _, opt, tel = optim_tx.optimizer_step(tx, grads, tx.init(params), params,
                                          hyper)
    check(fused_adamw.launches == launches + 1, "the fused route did not "
          "launch the kernel")
    host = lambda tree: [t.cpu() for t in optim_tx.tree_leaves(tree)]
    fused = {"p": host(params), "m": host(opt["adam"]["m"]),
             "v": host(opt["adam"]["v"]), "count": int(opt["adam"]["count"]),
             "tel": {k: float(v) for k, v in tel.items()}}
    del params, opt, tel
    params = draw(SEED, 0.02)
    with torch.no_grad():
        u, opt, tel = tx.update(grads, tx.init(params), params, hyper)
        optim_tx.apply_updates(params, u)
    del u, grads
    check(list(fused["tel"]) == list(tel) == list(TELEMETRY),
          f"telemetry keys {list(fused['tel'])} != {list(tel)}")
    check(fused["count"] == int(opt["adam"]["count"]) == 1, "count")
    worst = {}
    for key, ref, rtol, atol in (
            ("p", params, 2.4e-7, lambda b: 1e-5 * hyper["lr"]),
            ("m", opt["adam"]["m"], 2e-6, lambda b: 2e-6 * b.abs().max()),
            ("v", opt["adam"]["v"], 2e-6, lambda b: 2e-6 * b.abs().max())):
        worst[key] = 0.0
        for i, (a, b) in enumerate(zip(fused[key],
                                       optim_tx.tree_leaves(ref))):
            gap = (a.to("cuda") - b).abs()
            over = float((gap - rtol * b.abs()).max() - atol(b))
            check(over <= 0, f"{key} leaf {i}: {float(gap.max())} past the "
                  f"tolerance")
            worst[key] = max(worst[key], float(gap.max() / b.abs().max()))
        fused[key] = None
    for k, v in tel.items():
        worst[k] = abs(fused["tel"][k] - float(v)) / abs(float(v))
        check(worst[k] <= 1e-5, f"telemetry {k}: {fused['tel'][k]} against "
              f"the chain's {float(v)}")
    del params, opt, tel
    torch.cuda.empty_cache()
    return worst


def phase_fused_adamw(dev: dict) -> dict:
    """The default AdamW chain's fused route (``optimizer_step``: the
    kernel of ``kernels/fused_adamw``) over every leaf of each model in
    :data:`ADAMW_MODELS`, fp32: first one step from the chain's initial
    state against the chain from the same inputs (:func:`_adamw_check`),
    then one step of each timed, params N(0, 0.02), gradients N(0, 1e-2).
    Bound: pass 1 reads g, pass 2 reads p, g, m, v and writes p, m, v: 8 N
    x 4 bytes at 3.35 TB/s.  Also each one's device memory beyond the
    params, gradients and moments, and the launches."""
    from repro_torch.configs import OptimizerConfig, get_arch
    from repro_torch.kernels.fused_adamw import fused_adamw
    from repro_torch.models import model_zoo
    from repro_torch.optim import transforms as optim_tx
    out = {}
    for name, over in ADAMW_MODELS:
        cfg = dataclasses.replace(get_arch(name), **over)
        shapes = model_zoo.abstract_params(cfg)
        tx = optim_tx.build_optimizer(OptimizerConfig())
        hyper = {"lr": 1e-4, "clip_scale": 1.0}
        worst = _adamw_check(tx, shapes, hyper)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        draw = lambda m, s: torch.randn(m.shape, generator=gen,
                                        device="cuda") * s
        params = optim_tx.tree_map(lambda m: draw(m, 0.02), shapes)
        grads = optim_tx.tree_map(lambda m: draw(m, 1e-2), shapes)
        n = sum(p.numel() for p in optim_tx.tree_leaves(params))
        state = {"opt": tx.init(params)}

        def fused():
            _, state["opt"], _ = optim_tx.optimizer_step(
                tx, grads, state["opt"], params, hyper)

        def plain():
            with torch.no_grad():
                u, state["opt"], _ = tx.update(grads, state["opt"], params,
                                               hyper)
                optim_tx.apply_updates(params, u)

        extra = {}
        for what, fn in (("fused", fused), ("plain", plain)):
            fn()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            extra[what] = torch.cuda.max_memory_allocated() - base
        launches = fused_adamw.launches
        ms = device_ms(fused, iters=10)
        check(fused_adamw.launches - launches >= 11,
              f"{name}: the fused route launched the kernel "
              f"{fused_adamw.launches - launches} times in 11 calls")
        plain_ms = call_ms(plain, 3, 1)
        nbytes = 8 * n * 4
        least, by = bound(nbytes, 0.0, torch.float32)
        out[name] = {"params": n, "leaves": len(optim_tx.tree_leaves(params)),
                     "max_rel_err": worst,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": least,
                     "bound_by": by, "roofline_pct": 100 * least / ms,
                     "gb_per_s": nbytes / ms / 1e6,
                     "fused_extra_bytes": extra["fused"],
                     "plain_extra_bytes": extra["plain"]}
        emit("fused_adamw", card=dev["nvidia_smi"], model=name, **out[name])
        del params, grads, state, tx
        torch.cuda.empty_cache()
    return out


def main() -> int:
    dev = phase_device()
    build = phase_build()
    phase_fa_design(build)
    phase_decode_design(build)
    del build
    fa_timing, fa_checked = phase_flash_attention()
    from repro_torch.launch.serve import make_requests
    from repro_torch.configs import get_arch
    # main-path decode lengths: the first 8 requests mid-generation, in the
    # slot cache of prompt_len + gen_tokens that _serve gives the engine
    main_lengths = [len(r.tokens) + r.max_tokens // 2 for r in make_requests(
        get_arch("gpt2-117m"), 8, PROMPT_LEN, GEN, seed=SEED)]
    phase_decode_launches(main_lengths, PROMPT_LEN + GEN)
    fd_timing, fd_checked = phase_flash_decode(main_lengths, PROMPT_LEN + GEN)
    engine = phase_engine(dev, fa_checked, fd_checked)
    phase_parity(engine)
    pd_timing, pd_checked = phase_flash_decode_paged(main_lengths,
                                                     PROMPT_LEN + GEN)
    emit("decode_nan", **check_decode_nan_propagation(main_lengths,
                                                      PROMPT_LEN + GEN))
    paged_launches = phase_engine_paged(dev, engine, fa_checked, fd_checked,
                                        pd_checked)
    router_launches = phase_router(engine)
    serve_launches = engine["launches"]
    del engine
    torch.cuda.empty_cache()

    from repro_torch.core.regulators import predict_trajectory
    train_shapes = {(p.batch_size, p.seq_len) for p in predict_trajectory(
        train_config(), TRAIN_STEPS)} | {(EVAL_BATCH, S_TRAIN)}
    train_shapes |= paper_shapes() | telemetry_shapes() | recovery_shapes()
    bwd_timing, bwd_checked = phase_flash_attention_bwd(train_shapes)
    train = phase_train(dev, bwd_checked)
    phase_train_parity(train)
    train_launches = train["launches"]
    train_tokens_s = train["tokens_per_s"]
    clean = {k: train[k] for k in ("result", "peak", "tokens_per_s")}
    del train
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    paper_out = phase_paper(dev, bwd_checked)
    torch.cuda.empty_cache()
    ckpt_launches = phase_checkpoint(dev, paper_out, bwd_checked)
    paper_launches = paper_out["launches"]
    del paper_out
    torch.cuda.empty_cache()
    tg_launches = phase_telemetry_gns(dev, bwd_checked, train_tokens_s)
    torch.cuda.empty_cache()
    recovery_launches = phase_recovery(dev, bwd_checked, clean)
    del clean
    torch.cuda.empty_cache()
    dist_launches = phase_distributed(dev, train_tokens_s, main_lengths,
                                      PROMPT_LEN + GEN)["launches"]
    # every trainer of the four phases is gone, its state off the card
    left = torch.cuda.memory_allocated() - held
    check(left < 2**26, f"phases paper, checkpoint, telemetry_gns, "
          f"recovery and distributed left {left} bytes allocated on the "
          f"card")
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
    rwkv_serve = phase_engine_rwkv(dev, wkv_fwd_checked, wkv_bwd_checked,
                                   _remat_shape(rwkv_train_shapes))
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
                                     pd_checked, ssd_bwd_checked,
                                     _remat_shape(zamba_train_shapes))
    torch.cuda.empty_cache()
    zamba_train = phase_train_zamba(dev, ssd_fwd_checked, ssd_bwd_checked)
    torch.cuda.empty_cache()

    moe_prefills = {(1, prefill_split(len(r.tokens), ladder))
                    for r in make_requests(get_arch("deepseek-moe-16b"), 16,
                                           PROMPT_LEN, GEN, seed=SEED)}
    moe_train_shapes = {(p.batch_size, p.seq_len) for p in
                        predict_trajectory(moe_train_config(), MOE_STEPS)}
    _, (d128_fa, d128_fd) = phase_flash_d128(
        moe_prefills, moe_train_shapes | {(MOE_EVAL, S_TRAIN)},
        PROMPT_LEN + GEN, main_lengths)
    phase_flash_d80()
    moe_serve = phase_engine_moe(dev, d128_fa, d128_fd)
    torch.cuda.empty_cache()
    moe_train = phase_train_moe(dev, d128_fa)
    torch.cuda.empty_cache()

    xl_prefills = {(1, prefill_split(len(r.tokens), ladder))
                   for r in xl_requests()}
    xl_train_shapes = {(p.batch_size, p.seq_len) for p in predict_trajectory(
        xl_train_config(), XL_STEPS)} | {(XL_EVAL, S_TRAIN),
                                         (XL_REMAT_B, S_TRAIN)}
    _, (xl_fa, xl_fd) = phase_flash_xl(xl_train_shapes, xl_prefills,
                                       PROMPT_LEN + GEN)
    xl = phase_train_xl(dev, xl_fa)
    xl_serve = phase_serve_xl(dev, xl.pop("params"), xl_fa, xl_fd)
    torch.cuda.empty_cache()
    adamw = phase_fused_adamw(dev)

    src = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/"
    by_path = {"serve": serve_launches, "serve_paged": paged_launches,
               "router": router_launches, "train": train_launches,
               "paper": paper_launches, "checkpoint": ckpt_launches,
               "telemetry_gns": tg_launches, "recovery": recovery_launches,
               "grads_bf16": bf16_launches, "distributed": dist_launches,
               **rwkv_serve, "train_rwkv": rwkv_train, **zamba_serve,
               "train_zamba": zamba_train, **moe_serve,
               "train_moe": moe_train, **xl["launches"], **xl_serve}
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
    counts = {path: c["fused_adamw"] for path, c in by_path.items()
              if c.get("fused_adamw")}
    for name, t in adamw.items():
        entries.append({"name": "fused_adamw", "route": "cuda",
                        "source": src + "fused_adamw.cu", "replaces": None,
                        "launches": sum(counts.values()),
                        "launches_by_path": counts, "model": name, **t})
    emit("done", seconds=time.perf_counter() - START)
    print(json.dumps({"kernels": entries}), flush=True)
    print(dev["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
