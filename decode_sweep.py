#!/usr/bin/env python3
"""Cluster size and key tile of the flash-decode kernels, timed on a card.

    python3 decode_sweep.py

Builds ``src/repro_torch/kernels/csrc/flash_decode.cu`` as committed and in
copies with the cluster size pinned to 1, 2, 4 or 8 blocks (in place of the
launch's choice from occupancy) or with 64-key tiles (in place of 32), into
``build/decode_sweep/``, and times each at ``chip_smoke.py``'s decode shapes
(the gpt2 and zamba2 fused steps, dense and paged, the 8 x 1024 cache in
fp32 and bf16, a one-slot replay) and with every slot empty, beside an
empty PyTorch kernel: CUDA-event time of one call among back-to-back calls
queued behind a spin kernel (``chip_smoke.device_ms``).  Each variant is
first held against the plain version (``chip_smoke.check_partials``).
Prints one JSON line per shape and, last, the card's name and power limit.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_decode import kernel as K  # noqa: E402

OUT = ROOT / "build" / "decode_sweep"
CHOICE = """  int c = MAX_CLUSTER;
  while (c > 1 && (ceil_div(a.s, c) < TILE || (int64_t)b * a.kvh * c > room))
    c /= 2;"""
TILE = "constexpr int TILE = 32;"


def variants() -> dict:
    src = (_build.CSRC / "flash_decode.cu").read_text()
    if CHOICE not in src or TILE not in src:
        raise RuntimeError("csrc/flash_decode.cu no longer has the cluster "
                           "choice or the tile this script replaces")
    out = {"committed": src,
           "tile64": src.replace(TILE, "constexpr int TILE = 64;")}
    for c in (1, 2, 4, 8):
        out[f"cluster{c}"] = src.replace(CHOICE, f"  const int c = {c};")
    return out


def build(srcs: dict) -> dict:
    """{name: (dense, paged) ctypes functions}, built in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        path = OUT / f"{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc {name}: {log[-2000:]}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        dense, paged = lib.flash_decode_fwd, lib.flash_decode_paged_fwd
        dense.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                          + [ctypes.c_int64] * 6
                          + [ctypes.c_int, ctypes.c_void_p])
        paged.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                          + [ctypes.c_int64] * 6
                          + [ctypes.c_int, ctypes.c_void_p])
        libs[name] = (dense, paged)
    return libs


def bound_call(fns, args):
    """(call, outputs) of one variant on one shape's inputs."""
    dense, paged = fns
    q = args[0]
    o, m, l = K._outputs(q)
    b, kvh, g, d = q.shape
    ptrs = [t.data_ptr() for t in args] + [o.data_ptr(), m.data_ptr(),
                                           l.data_ptr()]
    k = args[1]
    strides = [*k.stride()[:3], *args[2].stride()[:3]]
    stream = torch.cuda.current_stream().cuda_stream
    code = K.DTYPE_CODES[q.dtype]
    if len(args) == 4:
        dims = [b, k.shape[1], kvh, g, d]
        fn = dense
    else:
        dims = [b, args[3].shape[1], k.shape[1], kvh, g, d]
        fn = paged
    call = lambda: cs.check(fn(*ptrs, *dims, *strides, code, stream) == 0,
                            "launch")
    return call, (o, m, l)


def main() -> int:
    dev = cs.phase_device()
    libs = build(variants())
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_decode import (
        flash_decode_fwd_plain, flash_decode_paged_fwd_plain)
    from repro_torch.launch.serve import make_requests
    main_lengths = [len(r.tokens) + r.max_tokens // 2 for r in make_requests(
        get_arch("gpt2-117m"), 8, cs.PROMPT_LEN, cs.GEN, seed=cs.SEED)]
    s = cs.PROMPT_LEN + cs.GEN
    plen, free = cs.paged_main_lengths(main_lengths)
    mp = -(-s // cs.PAGE_SIZE)
    holes = [(i, 0) for i in free]
    edge = [0, 1, 127, 128, 1000, 1024, 600, 5]
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = {
        "dense_f32_main": cs._decode_inputs(8, s, 1, f32, main_lengths, 4),
        "dense_f32_empty": cs._decode_inputs(8, s, 1, f32, [0] * 8, 4),
        "dense_f32_8x1024": cs._decode_inputs(8, 1024, 1, f32, edge, 3),
        "dense_bf16_8x1024": cs._decode_inputs(8, 1024, 1, bf16, edge, 3),
        "dense_f32_zamba": cs._decode_inputs(8, s, 1, f32, main_lengths, 5,
                                             cs.ZAMBA_H, cs.ZAMBA_D),
        "dense_f32_replay": cs._decode_inputs(1, s, 1, f32, [s - 149], 6),
        "paged_f32_main": cs._paged_inputs(plen, cs.PAGE_SIZE, mp,
                                           cs.N_PAGES, 1, f32, 7, holes),
        "paged_bf16_main": cs._paged_inputs(plen, cs.PAGE_SIZE, mp,
                                            cs.N_PAGES, 1, bf16, 7, holes),
        "paged_f32_zamba": cs._paged_inputs(plen, cs.PAGE_SIZE, mp,
                                            cs.N_PAGES, 1, f32, 8, holes,
                                            h=cs.ZAMBA_H, d=cs.ZAMBA_D),
    }
    x = torch.zeros(1, device="cuda")
    print(json.dumps({"empty_torch_kernel_ms": cs.device_ms(
        lambda: x.add_(1), iters=50)}), flush=True)
    for name, args in shapes.items():
        plain = (flash_decode_fwd_plain if len(args) == 4
                 else flash_decode_paged_fwd_plain)(*args)
        calls = {}
        for variant, fns in libs.items():
            call, outs = bound_call(fns, args)
            call()
            cs.check_partials(outs, plain, args[-1], f"{variant} {name}")
            calls[variant] = call
        # two passes in opposite orders; the faster of the two a variant
        ms = {v: [] for v in calls}
        for order in (list(calls), list(calls)[::-1]):
            for variant in order:
                ms[variant].append(cs.device_ms(calls[variant], iters=50))
        print(json.dumps({"shape": name, "ms": {v: min(t) for v, t in
                                                ms.items()}}), flush=True)
    print(dev["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
