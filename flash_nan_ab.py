#!/usr/bin/env python3
"""The flash-attention forward kernel's NaN-propagating max, against the
same source with ``fmaxf`` (the kernel before it), on a card.

    python3 flash_nan_ab.py

Builds ``src/repro_torch/kernels/csrc/flash_attention_fwd.cu`` as committed
and a copy with every ``max_nan(`` call turned back into ``fmaxf(`` into
``build/flash_nan_ab/``.  For each: o and lse on finite inputs against the
other's, bit for bit (the two maxima agree on any two numbers); the
planted NaNs of ``chip_smoke.check_nan_propagation`` (the ``fmaxf`` copy is
expected to leave a finite lse where the plain version's is NaN); and the
device time of one call (``chip_smoke.device_ms``) in turns ``fmaxf``,
``max_nan``, ``max_nan``, ``fmaxf`` at B = 1, S = 512 and B = 16, S = 1024
in fp32 and at B = 16, S = 1024 in bf16 (H = 12, D = 64).  Prints one JSON
line per shape and, last, the card's name and power limit.  Needs a CUDA
card and nvcc.
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
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402

OUT = ROOT / "build" / "flash_nan_ab"
SHAPES = ((1, 512, torch.float32), (16, 1024, torch.float32),
          (16, 1024, torch.bfloat16))


def build() -> dict:
    """{"max_nan": fn, "fmaxf": fn}: the two builds' C entry points."""
    src = (_build.CSRC / "flash_attention_fwd.cu").read_text()
    calls = src.count("max_nan(") - 1  # one is the definition
    cs.check(calls == 5, f"csrc/flash_attention_fwd.cu has {calls} max_nan "
             f"calls, not the 5 this script turns back into fmaxf")
    head, _, body = src.partition("float max_nan(float a, float b) {")
    OUT.mkdir(parents=True, exist_ok=True)
    texts = {"max_nan": src, "fmaxf": head + "float max_nan(float a, float b) {"
             + body.replace("max_nan(", "fmaxf(")}
    procs = {}
    for name, text in texts.items():
        path = OUT / f"{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc {name}: {log[-2000:]}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    dev = cs.phase_device()
    fns = build()
    entry = K._entry

    def use(name):
        K._entry = lambda: fns[name]

    try:
        nan = {}
        for name in fns:
            use(name)
            try:
                cs.check_nan_propagation()
                nan[name] = "passed"
            except RuntimeError as e:
                nan[name] = str(e)
        cs.check(nan["max_nan"] == "passed", f"max_nan: {nan['max_nan']}")
        print(json.dumps({"nan_propagation": nan}), flush=True)
        for b, s, dtype in SHAPES:
            q, k, v = cs._attn_inputs(b, s, dtype, 5)
            outs = {}
            for name in fns:
                use(name)
                outs[name] = K.flash_attention_fwd(q, k, v)
            same = all(torch.equal(x, y) for x, y in zip(outs["max_nan"],
                                                         outs["fmaxf"]))
            cs.check(same, f"{b}x{s} {dtype}: the two builds differ")
            ms = {name: [] for name in fns}
            for name in ("fmaxf", "max_nan", "max_nan", "fmaxf"):
                use(name)
                ms[name].append(cs.device_ms(
                    lambda: K.flash_attention_fwd(q, k, v)))
            print(json.dumps({"shape": f"B={b} S={s} H={cs.H} D={cs.D}",
                              "dtype": str(dtype)[6:], "bits_equal": same,
                              "ms": ms}), flush=True)
    finally:
        K._entry = entry
    print(dev["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
