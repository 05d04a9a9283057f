#!/usr/bin/env python3
"""The NaN-propagating max of the flash-attention forward and flash-decode
kernels, against the same sources with ``fmaxf`` (the kernels before it),
on a card.

    python3 flash_nan_ab.py

Builds ``src/repro_torch/kernels/csrc/flash_attention_fwd.cu`` and
``flash_decode.cu`` as committed and copies with every ``max_nan(`` call
turned back into ``fmaxf(`` (``max_nan`` itself lives in
``csrc/sm90_mma.cuh``) into ``build/flash_nan_ab/``.  For each kernel:
the planted NaNs of ``chip_smoke.check_nan_propagation`` /
``check_decode_nan_propagation`` (the ``fmaxf`` copies are expected to
leave a finite lse, or a finite m, where the plain version's is NaN); the
outputs on finite inputs against the other build's, bit for bit (the two
maxima agree on any two numbers); and the device time of one call
(``chip_smoke.device_ms``) in turns ``fmaxf``, ``max_nan``, ``max_nan``,
``fmaxf``: the forward at B = 1, S = 512 and B = 16, S = 1024 in fp32 and
at B = 16, S = 1024 in bf16 (H = 12, D = 64); decode, dense and paged, on
gpt2's fused step (8 slots of 576, H = 12, D = 64) and dense on
deepseek-moe-16b's (16 heads of 128).  Prints one JSON line per shape
and, last, the card's name and power limit.  Needs a CUDA card and nvcc.
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
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402
from repro_torch.kernels.flash_decode import kernel as FD  # noqa: E402

OUT = ROOT / "build" / "flash_nan_ab"
FWD_SHAPES = ((1, 512, torch.float32), (16, 1024, torch.float32),
              (16, 1024, torch.bfloat16))
# source -> the number of max_nan calls this script turns back into fmaxf
CALLS = {"flash_attention_fwd": 5, "flash_decode": 4}


def build() -> dict:
    """{(source, "max_nan" | "fmaxf"): ctypes.CDLL} of the four builds."""
    procs = {}
    OUT.mkdir(parents=True, exist_ok=True)
    for source, want in CALLS.items():
        src = (_build.CSRC / f"{source}.cu").read_text()
        calls = src.count("max_nan(")
        cs.check(calls == want, f"csrc/{source}.cu has {calls} max_nan "
                 f"calls, not the {want} this script turns back into fmaxf")
        for name, text in (("max_nan", src),
                           ("fmaxf", src.replace("max_nan(", "fmaxf("))):
            path = OUT / f"{source}_{name}.cu"
            path.write_text(text)
            procs[source, name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                 "-o", str(path.with_suffix(".so")), str(path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (source, name), proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc {source} {name}: {log[-2000:]}")
        libs[source, name] = ctypes.CDLL(str(OUT / f"{source}_{name}.so"))
    return libs


def _fwd_entry(lib):
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lambda: fn


def _decode_entry(lib):
    fn = lib.flash_decode_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    paged = lib.flash_decode_paged_fwd
    paged.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                      + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_void_p])
    paged.restype = ctypes.c_int
    return lambda: (fn, paged)


def _ab(calls: dict, use, what: str) -> dict:
    """Bits of the two builds' outputs, then their times in turns."""
    outs = {}
    for name, fn in calls.items():
        use(name)
        outs[name] = fn()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(outs["max_nan"],
                                                 outs["fmaxf"]))
    cs.check(same, f"{what}: the two builds differ")
    ms = {name: [] for name in calls}
    for name in ("fmaxf", "max_nan", "max_nan", "fmaxf"):
        use(name)
        ms[name].append(cs.device_ms(calls[name]))
    return {"bits_equal": same, "ms": ms}


def _nan_checks(check, use) -> dict:
    got = {}
    for name in ("max_nan", "fmaxf"):
        use(name)
        try:
            check()
            got[name] = "passed"
        except RuntimeError as e:
            got[name] = str(e)
    cs.check(got["max_nan"] == "passed", f"max_nan: {got['max_nan']}")
    cs.check(got["fmaxf"] != "passed", "the fmaxf build passed the NaN "
             "check: it cannot tell the two apart")
    return got


def main() -> int:
    dev = cs.phase_device()
    libs = build()
    fwd_entry, decode_lib = FA._entry, FD._lib
    entries = {("fwd", n): _fwd_entry(libs["flash_attention_fwd", n])
               for n in ("max_nan", "fmaxf")}
    entries.update({("decode", n): _decode_entry(libs["flash_decode", n])
                    for n in ("max_nan", "fmaxf")})

    def use_fwd(name):
        FA._entry = entries["fwd", name]

    def use_decode(name):
        FD._lib = entries["decode", name]

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import make_requests
    cache_len = cs.PROMPT_LEN + cs.GEN
    main_lengths = [len(r.tokens) + r.max_tokens // 2 for r in make_requests(
        get_arch("gpt2-117m"), 8, cs.PROMPT_LEN, cs.GEN, seed=cs.SEED)]
    try:
        print(json.dumps({"nan_propagation": {
            "flash_attention_fwd": _nan_checks(cs.check_nan_propagation,
                                               use_fwd),
            "flash_decode": _nan_checks(
                lambda: cs.check_decode_nan_propagation(main_lengths,
                                                        cache_len),
                use_decode)}}), flush=True)
        for b, s, dtype in FWD_SHAPES:
            q, k, v = cs._attn_inputs(b, s, dtype, 5)
            fn = lambda: FA.flash_attention_fwd(q, k, v)  # noqa: E731
            print(json.dumps({
                "kernel": "flash_attention_fwd",
                "shape": f"B={b} S={s} H={cs.H} D={cs.D}",
                "dtype": str(dtype)[6:],
                **_ab({"max_nan": fn, "fmaxf": fn}, use_fwd, f"{b}x{s}")}),
                flush=True)
        q, kc, vc, lengths = cs._decode_inputs(8, cache_len, 1, torch.float32,
                                               main_lengths, 4)
        fn = lambda: FD.flash_decode_fwd(q, kc, vc, lengths)  # noqa: E731
        print(json.dumps({"kernel": "flash_decode_fwd",
                          "shape": "gpt2 main, 8 slots of 576, H=12 D=64",
                          **_ab({"max_nan": fn, "fmaxf": fn}, use_decode,
                                "decode gpt2 main")}), flush=True)
        pl, free = cs.paged_main_lengths(main_lengths)
        pq, pk, pv, table, plen = cs._paged_inputs(
            pl, cs.PAGE_SIZE, -(-cache_len // cs.PAGE_SIZE), cs.N_PAGES, 1,
            torch.float32, 6, holes=[(i, 0) for i in free])
        fn = lambda: FD.flash_decode_paged_fwd(  # noqa: E731
            pq, pk, pv, table, plen)
        print(json.dumps({"kernel": "flash_decode_paged_fwd",
                          "shape": "gpt2 paged main, 48 pages of 64",
                          **_ab({"max_nan": fn, "fmaxf": fn}, use_decode,
                                "decode paged main")}), flush=True)
        q, kc, vc, lengths = cs._decode_inputs(8, cache_len, 1, torch.float32,
                                               main_lengths, 7, 16, 128)
        fn = lambda: FD.flash_decode_fwd(q, kc, vc, lengths)  # noqa: E731
        print(json.dumps({"kernel": "flash_decode_fwd",
                          "shape": "deepseek main, 8 slots of 576, H=16 "
                                   "D=128",
                          **_ab({"max_nan": fn, "fmaxf": fn}, use_decode,
                                "decode deepseek main")}), flush=True)
    finally:
        FA._entry, FD._lib = fwd_entry, decode_lib
    print(dev["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
