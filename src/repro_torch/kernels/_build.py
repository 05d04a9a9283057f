"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and includes no PyTorch
header, so it compiles in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

The libraries go to ``build/repro_torch_kernels/`` at the repo root (git
ignores ``build/``), named by a hash of their source and of every
``csrc/*.cuh`` header it includes, so an edited source or header is rebuilt
and an unchanged one is not.  All sources build at once, one
nvcc process each, started together; the first kernel call in a process
triggers the build.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuiltLibrary:
    """One compiled source: its library path, build seconds (0 when the
    library was already built) and what ``-Xptxas -v`` reported."""

    name: str
    path: Path
    seconds: float
    ptxas: str


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.MULTILINE)


def _headers(src: Path) -> list:
    """The ``csrc/*.cuh`` headers ``src`` includes, directly or through
    another header, in a fixed order."""
    seen, todo = [], [src]
    while todo:
        for name in INCLUDE.findall(todo.pop().read_bytes()):
            header = CSRC / name.decode()
            if header not in seen:
                seen.append(header)
                todo.append(header)
    return sorted(seen)


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in _headers(src):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


@functools.cache
def build_all() -> Dict[str, BuiltLibrary]:
    """Compile every ``csrc/*.cu`` that has no library yet, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs, out = {}, {}
    t0 = time.perf_counter()
    for src in sorted(CSRC.glob("*.cu")):
        target = _target(src)
        if target.exists():
            out[src.stem] = BuiltLibrary(src.stem, target, 0.0, "")
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[src.stem] = (target, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (target, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, target)  # atomic: a concurrent build sees all or none
        out[name] = BuiltLibrary(name, target, time.perf_counter() - t0, log)
    return out


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    libs = build_all()
    if name not in libs:
        raise KeyError(f"no CUDA source csrc/{name}.cu")
    return ctypes.CDLL(str(libs[name].path))


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
