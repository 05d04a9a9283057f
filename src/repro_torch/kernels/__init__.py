"""Hand-written CUDA kernels for the serving path, with their plain versions.

Counterpart of ``repro/kernels/__init__.py:31-70``, rewritten for devices.
Each subpackage has ``kernel.py`` (the ctypes wrapper of a CUDA kernel in
``csrc/``, its plain PyTorch version beside it and a ``launches`` count)
and ``ops.py`` (the model-layout wrapper).

* ``flash_attention`` — causal prefill attention (``csrc/flash_attention_fwd.cu``).
* ``flash_decode`` — split-KV single-token decode (``csrc/flash_decode.cu``).

The backend rule.  ``attn_backend`` is "blockwise" or "flash";
``decode_backend`` is "reference" or "kernel".  "blockwise" and
"reference" always run plain PyTorch.  "flash" and "kernel" go by the
tensor's device: on a CUDA tensor the wrapper launches the CUDA kernel or
raises; on a CPU tensor (which arises only where the caller asked for
the CPU) it runs the kernel's plain version.  There is no ``try`` that
falls back.
"""
from __future__ import annotations

import torch

ATTN_BACKENDS = ("blockwise", "flash")
DECODE_BACKENDS = ("reference", "kernel")


def wants_kernel(backend: str, field: str, allowed) -> bool:
    """Validate a config backend value; True for the kernel value.

    ``allowed`` is (plain value, kernel value).  The reference's
    ``*_interpret`` values select Pallas interpret mode, which has no
    meaning here: on the CPU the port runs the kernel's plain version.
    """
    if backend.endswith("_interpret"):
        raise ValueError(
            f"{field}={backend!r}: interpret mode is a Pallas notion; the "
            f"port runs {allowed[1]!r} as the CUDA kernel on CUDA tensors "
            f"and as its plain version on CPU tensors")
    if backend not in allowed:
        raise ValueError(f"unknown {field} {backend!r}; want one of {allowed}")
    return backend == allowed[1]


def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def resolve_device(device) -> torch.device:
    """An entry point's device: CUDA unless the caller names the CPU.  A CUDA
    device on a machine without one raises, never carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is false; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
