"""What a run refuses to report under: JAX or the JAX package loaded in the
process (compared by whole top-level names, since the port's name begins
with the JAX package's), and fewer CUDA devices than the cell asks for."""
from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden(module_names: Iterable[str]) -> List[str]:
    """The loaded modules whose top-level name is a forbidden one."""
    return sorted(n for n in module_names if n.split(".")[0] in FORBIDDEN)


def devices_missing(chips: int) -> str:
    """Why the run cannot measure, or "" when it can."""
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} CUDA devices and "
                f"{torch.cuda.device_count()} are visible")
    return ""
