"""Roofline terms of a step on the H100 (``repro/roofline/analysis.py``).

    compute term    = FLOPs per device / the card's peak FLOP/s
    memory term     = HBM bytes per device / the card's HBM rate
    collective term = collective wire bytes per device / NVLink's rate

The reference reads per-device FLOPs and bytes from XLA's cost analysis
and parses collectives from compiled HLO.  The port has no HLO: FLOPs and
bytes come from ``roofline.op_cost`` (each rank's local ops, counted per
device), and :func:`record_collectives` records the c10d functional
collectives a step issues: kind, result bytes and group size, the same
fields ``parse_collectives`` returned.  ``model_flops`` and its helpers
are copied unchanged (``analysis.py:205-261``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed.compat import DTensor, group_size
from repro_torch.roofline import hw

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# c10d functional op name fragment -> the reference's collective kind
_KINDS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("broadcast", "broadcast"), ("permute", "collective-permute"))


def _collective_kind(name: str) -> Optional[str]:
    if "c10d" not in name:
        return None
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return None


def _nbytes(x) -> int:
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return x.numel() * x.element_size() if hasattr(x, "numel") else 0


class _CollectiveMode(TorchDispatchMode):
    """Records each c10d functional collective dispatched below DTensor
    (DTensor ops pass through so their redistributions desugar first,
    as ``CommDebugMode`` does)."""

    def __init__(self, out: List[Dict]):
        super().__init__()
        self.out = out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        result = func(*args, **kwargs)
        kind = _collective_kind(str(func))
        if kind is not None:
            names = [a for a in list(args) + list(kwargs.values())
                     if isinstance(a, str)]
            group = group_size(names[-1]) if names else 1
            self.out.append({"kind": kind, "result_bytes": _nbytes(result),
                             "group": group})
        return result


@contextlib.contextmanager
def record_collectives():
    """Yields a list that fills with ``{"kind", "result_bytes", "group"}``
    for every collective issued inside (per device: each rank issues its
    own)."""
    out: List[Dict] = []
    with _CollectiveMode(out):
        yield out


def wire_bytes_by_kind(collectives: List[Dict]) -> Dict[str, float]:
    """Per-device wire bytes by kind (``hw.wire_bytes`` of each)."""
    by_kind: Dict[str, float] = {}
    for c in collectives:
        w = hw.wire_bytes(c["kind"], c["result_bytes"], c["group"])
        by_kind[c["kind"]] = by_kind.get(c["kind"], 0.0) + w
    return by_kind


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    kind: str  # train | prefill | decode
    chips: int
    flops: float                  # per device
    bytes: float                  # per device
    collective_wire_bytes: float  # per device
    model_flops_global: float
    dtype: str = "fp32"           # the step's compute type: fp32 | tf32 | bf16
    collectives: Dict[str, float] = field(default_factory=dict)
    per_device_memory_bytes: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops / hw.peak_flops(self.dtype)

    @property
    def t_memory(self) -> float:
        return self.bytes / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_wire_bytes / hw.NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        """Perfect-overlap model: the largest of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """Model FLOPs / all devices' counted FLOPs (remat and masked
        work, e.g. the full square of a causal plain attention)."""
        total = self.flops * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def mfu_upper_bound(self) -> float:
        """Model FLOPs / (chips x peak x the step-time lower bound)."""
        t = self.step_time_lower_bound
        if not t:
            return 0.0
        return self.model_flops_global / (
            self.chips * hw.peak_flops(self.dtype) * t)

    def summary(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "kind": self.kind, "chips": self.chips, "dtype": self.dtype,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_upper_bound": self.mfu_upper_bound,
            "collectives": self.collectives,
            "per_device_memory_bytes": self.per_device_memory_bytes,
        }


def build_report(record: Dict) -> RooflineReport:
    """From a dry-run record (``launch/dryrun.py``): its per-device FLOPs
    and bytes, its collectives and its memory peak."""
    by_kind = wire_bytes_by_kind(record.get("collectives", []))
    return RooflineReport(
        arch=record["arch"], shape=record["shape"], mesh=record["mesh"],
        kind=record["kind"], chips=record["chips"],
        flops=record["cost"]["flops"], bytes=record["cost"]["bytes"],
        collective_wire_bytes=sum(by_kind.values()),
        model_flops_global=record["model_flops"],
        dtype=record.get("dtype", "fp32"), collectives=by_kind,
        per_device_memory_bytes=record.get("memory", {}).get("peak_bytes"))


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS (the "useful work" numerator)
# ---------------------------------------------------------------------------

def model_flops(cfg, kind: str, batch: int, seq_len: int,
                active_params: int) -> float:
    """6*N*D for train, 2*N*D for prefill, 2*N*B for one decode step —
    plus the causal attention term where applicable."""
    if kind == "train":
        tokens = batch * seq_len
        base = 6.0 * active_params * tokens
        attn = 3.0 * _attn_fwd_flops(cfg, batch, seq_len)
    elif kind == "prefill":
        tokens = batch * seq_len
        base = 2.0 * active_params * tokens
        attn = _attn_fwd_flops(cfg, batch, seq_len)
    else:  # decode: one token against a seq_len cache
        base = 2.0 * active_params * batch
        attn = _attn_decode_flops(cfg, batch, seq_len)
    return base + attn


def _attn_layers(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every  # shared-block applications
    if cfg.family == "rwkv":
        return 0
    return cfg.n_layers


def _attn_fwd_flops(cfg, batch: int, seq_len: int) -> float:
    n_attn = _attn_layers(cfg)
    hd = cfg.resolved_head_dim
    # causal: S^2/2 effective; QK^T + PV, 2 flops/MAC
    per_layer = 2.0 * 2.0 * batch * seq_len * seq_len / 2.0 * cfg.n_heads * hd
    flops = n_attn * per_layer
    if cfg.family == "rwkv":
        # linear recurrence: ~ 3 state updates of D x D per head per token
        d = cfg.rwkv_head_dim
        h = cfg.d_model // d
        flops = cfg.n_layers * 6.0 * batch * seq_len * h * d * d
    if cfg.family == "hybrid":
        dh, nh, p, n = (cfg.ssm_expand * cfg.d_model,
                        cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
                        cfg.ssm_head_dim, cfg.ssm_state)
        flops += cfg.n_layers * 6.0 * batch * seq_len * nh * p * n
    return flops


def _attn_decode_flops(cfg, batch: int, seq_len: int) -> float:
    n_attn = _attn_layers(cfg)
    hd = cfg.resolved_head_dim
    flops = n_attn * 2.0 * 2.0 * batch * seq_len * cfg.n_heads * hd
    if cfg.family == "rwkv":
        d = cfg.rwkv_head_dim
        h = cfg.d_model // d
        flops = cfg.n_layers * 6.0 * batch * h * d * d
    if cfg.family == "hybrid":
        nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        flops += cfg.n_layers * 6.0 * batch * nh * cfg.ssm_head_dim * cfg.ssm_state
    return flops
