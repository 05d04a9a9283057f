"""Composable training control plane: regulators -> one StepPlan per step
(copy of ``repro/core/regulators.py:57-531``).

Each schedule is a ``Regulator``: a host-side state machine that reads the
shared per-step :class:`StepTelemetry` and contributes to the
:class:`StepPlan` (sequence-length bucket, batch size, LR, grad-clip
scale) that the trainer executes.  ``seq_len`` and ``batch_size`` fold by
min; the LR schedule sets the LR and modifiers after it in the stack
(:class:`VarianceLRThrottle`) multiply it.  Every kind of the reference is
built: ``seqlen``, ``batch_warmup``, ``lr``, ``grad_noise_batch``,
``var_lr_throttle`` and ``critical_batch`` (``repro_torch.gns``).  Pure
Python and numpy.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import (BatchWarmupConfig, OptimizerConfig,
                                      RegulatorSpec, SLWConfig, TrainConfig)
from repro_torch.core.batch_warmup import BatchWarmup, quantize_batch
from repro_torch.core.curriculum import SLWCurriculum, apply_seqlen
from repro_torch.core.telemetry import blame
from repro_torch.optim.schedule import lr_at


@dataclass
class StepTelemetry:
    """What every regulator sees: the exact host counters and the last
    completed step's observations (NaN before the first step).
    ``grad_norm`` is the raw pre-clip global norm, ``grad_norm_clipped``
    the post-clip one.  The ``gns_*`` pair (NaN unless GNS is on and the
    step realized >= 2 shards) is the mean per-shard and the full-batch
    squared gradient norm and the sizes they were measured at.
    ``per_leaf`` (per-leaf telemetry or GNS on) holds the step's
    ``(n_leaves,)`` vectors in ``leaf_labels`` order."""

    step: int = 0
    tokens_seen: int = 0
    loss: float = float("nan")
    loss_ratio: float = float("nan")
    grad_norm: float = float("nan")
    grad_norm_clipped: float = float("nan")
    var_max: float = float("nan")
    var_l1: float = float("nan")
    gns_small_sq: float = float("nan")
    gns_big_sq: float = float("nan")
    gns_b_small: float = float("nan")
    gns_b_big: float = float("nan")
    per_leaf: Optional[Dict[str, np.ndarray]] = None
    leaf_labels: Tuple[str, ...] = ()


@dataclass
class StepPlan:
    """The control decision for one step, executed by the trainer."""

    seq_len: int
    batch_size: int
    lr: float
    grad_clip_scale: float = 1.0


@dataclass
class ControllerState:
    """Checkpointable state of the whole control plane."""

    step: int = 0
    tokens_seen: int = 0
    regulators: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    tracker: Dict[str, Any] = field(default_factory=dict)

    def to_host(self) -> Dict[str, Any]:
        return {"step": self.step, "tokens_seen": self.tokens_seen,
                "regulators": self.regulators, "tracker": self.tracker}

    @classmethod
    def from_host(cls, d: Dict[str, Any]) -> "ControllerState":
        return cls(step=int(d.get("step", 0)),
                   tokens_seen=int(d.get("tokens_seen", 0)),
                   regulators=dict(d.get("regulators", {})),
                   tracker=dict(d.get("tracker", {})))


class Regulator:
    """Base class; ``name`` keys the regulator's slice of
    :class:`ControllerState` and is unique within a stack."""

    name: str = "regulator"

    def plan(self, tele: StepTelemetry, plan: StepPlan) -> StepPlan:
        return plan

    def observe(self, tele: StepTelemetry, tokens_step: int) -> None:
        pass

    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        pass


class SeqLenRegulator(Regulator):
    """SLW curriculum (paper section 4): pacing + bucket ladder + the
    variance gate."""

    name = "seqlen"

    def __init__(self, cfg: SLWConfig, full_seq: int,
                 warmup_steps_hint: int = 0, prefix_tokens: int = 0):
        self.cfg = cfg
        self.curriculum = SLWCurriculum(cfg, full_seq,
                                        prefix_tokens=prefix_tokens,
                                        warmup_steps_hint=warmup_steps_hint)

    @property
    def mode(self) -> str:
        return self.cfg.mode

    def plan(self, tele: StepTelemetry, plan: StepPlan) -> StepPlan:
        plan.seq_len = min(plan.seq_len, self.curriculum.seqlen_for_step())
        return plan

    def observe(self, tele: StepTelemetry, tokens_step: int) -> None:
        if self.cfg.pacing == "variance_gated" and math.isfinite(tele.var_max):
            self.curriculum.observe(tele.var_max)
        self.curriculum.step_complete(tokens_step)

    def state_dict(self) -> Dict[str, Any]:
        return self.curriculum.state_dict()

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.curriculum.load_state_dict(d)


class BatchSizeRegulator(Regulator):
    """GPT-3-style linear batch warmup, quantized to the data-parallel
    size."""

    name = "batch_warmup"

    def __init__(self, cfg: BatchWarmupConfig, full_batch: int,
                 dp_size: int = 1):
        self.warmup = BatchWarmup(cfg, full_batch, dp_size=dp_size)

    def plan(self, tele: StepTelemetry, plan: StepPlan) -> StepPlan:
        plan.batch_size = min(plan.batch_size,
                              self.warmup.batch_for_tokens(tele.tokens_seen))
        return plan


class LRScheduleRegulator(Regulator):
    """Token-wise / step-wise / constant LR schedule; sets the LR."""

    name = "lr"

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg

    def plan(self, tele: StepTelemetry, plan: StepPlan) -> StepPlan:
        plan.lr = lr_at(self.cfg, tele.step, tele.tokens_seen)
        return plan


class GradNoiseBatchRegulator(Regulator):
    """Adaptive batch sizing from gradient-norm noise (beyond the paper,
    ``regulators.py:216``): EMAs of the raw pre-clip gradient norm and its
    square; while the relative std exceeds ``noise_target``, the batch
    grows by ``growth``.  Monotone, quantized to the data-parallel size,
    capped at the full batch.  The pre-clip norm matters: a post-clip one
    saturates at the clip limit and reads no noise."""

    name = "grad_noise_batch"

    def __init__(self, spec: RegulatorSpec, full_batch: int,
                 dp_size: int = 1):
        self.spec = spec
        self.full_batch = full_batch
        self.dp_size = max(dp_size, 1)
        self.batch = self._quantize(spec.min_batch or full_batch // 8)
        self.ema_g = 0.0
        self.ema_g2 = 0.0
        self.n_obs = 0

    def _quantize(self, b: float) -> int:
        return quantize_batch(b, self.dp_size, self.dp_size, self.full_batch)

    def plan(self, tele: StepTelemetry, plan: StepPlan) -> StepPlan:
        plan.batch_size = min(plan.batch_size, self.batch)
        return plan

    def observe(self, tele: StepTelemetry, tokens_step: int) -> None:
        g = tele.grad_norm
        if not math.isfinite(g):
            return
        if self.n_obs == 0:
            # seeded at the first observation: zero EMAs would read as a
            # huge relative variance
            self.ema_g, self.ema_g2 = g, g * g
        else:
            a = 2.0 / (self.spec.noise_window + 1.0)
            self.ema_g = (1 - a) * self.ema_g + a * g
            self.ema_g2 = (1 - a) * self.ema_g2 + a * g * g
        self.n_obs += 1
        if self.n_obs < self.spec.noise_window:
            return
        var = max(self.ema_g2 - self.ema_g ** 2, 0.0)
        rel_std = math.sqrt(var) / max(self.ema_g, 1e-12)
        if rel_std > self.spec.noise_target and self.batch < self.full_batch:
            self.batch = self._quantize(
                max(self.batch * self.spec.growth, self.batch + self.dp_size))

    def state_dict(self) -> Dict[str, Any]:
        return {"batch": self.batch, "ema_g": self.ema_g,
                "ema_g2": self.ema_g2, "n_obs": self.n_obs}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.batch = int(d["batch"])
        self.ema_g = float(d["ema_g"])
        self.ema_g2 = float(d["ema_g2"])
        self.n_obs = int(d["n_obs"])


class VarianceLRThrottle(Regulator):
    """Warmup-free LR control (beyond the paper): back the LR off
    multiplicatively while the Adam variance max spikes above ``gate`` x
    its trailing mean (the paper's §3 spike precursor) and recover when
    calm; the grad clip tightens by the same factor while throttled.

    With per-leaf telemetry the gate runs per parameter group
    (``_observe_per_leaf``, ``regulators.py:320``) on ``var_max`` and the
    raw ``grad_norm``, each against its per-leaf trailing mean, and
    ``blamed`` names the group of the largest excursion seen.  Without it,
    the scalar gate: ``var_max > gate x trailing`` backs off (``scale *=
    backoff``, never below ``floor``), a calm step recovers (``scale *=
    recovery``, capped at 1), and ``trailing = 0.9 trailing + 0.1
    var_max``."""

    name = "var_lr_throttle"
    GATE_KEYS = ("var_max", "grad_norm")

    def __init__(self, spec: RegulatorSpec):
        self.spec = spec
        self.scale = 1.0
        self.trailing = 0.0
        self.leaf_trailing: Dict[str, np.ndarray] = {}
        self.blamed = ""
        self.blamed_ratio = 0.0

    def plan(self, tele: StepTelemetry, plan: StepPlan) -> StepPlan:
        plan.lr *= self.scale
        plan.grad_clip_scale *= self.scale
        return plan

    def _observe_per_leaf(self, tele: StepTelemetry) -> Optional[bool]:
        """Whether any leaf excursed (recording the blame), or None when
        per-leaf telemetry is absent or unusable."""
        if tele.per_leaf is None:
            return None
        usable = spiking = False
        for key in self.GATE_KEYS:
            v = tele.per_leaf.get(key)
            if v is None:
                continue
            v = np.asarray(v, np.float64)
            if not np.all(np.isfinite(v)):
                continue
            usable = True
            trail = self.leaf_trailing.get(key)
            if trail is None or trail.shape != v.shape:
                self.leaf_trailing[key] = v.copy()
                continue
            ratios = v / np.maximum(trail, 1e-30)
            if bool(np.any(ratios > self.spec.gate)):
                spiking = True
                # the largest excursion keeps the blame: the layer that
                # started a divergence spikes harder than what follows
                if float(np.max(ratios)) > self.blamed_ratio:
                    worst = blame(tele.leaf_labels, ratios)
                    if worst:
                        self.blamed = worst
                        self.blamed_ratio = float(np.max(ratios))
            self.leaf_trailing[key] = 0.9 * trail + 0.1 * v
        return spiking if usable else None

    def observe(self, tele: StepTelemetry, tokens_step: int) -> None:
        spiking = self._observe_per_leaf(tele)
        v = tele.var_max
        if spiking is None:
            if not math.isfinite(v):
                return
            if self.trailing == 0.0:
                self.trailing = v
            spiking = v > self.spec.gate * self.trailing
            self.trailing = 0.9 * self.trailing + 0.1 * v
        if spiking:
            self.scale = max(self.scale * self.spec.backoff, self.spec.floor)
        else:
            self.scale = min(self.scale * self.spec.recovery, 1.0)

    def state_dict(self) -> Dict[str, Any]:
        return {"scale": self.scale, "trailing": self.trailing,
                "leaf_trailing": {k: v.tolist()
                                  for k, v in self.leaf_trailing.items()},
                "blamed": self.blamed, "blamed_ratio": self.blamed_ratio}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.scale = float(d["scale"])
        self.trailing = float(d["trailing"])
        lt = d.get("leaf_trailing")
        self.leaf_trailing = ({k: np.asarray(v, np.float64)
                               for k, v in lt.items()}
                              if isinstance(lt, dict) else {})
        self.blamed = str(d.get("blamed", ""))
        self.blamed_ratio = float(d.get("blamed_ratio", 0.0))


class RegulatorStack:
    """Ordered regulators: ``plan`` before the step, ``apply`` the plan to
    the host batch, ``observe`` after."""

    def __init__(self, regulators: Sequence[Regulator], full_seq: int,
                 full_batch: int, base_lr: float):
        names = [r.name for r in regulators]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate regulator names: {names}")
        self.regulators = list(regulators)
        self.full_seq = full_seq
        self.full_batch = full_batch
        self.base_lr = base_lr

    def __getitem__(self, name: str) -> Regulator:
        for r in self.regulators:
            if r.name == name:
                return r
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(r.name == name for r in self.regulators)

    @property
    def seq_mode(self) -> str:
        return self["seqlen"].mode if "seqlen" in self else "truncate"

    def plan(self, tele: StepTelemetry) -> StepPlan:
        p = StepPlan(seq_len=self.full_seq, batch_size=self.full_batch,
                     lr=self.base_lr)
        for r in self.regulators:
            p = r.plan(tele, p)
        return p

    def apply(self, batch: Dict[str, np.ndarray], plan: StepPlan
              ) -> Tuple[Dict[str, np.ndarray], int]:
        """Row-slice to the batch size, then truncate/repack to the bucket.
        Returns (batch, tokens)."""
        first = next(iter(batch.values()))
        if plan.batch_size < first.shape[0]:
            batch = {k: v[:plan.batch_size] for k, v in batch.items()}
        return apply_seqlen(batch, plan.seq_len, self.seq_mode)

    def observe(self, tele: StepTelemetry, tokens_step: int) -> None:
        for r in self.regulators:
            r.observe(tele, tokens_step)

    def controller_state(self, step: int, tokens_seen: int,
                         tracker_state: Dict[str, Any] = None
                         ) -> ControllerState:
        return ControllerState(
            step=step, tokens_seen=tokens_seen,
            regulators={r.name: r.state_dict() for r in self.regulators},
            tracker=tracker_state or {})

    def load_controller_state(self, cs: ControllerState) -> None:
        for r in self.regulators:
            if r.name in cs.regulators:
                r.load_state_dict(cs.regulators[r.name])


def auto_specs(tc: TrainConfig) -> Tuple[RegulatorSpec, ...]:
    """The enabled legacy schedules compose; the LR schedule always runs."""
    specs: List[RegulatorSpec] = []
    if tc.slw.enabled:
        specs.append(RegulatorSpec(kind="seqlen"))
    if tc.batch_warmup.enabled:
        specs.append(RegulatorSpec(kind="batch_warmup"))
    specs.append(RegulatorSpec(kind="lr"))
    return tuple(specs)


def build_stack(tc: TrainConfig, *, dp_size: int = 1,
                warmup_steps_hint: int = 0,
                prefix_tokens: int = 0) -> RegulatorStack:
    """The control plane of a TrainConfig: ``tc.regulators``, or
    :func:`auto_specs` when it is empty.  ``prefix_tokens`` (a vision
    patch prefix) is left out of the SLW pacing."""
    regs: List[Regulator] = []
    for spec in tc.regulators or auto_specs(tc):
        if spec.kind == "seqlen":
            regs.append(SeqLenRegulator(tc.slw, tc.seq_len,
                                        warmup_steps_hint=warmup_steps_hint,
                                        prefix_tokens=prefix_tokens))
        elif spec.kind == "batch_warmup":
            regs.append(BatchSizeRegulator(tc.batch_warmup, tc.global_batch,
                                           dp_size=dp_size))
        elif spec.kind == "lr":
            regs.append(LRScheduleRegulator(tc.optimizer))
        elif spec.kind == "grad_noise_batch":
            regs.append(GradNoiseBatchRegulator(spec, tc.global_batch,
                                                dp_size=dp_size))
        elif spec.kind == "var_lr_throttle":
            regs.append(VarianceLRThrottle(spec))
        elif spec.kind == "critical_batch":
            # deferred: repro_torch.gns builds on this module's protocol
            from repro_torch.gns.regulator import CriticalBatchRegulator
            regs.append(CriticalBatchRegulator(tc.gns, tc.global_batch,
                                               dp_size=dp_size))
        else:
            raise ValueError(f"unknown regulator kind {spec.kind!r}")
    return RegulatorStack(regs, full_seq=tc.seq_len,
                          full_batch=tc.global_batch, base_lr=tc.optimizer.lr)


def predict_trajectory(tc: TrainConfig, n_steps: int, *, dp_size: int = 1,
                       warmup_steps_hint: int = 0, prefix_tokens: int = 0
                       ) -> List[StepPlan]:
    """The stack's open-loop trajectory without training: the exact
    (seq_len, batch, lr) sequence the trainer executes, with calm synthetic
    telemetry (unit var_max / grad_norm) for the variance gate.  Token
    accounting mirrors the trainer's."""
    stack = build_stack(tc, dp_size=dp_size,
                        warmup_steps_hint=warmup_steps_hint,
                        prefix_tokens=prefix_tokens)
    plans: List[StepPlan] = []
    tokens = 0
    for step in range(n_steps):
        tele = StepTelemetry(step=step, tokens_seen=tokens,
                             var_max=1.0, var_l1=1.0, grad_norm=1.0)
        plan = stack.plan(tele)
        plans.append(plan)
        if stack.seq_mode == "repack":
            folds = max(tc.seq_len // plan.seq_len, 1)
            tokens_step = plan.batch_size * folds * plan.seq_len
        else:
            tokens_step = plan.batch_size * plan.seq_len
        stack.observe(dataclasses.replace(tele), tokens_step)
        tokens += tokens_step
    return plans
