"""Composable training control plane: regulators -> one StepPlan per step
(copy of ``repro/core/regulators.py:57-215, 390-531``, default kinds).

Each schedule is a ``Regulator``: a host-side state machine that reads the
shared per-step :class:`StepTelemetry` and contributes to the
:class:`StepPlan` (sequence-length bucket, batch size, LR, grad-clip
scale) that the trainer executes.  ``seq_len`` and ``batch_size`` fold by
min; the LR schedule sets the LR.  The kinds ``seqlen``, ``batch_warmup``
and ``lr`` are ported; ``grad_noise_batch``, ``var_lr_throttle`` and
``critical_batch`` are refused.  Pure Python and numpy.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import (BatchWarmupConfig, OptimizerConfig,
                                      RegulatorSpec, SLWConfig, TrainConfig)
from repro_torch.core.batch_warmup import BatchWarmup
from repro_torch.core.curriculum import SLWCurriculum, apply_seqlen
from repro_torch.optim.schedule import lr_at

NOT_PORTED = ("grad_noise_batch", "var_lr_throttle", "critical_batch")


@dataclass
class StepTelemetry:
    """What every regulator sees: the exact host counters and the last
    completed step's observations (NaN before the first step).
    ``grad_norm`` is the raw pre-clip global norm, ``grad_norm_clipped``
    the post-clip one.  The reference's GNS and per-leaf fields come with
    their slices."""

    step: int = 0
    tokens_seen: int = 0
    loss: float = float("nan")
    loss_ratio: float = float("nan")
    grad_norm: float = float("nan")
    grad_norm_clipped: float = float("nan")
    var_max: float = float("nan")
    var_l1: float = float("nan")


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
                 warmup_steps_hint: int = 0):
        self.cfg = cfg
        self.curriculum = SLWCurriculum(cfg, full_seq,
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
                warmup_steps_hint: int = 0) -> RegulatorStack:
    """The control plane of a TrainConfig: ``tc.regulators``, or
    :func:`auto_specs` when it is empty."""
    regs: List[Regulator] = []
    for spec in tc.regulators or auto_specs(tc):
        if spec.kind == "seqlen":
            regs.append(SeqLenRegulator(tc.slw, tc.seq_len,
                                        warmup_steps_hint=warmup_steps_hint))
        elif spec.kind == "batch_warmup":
            regs.append(BatchSizeRegulator(tc.batch_warmup, tc.global_batch,
                                           dp_size=dp_size))
        elif spec.kind == "lr":
            regs.append(LRScheduleRegulator(tc.optimizer))
        elif spec.kind in NOT_PORTED:
            raise NotImplementedError(
                f"regulator kind {spec.kind!r} is not ported yet")
        else:
            raise ValueError(f"unknown regulator kind {spec.kind!r}")
    return RegulatorStack(regs, full_seq=tc.seq_len,
                          full_batch=tc.global_batch, base_lr=tc.optimizer.lr)


def predict_trajectory(tc: TrainConfig, n_steps: int, *, dp_size: int = 1,
                       warmup_steps_hint: int = 0) -> List[StepPlan]:
    """The stack's open-loop trajectory without training: the exact
    (seq_len, batch, lr) sequence the trainer executes, with calm synthetic
    telemetry (unit var_max / grad_norm) for the variance gate.  Token
    accounting mirrors the trainer's."""
    stack = build_stack(tc, dp_size=dp_size,
                        warmup_steps_hint=warmup_steps_hint)
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
