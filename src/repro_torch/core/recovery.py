"""Divergence-aware recovery: detect, roll back, intervene, retry (copy of
``repro/core/recovery.py:1-618``).

The paper's failure mode, a large-batch, large-LR run that diverges (a
loss spike, then NaN), shows in telemetry before it shows in a
checkpoint: the Adam-variance series spikes ahead of the loss, and the
loss-ratio tracker flags the spike itself.  ``TrainSupervisor`` reacts to
exceptions only, so a run that diverges while it keeps running sails
through it.  This module closes that gap in the process:

* :class:`DivergenceDetector` classifies each step's
  :class:`StepTelemetry` into ``nan_loss`` / ``nan_grad`` / ``loss_spike``
  / ``var_excursion`` events (NaN always fires; the soft triggers keep a
  grace period and a cooldown after a rollback), with per-leaf blame.
* :class:`StateRing` keeps a few host copies of the train state, the
  ``ControllerState`` and the last telemetry, pushed on clean steps only,
  so a rollback never touches disk.
* :class:`RecoveryRegulator` is the intervention surface, inside the
  regulator stack so its state checkpoints through ``ControllerState``: an
  LR / grad-clip backoff (global or per leaf group), a seq-len clamp in
  bucket-ladder rungs, a data-window offset and the precursor's temporary
  LR cool-down.
* :class:`RollbackController` restores the newest snapshot, re-seats the
  controller state, and climbs the escalation ladder (LR backoff, then
  the seq-len clamp, then the data skip), bounded by the
  :class:`~repro_torch.distributed.fault_tolerance.RetryPolicy` it shares
  with ``TrainSupervisor``.
* :class:`RecoveryHook` is the trainer wiring (a duck-typed
  ``TrainerHook``).

On the card the optimizer updates params and its moments in place, so a
snapshot is a copy to host memory (pinned, one set of buffers a ring
slot, reused when the slot is evicted), and restoring hands out fresh
device tensors every time: two rollbacks to one snapshot restore the
same bits.  A snapshot keeps the port's per-layer layout; the ring spills
and refills in the JAX package's checkpoint format
(``bridge.train_state_to_numpy`` / ``abstract_train_state``), so a ring
spilled by either package loads in the other.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import os
import shutil
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.regulators import (ControllerState, Regulator,
                                         StepPlan, StepTelemetry)
from repro_torch.distributed.fault_tolerance import RetryPolicy


class DivergenceError(RuntimeError):
    """In-process recovery exhausted its retry budget (hard failure).

    Raised when ``RecoveryConfig.escalate == "raise"``, so a wrapping
    ``TrainSupervisor`` takes over with a process-level restart; the two
    layers share one ``RetryPolicy``.
    """


@dataclass(frozen=True)
class DivergenceEvent:
    kind: str  # nan_loss | nan_grad | loss_spike | var_excursion
    step: int
    detail: str = ""

    def __str__(self) -> str:
        return f"{self.kind}@{self.step}({self.detail})"


@dataclass(frozen=True)
class RecoveryConfig:
    """Thresholds and intervention parameters for the rollback controller."""

    # detector
    spike_ratio: float = 3.0     # loss / running-min loss that counts as
                                 # divergence (the tracker's 1.2 is a spike;
                                 # recovery acts on the catastrophic ones)
    var_gate: float = 8.0        # var_max vs trailing mean excursion gate
    var_sustain: int = 4         # consecutive excursion steps before firing
    grace_steps: int = 5         # soft triggers silent this many first obs
    cooldown_steps: int = 3      # soft triggers silent after a rollback
    # snapshot ring
    snapshot_interval: int = 5   # steps between ring snapshots
    ring: int = 3                # snapshots kept in memory
    ring_dir: str = ""           # spill the ring here on drain; "" derives
                                 # <checkpoint_dir>/ring when one exists
    # escalation ladder
    lr_backoff: float = 0.5      # recovery LR scale multiplier per rollback
    lr_floor: float = 0.05       # never scale the LR below this
    skip_window_steps: int = 4   # data batches skipped at rung 3
    # retry budget (the same policy as TrainSupervisor's)
    policy: RetryPolicy = RetryPolicy(max_retries=3)
    # on exhaustion: "stop" marks the run diverged and halts the loop;
    # "raise" raises DivergenceError (for a TrainSupervisor around it)
    escalate: str = "stop"


class DivergenceDetector:
    """Classifies per-step telemetry into divergence events.

    A NaN or inf loss or grad norm fires unconditionally.  The two soft
    triggers (loss-ratio spike, sustained var_max excursion) keep a grace
    period at the start and a cooldown after each rollback, and the var
    trailing mean takes only non-excursion samples, so the gate does not
    chase the spike it is meant to catch.
    """

    def __init__(self, cfg: RecoveryConfig):
        self.cfg = cfg
        self.n_obs = 0
        self.cooldown = 0
        self.var_trailing = 0.0
        self.var_streak = 0
        # per-leaf blame (with per-leaf telemetry): a trailing mean per
        # labelled group and the group blamed for the last excursion, so
        # the ladder knows which component diverged
        self.leaf_trailing: Dict[str, np.ndarray] = {}
        self.blamed = ""

    GATE_KEYS = ("var_max", "grad_norm")

    def begin_cooldown(self) -> None:
        self.cooldown = self.cfg.cooldown_steps
        self.var_streak = 0

    def _leaf_blame(self, tele: StepTelemetry, update_trailing: bool) -> str:
        """Track per-leaf trailing var_max and raw-grad norms; return the
        label of the worst excursion above the gate ('' without per-leaf
        telemetry or when every leaf is calm)."""
        if tele.per_leaf is None:
            return ""
        worst, worst_ratio = "", 0.0
        for key in self.GATE_KEYS:
            v = tele.per_leaf.get(key)
            if v is None:
                continue
            v = np.asarray(v, np.float64)
            if not np.all(np.isfinite(v)):
                continue
            trail = self.leaf_trailing.get(key)
            if trail is None or trail.shape != v.shape:
                self.leaf_trailing[key] = v.copy()
                continue
            ratios = v / np.maximum(trail, 1e-30)
            if np.any(ratios > self.cfg.var_gate) \
                    and float(np.max(ratios)) > worst_ratio:
                from repro_torch.core.telemetry import blame
                label = blame(tele.leaf_labels, ratios)
                if label:
                    worst, worst_ratio = label, float(np.max(ratios))
            if update_trailing:
                self.leaf_trailing[key] = 0.9 * trail + 0.1 * v
        return worst

    def update(self, tele: StepTelemetry) -> Optional[DivergenceEvent]:
        self.n_obs += 1
        if not math.isfinite(tele.loss):
            return DivergenceEvent("nan_loss", tele.step,
                                   f"loss={tele.loss}")
        if not math.isfinite(tele.grad_norm):
            return DivergenceEvent("nan_grad", tele.step,
                                   f"grad_norm={tele.grad_norm}")
        if self.cooldown > 0:
            self.cooldown -= 1
            return None
        if self.n_obs <= self.cfg.grace_steps:
            if math.isfinite(tele.var_max):
                self.var_trailing = (tele.var_max if self.var_trailing == 0.0
                                     else 0.9 * self.var_trailing
                                     + 0.1 * tele.var_max)
            self._leaf_blame(tele, update_trailing=True)
            return None
        if math.isfinite(tele.loss_ratio) \
                and tele.loss_ratio > self.cfg.spike_ratio:
            blamed = self._leaf_blame(tele, update_trailing=False)
            if blamed:
                self.blamed = blamed
            return DivergenceEvent(
                "loss_spike", tele.step,
                f"ratio={tele.loss_ratio:.2f}>{self.cfg.spike_ratio}"
                + (f" leaf={blamed}" if blamed else ""))
        if math.isfinite(tele.var_max) and self.var_trailing > 0.0 \
                and tele.var_max > self.cfg.var_gate * self.var_trailing:
            self.var_streak += 1
            # the leaf trailing mean is not chased during a streak either
            blamed = self._leaf_blame(tele, update_trailing=False)
            if blamed:
                self.blamed = blamed
            if self.var_streak >= self.cfg.var_sustain:
                return DivergenceEvent(
                    "var_excursion", tele.step,
                    f"var_max={tele.var_max:.3g}>"
                    f"{self.cfg.var_gate}x{self.var_trailing:.3g}"
                    f" for {self.var_streak}"
                    + (f" leaf={self.blamed}" if self.blamed else ""))
            return None
        self.var_streak = 0
        if math.isfinite(tele.var_max):
            self.var_trailing = (tele.var_max if self.var_trailing == 0.0
                                 else 0.9 * self.var_trailing
                                 + 0.1 * tele.var_max)
        self._leaf_blame(tele, update_trailing=True)
        return None


@dataclass
class Snapshot:
    """One host-side restore point (everything a rollback re-seats)."""

    step: int
    tokens_seen: int
    state: Any                    # the train state, host tensors, port layout
    controller: Dict[str, Any]    # ControllerState.to_host() deep copy
    telemetry: StepTelemetry      # the trainer's _last (plan inputs resume too)


def _tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over a train state's tensors, keeping dicts, lists, tuples
    and ``None`` (Shampoo's state of an ineligible leaf) as they are."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _tensors(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _tree_map(out.append, tree)
    return out


def _to_host(state: Any, reuse: Any = None) -> Any:
    """A host copy of ``state``: pinned buffers when it lies on the card
    (``reuse``'s, when they have the same shapes and dtypes), one
    synchronisation at the end."""
    src = _tensors(state)
    dst = _tensors(reuse) if reuse is not None else []
    if len(dst) != len(src) or any(
            d.shape != s.shape or d.dtype != s.dtype
            or d.is_pinned() != s.is_cuda for d, s in zip(dst, src)):
        dst = [torch.empty(s.shape, dtype=s.dtype, pin_memory=s.is_cuda)
               for s in src]
    for d, s in zip(dst, src):
        d.copy_(s.detach(), non_blocking=True)
    devices = {s.device for s in src if s.is_cuda}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    it = iter(dst)
    return _tree_map(lambda _: next(it), state)


def _telemetry_to_host(tele: StepTelemetry) -> Dict[str, Any]:
    """JSON-safe dict for a ring manifest (per-leaf vectors -> lists)."""
    from repro_torch.core.telemetry import per_leaf_to_host
    d = dataclasses.asdict(tele)
    d["leaf_labels"] = list(tele.leaf_labels)
    d["per_leaf"] = (per_leaf_to_host(tele.per_leaf)
                     if tele.per_leaf is not None else None)
    return d


def _telemetry_from_host(d: Dict[str, Any]) -> StepTelemetry:
    from repro_torch.core.telemetry import per_leaf_from_host
    d = dict(d)
    pl = d.pop("per_leaf", None)
    labels = tuple(d.pop("leaf_labels", ()))
    fields = {f.name for f in dataclasses.fields(StepTelemetry)}
    kept = {k: v for k, v in d.items()
            if k in fields and k not in ("per_leaf", "leaf_labels")}
    return StepTelemetry(
        per_leaf=per_leaf_from_host(pl) if pl is not None else None,
        leaf_labels=labels, **kept)


class StateRing:
    """Short in-memory ring of train-state snapshots on the host.

    :meth:`push` copies the state to host memory (the live device tensors
    are updated in place by the next step); a snapshot evicted from a full
    ring gives its host buffers to the next push.  :meth:`materialize`
    hands out fresh device tensors every time, so the ring entry survives
    repeated rollbacks to one point.

    :meth:`save` / :meth:`load` spill and refill the ring through the
    checkpoint module (one atomic, crc-validated ``step_*`` directory per
    snapshot, the train state in the JAX layout), so a drained run keeps
    its restore points: a resume with recovery on refills the ring.
    """

    def __init__(self, capacity: int = 3):
        self.capacity = max(capacity, 1)
        self._ring: Deque[Snapshot] = deque(maxlen=self.capacity)

    def __len__(self) -> int:
        return len(self._ring)

    def __iter__(self):
        return iter(self._ring)

    @property
    def steps(self) -> List[int]:
        return [s.step for s in self._ring]

    def push(self, step: int, tokens_seen: int, state: Any,
             controller: ControllerState, telemetry: StepTelemetry) -> None:
        reuse = (self._ring[0].state if len(self._ring) == self.capacity
                 else None)
        self._ring.append(Snapshot(
            step=step, tokens_seen=tokens_seen,
            state=_to_host(state, reuse),
            controller=copy.deepcopy(controller.to_host()),
            telemetry=dataclasses.replace(telemetry)))

    def newest(self) -> Optional[Snapshot]:
        return self._ring[-1] if self._ring else None

    def drop_newest(self) -> None:
        if self._ring:
            self._ring.pop()

    def materialize(self, snap: Snapshot, device: torch.device) -> Any:
        """Fresh tensors on ``device`` from a snapshot."""
        return _tree_map(lambda t: t.to(device, non_blocking=True, copy=True),
                         snap.state)

    # -- disk persistence (drain / resume) -----------------------------------
    def save(self, directory: str, model_cfg) -> List[int]:
        """Spill every snapshot to ``directory`` in the JAX checkpoint
        format (steps already on disk are skipped, stale ones pruned).
        Returns the persisted step list."""
        from repro_torch import bridge
        from repro_torch.checkpoint import checkpoint as ckpt_lib
        on_disk = set(ckpt_lib.available_steps(directory))
        for snap in self._ring:
            if snap.step in on_disk:
                continue
            ckpt_lib.save(directory, snap.step,
                          bridge.train_state_to_numpy(snap.state, model_cfg), {
                              "ring": True,
                              "tokens_seen": snap.tokens_seen,
                              "controller": snap.controller,
                              "telemetry": _telemetry_to_host(snap.telemetry),
                          })
        keep = set(self.steps)
        for step in on_disk - keep:
            shutil.rmtree(os.path.join(directory, f"step_{step:012d}"),
                          ignore_errors=True)
        return self.steps

    def load(self, directory: str, model_cfg, opt_cfg) -> int:
        """Refill the ring from a :meth:`save` spill of either package
        (oldest first, the newest ``capacity`` kept), as host tensors in
        the port's layout.  Corrupt entries are skipped: the ring is a
        best-effort optimisation over the real checkpoint, never a reason
        to fail a resume.  Returns the number of snapshots restored."""
        from repro_torch import bridge
        from repro_torch.checkpoint import checkpoint as ckpt_lib
        like = bridge.abstract_train_state(model_cfg, opt_cfg)
        steps = sorted(ckpt_lib.available_steps(directory))[-self.capacity:]
        n = 0
        for step in steps:
            try:
                tree, host = ckpt_lib.restore(directory, step, like)
            except (ckpt_lib.CheckpointCorruption, ValueError):
                continue
            self._ring.append(Snapshot(
                step=step,
                tokens_seen=int(host.get("tokens_seen", 0)),
                state=bridge.train_state_from_numpy(
                    tree, model_cfg, opt_cfg, torch.device("cpu")),
                controller=dict(host.get("controller", {})),
                telemetry=_telemetry_from_host(host.get("telemetry", {}))))
            n += 1
        return n


class RecoveryRegulator(Regulator):
    """The intervention surface, as a regulator so it checkpoints.

    At the end of the stack: ``lr_scale`` multiplies the scheduled LR (as
    the variance throttle does), the seq-len clamp folds by min against
    the ladder, and the trainer reads ``data_offset`` when it indexes the
    data.  All of it persists through ``ControllerState``, so a restart
    resumes the intervention exactly.
    """

    name = "recovery"

    def __init__(self, ladder: Tuple[int, ...], cfg: RecoveryConfig):
        self.ladder = tuple(ladder)
        self.cfg = cfg
        self.lr_scale = 1.0
        self.seq_drop = 0       # bucket-ladder rungs to clamp down
        self.data_offset = 0    # extra batches skipped in the data stream
        # per-leaf LR backoff: label -> scale, applied by the chain as
        # hyper["leaf_lr_scale"] so rung 1 can act on the blamed group
        # before it touches the global multiplier
        self.leaf_lr_scales: Dict[str, float] = {}
        # the precursor's temporary global LR cool-down (scale, steps left)
        self.cool_scale = 1.0
        self.cool_ttl = 0

    # -- escalation ladder ---------------------------------------------------
    def deepen_lr(self, blamed: str = "") -> None:
        """Deepen the LR backoff: on the ``blamed`` group alone (its
        per-leaf scale) when one is named, else the global multiplier."""
        if blamed:
            cur = self.leaf_lr_scales.get(blamed, 1.0)
            self.leaf_lr_scales[blamed] = max(
                cur * self.cfg.lr_backoff, self.cfg.lr_floor)
            return
        self.lr_scale = max(self.lr_scale * self.cfg.lr_backoff,
                            self.cfg.lr_floor)

    def clamp_seq(self) -> None:
        self.seq_drop = min(self.seq_drop + 1, len(self.ladder) - 1)

    def skip_data(self) -> None:
        self.data_offset += self.cfg.skip_window_steps

    # -- precursor cooldown --------------------------------------------------
    def precursor_cooldown(self, factor: float, steps: int) -> None:
        """A temporary LR cool-down (most-severe merge: the scale only
        tightens, the TTL only extends)."""
        self.cool_scale = max(min(self.cool_scale, factor),
                              self.cfg.lr_floor)
        self.cool_ttl = max(self.cool_ttl, int(steps))

    def leaf_lr_vector(self, labels: Tuple[str, ...]) -> Optional[np.ndarray]:
        """(n_leaves,) f32 scale vector in label order, or None when no
        per-leaf backoff is active (the step then takes none)."""
        if not self.leaf_lr_scales:
            return None
        return np.asarray([self.leaf_lr_scales.get(lbl, 1.0)
                           for lbl in labels], np.float32)

    # -- regulator protocol --------------------------------------------------
    def plan(self, tele: StepTelemetry, plan: StepPlan) -> StepPlan:
        scale = self.lr_scale
        if self.cool_ttl > 0:
            scale *= self.cool_scale
        plan.lr *= scale
        plan.grad_clip_scale *= scale
        if self.seq_drop:
            rung = 0
            for i, s in enumerate(self.ladder):
                if s <= plan.seq_len:
                    rung = i
            plan.seq_len = min(plan.seq_len,
                               self.ladder[max(rung - self.seq_drop, 0)])
        return plan

    def observe(self, tele: StepTelemetry, tokens_step: int) -> None:
        if self.cool_ttl > 0:
            self.cool_ttl -= 1
            if self.cool_ttl == 0:
                self.cool_scale = 1.0

    def state_dict(self) -> Dict[str, Any]:
        return {"lr_scale": self.lr_scale, "seq_drop": self.seq_drop,
                "data_offset": self.data_offset,
                "leaf_lr_scales": dict(self.leaf_lr_scales),
                "cool_scale": self.cool_scale, "cool_ttl": self.cool_ttl}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.lr_scale = float(d["lr_scale"])
        self.seq_drop = int(d["seq_drop"])
        self.data_offset = int(d["data_offset"])
        # keys absent in older checkpoints default to inactive
        self.leaf_lr_scales = {str(k): float(v) for k, v in
                               dict(d.get("leaf_lr_scales", {})).items()}
        self.cool_scale = float(d.get("cool_scale", 1.0))
        self.cool_ttl = int(d.get("cool_ttl", 0))


class RollbackController:
    """Restore, intervene and retry, within a budget.

    The ladder is cumulative across rollbacks: the first deepens the LR
    backoff (and the ``VarianceLRThrottle``'s own scale when one is in the
    stack), the second also clamps the seq-len plan one rung down, the
    third and later also skip the offending data window.  When the budget
    is spent the controller stops the run (``escalate == "stop"``) or
    raises :class:`DivergenceError` for the process-level supervisor.
    """

    def __init__(self, cfg: Optional[RecoveryConfig] = None):
        self.cfg = cfg or RecoveryConfig()
        self.detector = DivergenceDetector(self.cfg)
        self.ring = StateRing(self.cfg.ring)
        self.rollbacks = 0
        self.events: List[str] = []
        self._last_restore_step: Optional[int] = None

    # -- snapshots -----------------------------------------------------------
    def maybe_snapshot(self, trainer) -> None:
        if trainer.step % max(self.cfg.snapshot_interval, 1) == 0 \
                or not len(self.ring):
            self.snapshot(trainer)

    def snapshot(self, trainer) -> None:
        self.ring.push(trainer.step, trainer.tokens_seen, trainer.state,
                       trainer.controller_state(), trainer._last)

    # -- the rollback --------------------------------------------------------
    def handle(self, trainer, event: DivergenceEvent) -> bool:
        """React to a divergence event.  Returns True when the run should
        continue (state restored, intervention applied), False when the
        budget is spent (or raises, per ``escalate``)."""
        self.events.append(str(event))
        if self.rollbacks >= self.cfg.policy.max_retries:
            self.events.append(f"gave_up@{event.step}")
            if self.cfg.escalate == "raise":
                raise DivergenceError(
                    f"recovery budget exhausted after "
                    f"{self.rollbacks} rollbacks: {event}")
            return False
        self.rollbacks += 1

        # the regulator's state rides ControllerState, so a restore would
        # rewind earlier interventions too; the containment knobs stay
        # monotone across rollbacks: the pre-restore values are merged
        # back in at their most severe
        reg: RecoveryRegulator = trainer.stack["recovery"]
        pre = reg.state_dict()

        snap = self.ring.newest()
        if snap is not None and snap.step == self._last_restore_step \
                and len(self.ring) > 1:
            # the newest restore point failed twice in a row: fall back one
            # snapshot before escalating further
            self.ring.drop_newest()
            snap = self.ring.newest()
        if snap is None:
            # no in-run snapshot yet: a disk checkpoint is the next best
            # (trainer.resume re-seats the controller state too)
            if trainer.ckpt is not None and trainer.resume() is not None:
                self.events.append(f"disk_restore@{trainer.step}")
            else:
                self.events.append(f"no_restore_point@{event.step}")
                if self.cfg.escalate == "raise":
                    raise DivergenceError(f"no restore point for {event}")
                return False
        else:
            trainer.state = None  # the live state's device memory goes first
            trainer.state = self.ring.materialize(snap, trainer.device)
            trainer.load_controller_state(
                ControllerState.from_host(copy.deepcopy(snap.controller)))
            trainer._last = dataclasses.replace(snap.telemetry)
            self._last_restore_step = snap.step
            self.events.append(f"restored@{snap.step}")

        post = reg.state_dict()
        pre_leaf = dict(pre.get("leaf_lr_scales", {}))
        post_leaf = dict(post.get("leaf_lr_scales", {}))
        reg.load_state_dict({
            "lr_scale": min(pre["lr_scale"], post["lr_scale"]),
            "seq_drop": max(pre["seq_drop"], post["seq_drop"]),
            "data_offset": max(pre["data_offset"], post["data_offset"]),
            "leaf_lr_scales": {
                lbl: min(pre_leaf.get(lbl, 1.0), post_leaf.get(lbl, 1.0))
                for lbl in set(pre_leaf) | set(post_leaf)},
            "cool_scale": min(pre.get("cool_scale", 1.0),
                              post.get("cool_scale", 1.0)),
            "cool_ttl": max(pre.get("cool_ttl", 0),
                            post.get("cool_ttl", 0)),
        })
        self._intervene(trainer)
        self.detector.begin_cooldown()
        return True

    # -- precursor (early warning, before any divergence event) --------------
    def handle_precursor(self, trainer, event, factor: float = 0.5,
                         ttl: int = 8) -> None:
        """React to a gradient-direction precursor: push a snapshot now
        (the state is still healthy) and apply a temporary LR cool-down
        instead of spending a rollback.  Costs nothing from the budget."""
        self.events.append(str(event))
        self.snapshot(trainer)
        if "recovery" in trainer.stack:
            trainer.stack["recovery"].precursor_cooldown(factor, ttl)

    def _intervene(self, trainer) -> None:
        reg: RecoveryRegulator = trainer.stack["recovery"]
        # rung 1 (every rollback): deepen the LR / grad-clip backoff, on
        # the blamed group alone at the first rollback that names one;
        # later rollbacks mean that was not enough, so they go global
        blamed = self.detector.blamed
        reg.deepen_lr(blamed if (blamed and self.rollbacks == 1) else "")
        if "var_lr_throttle" in trainer.stack:
            th = trainer.stack["var_lr_throttle"]
            th.scale = max(th.scale * th.spec.backoff, th.spec.floor)
        # rung 2: clamp the SLW seq-len plan one bucket down
        if self.rollbacks >= 2:
            reg.clamp_seq()
        # rung 3: skip the offending data window
        if self.rollbacks >= 3:
            reg.skip_data()


class RecoveryHook:
    """Trainer wiring (a duck-typed ``TrainerHook``).  The trainer marks
    ``diverged`` / ``stopping`` before hooks run, so a successful rollback
    clears both and the loop continues."""

    def __init__(self, controller: RollbackController):
        self.controller = controller

    def on_run_start(self, tr) -> None:
        # a step-0 restore point: a fault before the first interval
        # snapshot must still be recoverable
        self.controller.snapshot(tr)

    def on_step_start(self, tr) -> None:
        pass

    def on_step_end(self, tr, tele: StepTelemetry, plan: StepPlan,
                    metrics: Dict[str, Any]) -> None:
        event = self.controller.detector.update(tele)
        if event is None:
            # no snapshot while a var-excursion streak builds: a poisoned
            # but finite state must not become a restore point
            if self.controller.detector.var_streak == 0:
                self.controller.maybe_snapshot(tr)
            return
        recovered = self.controller.handle(tr, event)
        tr.result.rollbacks = self.controller.rollbacks
        tr.result.recovery_events = list(self.controller.events)
        if recovered:
            tr.stopping = False
            tr.result.diverged = False
        else:
            tr.result.diverged = True
            tr.stopping = True

    def on_run_end(self, tr) -> None:
        tr.result.rollbacks = self.controller.rollbacks
        tr.result.recovery_events = list(self.controller.events)

    def close(self) -> None:
        pass
