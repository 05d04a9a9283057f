"""End-to-end trainer on the regulator control plane (``repro/launch/train.py:60-728``).

Usable as a library (``train(tc, ...)``, ``Trainer``) and as a CLI:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-117m \\
      --steps 200 --batch 16 --seq 1024 --slw --batch-warmup --duration 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-117m \\
      --reduced --device cpu --steps 20 --seq 64 --batch 4 --slw
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
      --reduced --device cpu --steps 12 --seq 64 --batch 4 --slw
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
      --reduced --device cpu --steps 12 --seq 64 --batch 4 --slw
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch deepseek-moe-16b --reduced --device cpu --steps 12 --seq 64 \\
      --batch 4 --slw --duration 6 --eval-interval 6
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 12 --seq 64 --batch 4 --slw --ckpt-dir /tmp/ck \\
      --ckpt-interval 5 [--resume] [--var-lr-throttle]
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 12 --seq 64 --batch 4 --slw --per-leaf-telemetry --gns \\
      --gns-batch --metrics-jsonl /tmp/m.jsonl [--optimizer sm3|shampoo]
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 12 --seq 64 --batch 4 --slw --recover --max-rollbacks 2 \\
      --inject-faults nan_grad@4 --inject-seed 3

The loop is the paper's joint recipe: the regulator stack plans the step
(seqlen bucket, batch size, LR, grad-clip scale) -> the full-length host
batch is row-sliced and truncated/repacked -> the train step (loss, its
gradient through the flash-attention, WKV-6 or SSD kernels, the AdamW
chain) -> loss ratio and Adam-variance telemetry go back into the stack.
``--arch`` takes every preset: a vision preset's patch prefix stays out
of the SLW pacing, an audio preset's frames are cut with the tokens, and
a MoE's router metrics (``load_balance``, ``router_z``, ``dropped_frac``)
go to the eval lines and the JSONL rows.
Eval, checkpoints, drain, the watchdog and telemetry recording are
``TrainerHook``s.

The device defaults to CUDA and the run fails on a machine without one
unless ``device="cpu"`` / ``--device cpu`` is given.  The initial weights
are drawn by a generator on that device.  Training runs in fp32 with TF32
off, so fp32 means fp32 on the card.  Checkpoints are the JAX package's
format (``repro_torch.checkpoint``): the train state in the JAX layout plus
the control plane's state, so a run resumes mid-warmup on the same
schedule, from a checkpoint of either package; ``resume`` restores onto
the trainer's device.  Per-leaf telemetry (``--per-leaf-telemetry``), the
gradient-noise-scale measurement (``--gns``), its critical-batch regulator
(``--gns-batch``) and precursor, and the optimizer chain's SM3, Shampoo
and AGC options run as in the reference.  So do divergence recovery
(``--recover``: ``core.recovery``'s rollback controller, its snapshot ring
spilled next to the checkpoint on drain and refilled on resume; the
precursor hands its events to it) and deterministic fault injection
(``--inject-faults``: ``distributed.fault_injection``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager, migrate_host_state
from repro_torch.configs import ARCHS, get_arch, reduced as reduce_cfg
from repro_torch.configs.base import (BatchWarmupConfig, GNSConfig,
                                      OptimizerConfig, RegulatorSpec,
                                      SLWConfig, TrainConfig)
from repro_torch.core import telemetry as telemetry_lib
from repro_torch.core import trace
from repro_torch.core.recovery import (RecoveryConfig, RecoveryHook,
                                       RecoveryRegulator, RollbackController)
from repro_torch.core.regulators import (ControllerState, RegulatorStack,
                                         StepPlan, StepTelemetry, auto_specs,
                                         build_stack)
from repro_torch.core.stability import LossRatioTracker
from repro_torch.data import DataPipeline, SyntheticCorpus
from repro_torch.distributed.fault_injection import (FaultInjectionHook,
                                                     FaultInjector)
from repro_torch.distributed.fault_tolerance import (DrainSignal, RetryPolicy,
                                                     StepWatchdog)
from repro_torch.kernels import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model_zoo
from repro_torch.models.moe import AUX_KEYS as MOE_METRICS


@dataclass
class TrainResult:
    steps: int = 0
    tokens: int = 0
    diverged: bool = False
    drained: bool = False
    wall_time_s: float = 0.0
    loss_history: List[float] = field(default_factory=list)
    loss_ratios: List[float] = field(default_factory=list)
    lr_history: List[float] = field(default_factory=list)
    seqlen_history: List[int] = field(default_factory=list)
    batch_history: List[int] = field(default_factory=list)
    var_max_history: List[float] = field(default_factory=list)
    var_l1_history: List[float] = field(default_factory=list)
    grad_norm_history: List[float] = field(default_factory=list)
    val_ppl_history: List[Tuple[int, float]] = field(default_factory=list)
    tracker_summary: Dict[str, float] = field(default_factory=dict)
    watchdog_summary: Dict[str, float] = field(default_factory=dict)
    restored_from_step: Optional[int] = None
    # divergence-aware recovery accounting (core.recovery)
    rollbacks: int = 0
    recovery_events: List[str] = field(default_factory=list)
    faults_fired: List[str] = field(default_factory=list)
    # gradient-direction early warnings (repro_torch.gns.precursor)
    precursor_events: List[str] = field(default_factory=list)


# ---------------------------------------------------------------------------
# hooks
# ---------------------------------------------------------------------------

class TrainerHook:
    """Cross-cutting trainer concern.  ``on_step_start`` runs before the
    plan is made; ``on_step_end`` after the regulators observed the step.
    When ``trainer.stopping`` is set, interval work should be skipped."""

    def on_run_start(self, tr: "Trainer") -> None:
        pass

    def on_step_start(self, tr: "Trainer") -> None:
        pass

    def on_step_end(self, tr: "Trainer", tele: StepTelemetry, plan: StepPlan,
                    metrics: Dict[str, float]) -> None:
        pass

    def on_run_end(self, tr: "Trainer") -> None:
        """Normal-completion epilogue."""

    def close(self) -> None:
        """Resource cleanup only; also runs when the loop raises."""


class DrainHook(TrainerHook):
    """Stop at the next step boundary once a drain signal latched."""

    def __init__(self, drain: Optional[DrainSignal]):
        self.drain = drain

    def on_step_start(self, tr: "Trainer") -> None:
        if self.drain is not None and self.drain.should_drain:
            tr.request_drain()

    def close(self) -> None:
        if self.drain is not None:
            self.drain.uninstall()


class WatchdogHook(TrainerHook):
    def on_step_start(self, tr: "Trainer") -> None:
        tr.watchdog.start()

    def on_step_end(self, tr, tele, plan, metrics) -> None:
        tr.watchdog.stop()

    def on_run_end(self, tr: "Trainer") -> None:
        tr.result.watchdog_summary = tr.watchdog.summary()


class TelemetryHook(TrainerHook):
    """Records the per-step histories and drives the user callback."""

    def __init__(self, callback: Optional[Callable[[int, Dict[str, float]],
                                                   None]] = None):
        self.callback = callback

    def on_step_end(self, tr, tele, plan, metrics) -> None:
        res = tr.result
        res.loss_history.append(tele.loss)
        res.loss_ratios.append(tele.loss_ratio)
        res.lr_history.append(plan.lr)
        res.seqlen_history.append(plan.seq_len)
        res.batch_history.append(plan.batch_size)
        res.var_max_history.append(tele.var_max)
        res.var_l1_history.append(tele.var_l1)
        res.grad_norm_history.append(tele.grad_norm)
        if self.callback is not None:
            self.callback(tele.step, dict(metrics))

    def on_run_end(self, tr: "Trainer") -> None:
        tr.result.tracker_summary = tr.tracker.summary()


class MetricsJsonlHook(TrainerHook):
    """Appends one JSON row per step (StepPlan + StepTelemetry) to a file,
    flushed per step.  The optional scalars (``grad_norm_clipped``, the
    ``gns_*`` pair) are written when finite, a MoE's router metrics
    (``load_balance``, ``router_z``, ``dropped_frac``) when the step has
    them; with per-leaf vectors, a ``per_leaf`` dict, and the labels once,
    in the first such row."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None
        self._wrote_labels = False

    def on_run_start(self, tr: "Trainer") -> None:
        self._fh = open(self.path, "a", buffering=1)

    def on_step_end(self, tr, tele, plan, metrics) -> None:
        row = {"step": tele.step, "tokens_seen": tele.tokens_seen,
               "loss": tele.loss, "loss_ratio": tele.loss_ratio,
               "grad_norm": tele.grad_norm, "var_max": tele.var_max,
               "var_l1": tele.var_l1,
               "plan": {"seq_len": plan.seq_len,
                        "batch_size": plan.batch_size, "lr": plan.lr,
                        "grad_clip_scale": plan.grad_clip_scale}}
        for k in ("grad_norm_clipped", "gns_small_sq", "gns_big_sq",
                  "gns_b_small", "gns_b_big"):
            v = getattr(tele, k)
            if math.isfinite(v):
                row[k] = v
        for k in MOE_METRICS:
            if k in metrics:
                row[k] = metrics[k]
        if tele.per_leaf is not None:
            row["per_leaf"] = telemetry_lib.per_leaf_to_host(tele.per_leaf)
            if not self._wrote_labels:
                row["leaf_labels"] = list(tele.leaf_labels)
                self._wrote_labels = True
        self._fh.write(json.dumps(row) + "\n")

    def on_run_end(self, tr: "Trainer") -> None:
        self.close()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class EvalHook(TrainerHook):
    """Full-length validation every ``eval_interval`` steps."""

    def __init__(self, eval_batch: int = 8, quiet: bool = True):
        self.eval_batch = eval_batch
        self.quiet = quiet

    def on_step_end(self, tr, tele, plan, metrics) -> None:
        interval = tr.tc.eval_interval
        if tr.stopping or not interval or tr.step % interval != 0:
            return
        ev = tr.pipeline.eval_batch(tr.step // interval, self.eval_batch)
        ppl = float(np.exp(min(tr.eval_loss(ev), 30.0)))
        tr.result.val_ppl_history.append((tr.step, ppl))
        if not self.quiet:
            moe = "".join(f" {k} {metrics[k]:.4f}" for k in MOE_METRICS
                          if k in metrics)
            print(f"step {tr.step} tokens {tr.tokens_seen} "
                  f"loss {tele.loss:.4f} val_ppl {ppl:.2f} "
                  f"seqlen {plan.seq_len} batch {plan.batch_size} "
                  f"lr {plan.lr:.2e}{moe}", flush=True)


class CheckpointHook(TrainerHook):
    """Periodic and final checkpoints (the drain path saves on its own).
    The final one is skipped when the last periodic one holds the same
    step: nothing has changed since, and the copy would briefly take the
    disk of a fourth checkpoint."""

    def on_step_end(self, tr, tele, plan, metrics) -> None:
        if tr.stopping or tr.ckpt is None or not tr.tc.checkpoint_interval:
            return
        if tr.step % tr.tc.checkpoint_interval == 0:
            tr.save_checkpoint()

    def on_run_end(self, tr: "Trainer") -> None:
        if tr.ckpt is not None and not tr.result.drained \
                and tr.saved_step != tr.step:
            tr.save_checkpoint()


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

class Trainer:
    """Host-side training control plane around the regulator stack.

    Owns the model and optimizer state on ``device``, the data pipeline,
    the regulator stack, the loss-ratio tracker and the checkpoint
    manager; eval, checkpoint cadence, drain, the watchdog and telemetry
    are hooks.  ``state`` may be replaced before ``run``
    (``repro_torch.bridge.train_state_from_numpy`` carries a reference
    state over).  ``fail_at_step`` raises before that step runs (the
    fault-tolerance drills).  With ``tc.gns`` enabled and a precursor
    window, a :class:`repro_torch.gns.PrecursorHook` records the
    precursor's events on ``result.precursor_events`` and hands them to
    the rollback controller when recovery is on.
    """

    def __init__(self, tc: TrainConfig, *, dp_size: int = 1,
                 eval_batch: int = 8, stop_on_nan: bool = True,
                 drain: Optional[DrainSignal] = None,
                 callback: Optional[Callable[[int, Dict[str, float]],
                                             None]] = None,
                 fail_at_step: Optional[int] = None, quiet: bool = True,
                 hooks: Optional[List[TrainerHook]] = None,
                 recovery: Optional[RecoveryConfig] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 device: str = "cuda"):
        """``hooks`` are appended after the default set (drain, watchdog,
        telemetry, eval, checkpoint, then recovery and fault injection).
        ``recovery`` turns on the in-process rollback controller
        (``core.recovery``); ``fault_injector`` arms deterministic fault
        injection for the run (``distributed.fault_injection``)."""
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # fp32 means fp32: no TF32 in matmuls or convolutions
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.tc = tc
        self.dp_size = max(dp_size, 1)
        self.stop_on_nan = stop_on_nan
        self.fail_at_step = fail_at_step
        cfg = tc.model
        self.model = model_zoo.build_model(cfg, remat=tc.remat)
        self.state = steps_lib.init_train_state(
            torch.Generator(device=self.device).manual_seed(tc.seed), cfg,
            tc.optimizer, self.device)
        # the reference's leaf labels, fixed for the run
        self.leaf_labels = telemetry_lib.param_labels(self.state["params"])
        corpus = SyntheticCorpus(vocab_size=cfg.vocab_size,
                                 seq_len=tc.seq_len, seed=tc.seed)
        self.pipeline = DataPipeline(corpus, tc.global_batch, model_cfg=cfg)
        self.stack: RegulatorStack = build_stack(
            tc, dp_size=self.dp_size,
            warmup_steps_hint=tc.optimizer.warmup_steps,
            prefix_tokens=cfg.prefix_tokens)
        self.tracker = LossRatioTracker()
        self.watchdog = StepWatchdog()
        self.ckpt = (CheckpointManager(tc.checkpoint_dir, tc.keep_checkpoints)
                     if tc.checkpoint_dir else None)
        self.saved_step: Optional[int] = None  # of this run's last save
        self.step_fn = steps_lib.make_train_step(self.model, tc.optimizer,
                                                 gns=tc.gns)

        self.result = TrainResult()
        self.step = 0
        self.tokens_seen = 0
        self.stopping = False
        self._drain_requested = False
        self._last = StepTelemetry()
        # set by the fault injector (grad_spike) for the next step only
        self.fault_injector = fault_injector
        self._pending_grad_fault: Optional[Tuple[float, str]] = None

        # divergence recovery: the intervention regulator joins the end of
        # the stack (its state checkpoints through ControllerState) and the
        # rollback controller rides the hook list
        self.recovery: Optional[RollbackController] = None
        self._recovery_reg: Optional[RecoveryRegulator] = None
        self._ring_dir = ""
        if recovery is not None:
            ladder = (self.stack["seqlen"].curriculum.ladder
                      if "seqlen" in self.stack else (tc.seq_len,))
            self._recovery_reg = RecoveryRegulator(ladder, recovery)
            self.stack.regulators.append(self._recovery_reg)
            self.recovery = RollbackController(recovery)
            self._ring_dir = recovery.ring_dir or (
                os.path.join(tc.checkpoint_dir, "ring")
                if tc.checkpoint_dir else "")

        self.hooks: List[TrainerHook] = [
            DrainHook(drain), WatchdogHook(), TelemetryHook(callback),
            EvalHook(eval_batch=eval_batch, quiet=quiet), CheckpointHook()]
        if self.recovery is not None:
            self.hooks.append(RecoveryHook(self.recovery))
        if fault_injector is not None:
            self.hooks.append(FaultInjectionHook(fault_injector))
        if tc.gns.enabled and tc.gns.precursor_window > 0:
            from repro_torch.gns.precursor import (GradientPrecursor,
                                                   PrecursorHook)
            self.hooks.append(PrecursorHook(
                GradientPrecursor(tc.gns), controller=self.recovery,
                cool=(tc.gns.precursor_cooldown_factor,
                      tc.gns.precursor_cooldown_steps)))
        self.hooks += list(hooks or [])

    def request_drain(self) -> None:
        self._drain_requested = True

    # -- the control plane's state (the checkpoint's host payload) ----------
    def controller_state(self) -> ControllerState:
        return self.stack.controller_state(self.step, self.tokens_seen,
                                           self.tracker.state_dict())

    def load_controller_state(self, cs: ControllerState) -> None:
        self.step = cs.step
        self.tokens_seen = cs.tokens_seen
        if cs.tracker:
            self.tracker.load_state_dict(cs.tracker)
        self.stack.load_controller_state(cs)

    def save_checkpoint(self) -> None:
        """The train state in the JAX layout and the controller dict, the
        single source of truth for the host state."""
        if self.ckpt is None:
            return
        self.ckpt.save(self.step,
                       bridge.train_state_to_numpy(self.state, self.tc.model),
                       {"controller": self.controller_state().to_host()})
        self.saved_step = self.step

    def resume(self) -> Optional[int]:
        """Restore the newest valid checkpoint, if any, onto the trainer's
        device.  Returns its step."""
        if self.ckpt is None:
            return None
        got_step, tree, host = self.ckpt.restore_latest(
            bridge.abstract_train_state(self.tc.model, self.tc.optimizer))
        if got_step is None:
            return None
        self.state = None  # the fresh state's device memory goes first
        self.state = bridge.train_state_from_numpy(
            tree, self.tc.model, self.tc.optimizer, self.device)
        host = migrate_host_state(host)
        self.load_controller_state(ControllerState.from_host(
            host["controller"]))
        self.result.restored_from_step = got_step
        # a drained run spilled its rollback ring next to the checkpoint:
        # refill it, so recovery resumes with the same restore points
        if self.recovery is not None and self._ring_dir \
                and os.path.isdir(self._ring_dir):
            self.recovery.ring.load(self._ring_dir, self.tc.model,
                                    self.tc.optimizer)
        return got_step

    def to_device(self, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        """Token ids as int64, frontend embeddings as fp32."""
        return {k: torch.as_tensor(
                    np.ascontiguousarray(v),
                    dtype=(torch.float32 if np.issubdtype(v.dtype,
                                                          np.floating)
                           else torch.int64)).to(self.device)
                for k, v in batch.items()}

    @torch.no_grad()
    def eval_loss(self, batch: Dict[str, np.ndarray]) -> float:
        return float(self.model.loss(self.state["params"],
                                     self.to_device(batch))[1]["loss"])

    # -- one training step ---------------------------------------------------
    def run_step(self) -> Tuple[StepTelemetry, StepPlan, Dict[str, float]]:
        """One step: plan, batch, the train step, the one host transfer,
        observe.  Each phase is a span of ``core.trace`` (off unless
        tracing), with the step's rows and length as counters."""
        with trace.span("trainer.step", step=self.step):
            return self._run_step()

    def _run_step(self) -> Tuple[StepTelemetry, StepPlan, Dict[str, float]]:
        tele = dataclasses.replace(self._last, step=self.step,
                                   tokens_seen=self.tokens_seen)
        with trace.span("trainer.plan"):
            plan = self.stack.plan(tele)
        # the recovery regulator's data offset skips a data window the
        # rollback controller blamed for a divergence
        offset = (self._recovery_reg.data_offset
                  if self._recovery_reg is not None else 0)
        with trace.span("trainer.batch"):
            batch = self.pipeline.batch_at(self.step + offset)
        with trace.span("trainer.apply"):
            batch, tokens_step = self.stack.apply(batch, plan)
        # the runtime vectors go in only while active, so a clean step is
        # the step without them: a grad_spike fault's one-step multiplier
        # on the raw per-leaf gradients, the per-leaf LR backoff
        extra: Dict[str, Any] = {}
        if self._pending_grad_fault is not None \
                and self.fault_injector is not None:
            factor, substr = self._pending_grad_fault
            self._pending_grad_fault = None
            extra["grad_scale"] = self.fault_injector.grad_scale_vector(
                self.leaf_labels, self.step, factor, substr)
        if self._recovery_reg is not None \
                and self._recovery_reg.leaf_lr_scales:
            extra["leaf_lr"] = self._recovery_reg.leaf_lr_vector(
                self.leaf_labels)
        with trace.span("trainer.to_device"):
            dev_batch = self.to_device(batch)
        # the reference hands the step np.float32 scalars
        with trace.span("train_step"):
            self.state, out = self.step_fn(
                self.state, dev_batch, float(np.float32(plan.lr)),
                float(np.float32(plan.grad_clip_scale)), **extra)
        # one transfer: the scalars as floats, the per-leaf vectors apart
        with trace.span("trainer.sync"):
            metrics, per_leaf = telemetry_lib.split_metrics(out)
        for k in [k for k in metrics if k.startswith(trace.METRIC_PREFIX)]:
            trace.count(k[len(trace.METRIC_PREFIX):], metrics.pop(k))
        trace.count("rows", plan.batch_size)
        trace.count("seq", plan.seq_len)
        with trace.span("trainer.observe"):
            loss = metrics["loss"]
            ratio = (self.tracker.update(loss) if math.isfinite(loss)
                     else float("inf"))
            nan = float("nan")
            post = dataclasses.replace(
                tele, loss=loss, loss_ratio=ratio,
                grad_norm=metrics["grad_norm"],
                grad_norm_clipped=metrics["grad_norm_clipped"],
                var_max=metrics["var_max"], var_l1=metrics["var_l1"],
                gns_small_sq=metrics.get("gns_small_sq", nan),
                gns_big_sq=metrics.get("gns_big_sq", nan),
                gns_b_small=metrics.get("gns_b_small", nan),
                gns_b_big=metrics.get("gns_b_big", nan),
                per_leaf=per_leaf,
                leaf_labels=self.leaf_labels if per_leaf is not None else ())
            self.stack.observe(post, tokens_step)
        self.step += 1
        self.tokens_seen += tokens_step
        self._last = post
        return post, plan, metrics

    # -- the loop -------------------------------------------------------------
    def run(self, max_steps: Optional[int] = None) -> TrainResult:
        opt_cfg = self.tc.optimizer
        total_steps = opt_cfg.total_steps or 10**9
        total_tokens = opt_cfg.total_tokens or 10**18
        if max_steps is not None:
            total_steps = min(total_steps, self.step + max_steps)
        t_start = time.time()
        for h in self.hooks:
            h.on_run_start(self)
        try:
            while self.step < total_steps and self.tokens_seen < total_tokens:
                for h in self.hooks:
                    h.on_step_start(self)
                if self._drain_requested:
                    self.save_checkpoint()
                    # the rollback ring goes next to the checkpoint, so its
                    # restore points survive the preemption
                    if self.recovery is not None and self._ring_dir:
                        self.recovery.ring.save(self._ring_dir, self.tc.model)
                    self.result.drained = True
                    break
                if (self.fail_at_step is not None
                        and self.step == self.fail_at_step):
                    raise RuntimeError(f"injected failure at step {self.step}")
                tele, plan, metrics = self.run_step()
                if not math.isfinite(tele.loss):
                    self.result.diverged = True
                    self.stopping = self.stop_on_nan
                for h in self.hooks:
                    h.on_step_end(self, tele, plan, metrics)
                if self.stopping:
                    break
        except BaseException:
            # the crash path: resource cleanup only, no checkpoint
            for h in self.hooks:
                h.close()
            raise
        for h in self.hooks:
            h.on_run_end(self)
        for h in self.hooks:
            h.close()
        self.result.steps = self.step
        self.result.tokens = self.tokens_seen
        self.result.wall_time_s = time.time() - t_start
        return self.result


def train(tc: TrainConfig, max_steps: Optional[int] = None,
          eval_batch: int = 8, resume: bool = False, stop_on_nan: bool = True,
          drain: Optional[DrainSignal] = None,
          callback: Optional[Callable[[int, Dict[str, float]], None]] = None,
          fail_at_step: Optional[int] = None, quiet: bool = True,
          dp_size: int = 1, hooks: Optional[List[TrainerHook]] = None,
          recovery: Optional[RecoveryConfig] = None,
          fault_injector: Optional[FaultInjector] = None,
          device: str = "cuda") -> TrainResult:
    """Run the training loop on ``device``; returns full telemetry.
    ``resume`` restores the newest valid checkpoint of
    ``tc.checkpoint_dir`` first; ``fail_at_step`` injects a crash,
    ``fault_injector`` the step-indexed fault matrix, and ``recovery``
    turns on divergence rollback."""
    trainer = Trainer(tc, dp_size=dp_size, eval_batch=eval_batch,
                      stop_on_nan=stop_on_nan, drain=drain, callback=callback,
                      fail_at_step=fail_at_step, quiet=quiet, hooks=hooks,
                      recovery=recovery, fault_injector=fault_injector,
                      device=device)
    if resume:
        trainer.resume()
    return trainer.run(max_steps=max_steps)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def build_config(args) -> TrainConfig:
    cfg = get_arch(args.arch)
    cfg = reduce_cfg(cfg) if args.reduced else cfg
    if args.vocab:
        cfg = cfg.replace(vocab_size=args.vocab)
    slw = SLWConfig(
        enabled=args.slw, pacing=args.pacing, start_seq_len=args.start_seq,
        duration_steps=args.duration, round_multiple=args.round_multiple,
        mode=args.slw_mode, max_buckets=args.max_buckets)
    total_tokens = args.tokens or args.steps * args.batch * args.seq
    opt = OptimizerConfig(
        lr=args.lr, min_lr=args.min_lr, warmup_steps=args.warmup,
        warmup_tokens=args.warmup * args.batch * args.seq,
        total_steps=args.steps, total_tokens=total_tokens,
        schedule=args.schedule, grad_clip=args.clip,
        optimizer=args.optimizer, decay_mask=args.decay_mask,
        agc_clip=args.agc,
        telemetry_level=("per_leaf" if args.per_leaf_telemetry
                         else "scalar"))
    bw = BatchWarmupConfig(enabled=args.batch_warmup,
                           start_batch=max(args.batch // 8, 1),
                           warmup_tokens=total_tokens // 20)
    gns = GNSConfig(enabled=args.gns or args.gns_batch,
                    shards=args.gns_shards,
                    precursor_window=args.gns_precursor_window,
                    headroom=args.gns_headroom)
    tc = TrainConfig(model=cfg, optimizer=opt, slw=slw, batch_warmup=bw,
                     gns=gns, seq_len=args.seq, global_batch=args.batch,
                     seed=args.seed, remat=args.remat,
                     eval_interval=args.eval_interval,
                     checkpoint_interval=args.ckpt_interval,
                     checkpoint_dir=args.ckpt_dir)
    # the telemetry-driven regulators come after the auto-derived
    # schedules (the throttle multiplies the scheduled LR)
    extra = [RegulatorSpec(kind=kind) for kind, on in (
        ("grad_noise_batch", args.grad_noise_batch),
        ("critical_batch", args.gns_batch),
        ("var_lr_throttle", args.var_lr_throttle)) if on]
    if extra:
        tc = dataclasses.replace(tc,
                                 regulators=auto_specs(tc) + tuple(extra))
    return tc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="gpt2-117m", choices=sorted(ARCHS))
    p.add_argument("--reduced", action="store_true",
                   help="reduced same-family config (CPU-trainable)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--tokens", type=int, default=0)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--vocab", type=int, default=0)
    p.add_argument("--lr", type=float, default=6e-4)
    p.add_argument("--min-lr", type=float, default=1e-5)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--schedule", default="token_cosine",
                   choices=["token_cosine", "step_cosine", "constant"])
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "sm3", "shampoo"],
                   help="inner optimizer of the gradient-transform chain")
    p.add_argument("--decay-mask", default="all", choices=["all", "std"])
    p.add_argument("--agc", type=float, default=0.0,
                   help="adaptive gradient clipping threshold (per-leaf "
                        "grad/param norm ratio; 0 disables)")
    p.add_argument("--per-leaf-telemetry", action="store_true",
                   help="per-parameter-group vectors (var_max, grad, "
                        "update and param norms per reference leaf)")
    p.add_argument("--slw", action="store_true")
    p.add_argument("--pacing", default="linear",
                   choices=["linear", "root", "two_stage", "variance_gated",
                            "constant"])
    p.add_argument("--start-seq", type=int, default=8)
    p.add_argument("--duration", type=int, default=0)
    p.add_argument("--round-multiple", type=int, default=8)
    p.add_argument("--max-buckets", type=int, default=16)
    p.add_argument("--slw-mode", default="truncate",
                   choices=["truncate", "repack"])
    p.add_argument("--batch-warmup", action="store_true",
                   help="composes with --slw (the paper's joint recipe)")
    p.add_argument("--grad-noise-batch", action="store_true",
                   help="adaptive batch sizing from grad-norm noise")
    p.add_argument("--gns", action="store_true",
                   help="gradient-noise-scale measurement: per-shard grad "
                        "norms in the train step, the B_noise estimate "
                        "and the direction-sketch spike precursor")
    p.add_argument("--gns-shards", type=int, default=4,
                   help="emulated data-parallel shards for the GNS pair "
                        "(the largest divisor of the batch is used)")
    p.add_argument("--gns-batch", action="store_true",
                   help="B_noise-measured batch warmup (critical_batch "
                        "regulator; implies --gns)")
    p.add_argument("--gns-precursor-window", type=int, default=12,
                   help="direction-sketch ring length of the precursor "
                        "(0 disables it)")
    p.add_argument("--gns-headroom", type=float, default=2.0,
                   help="grow the batch while B_noise > headroom * batch")
    p.add_argument("--var-lr-throttle", action="store_true",
                   help="LR backoff while the Adam variance max spikes")
    p.add_argument("--dp-size", type=int, default=1,
                   help="data-parallel size for batch quantization")
    p.add_argument("--remat", default="none",
                   choices=["none", "full", "dots"],
                   help='activation checkpointing of each block: "full" '
                        'recomputes it, "dots" keeps its matmul outputs')
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--eval-interval", type=int, default=50)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-interval", type=int, default=100)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--metrics-jsonl", default="",
                   help="append per-step StepPlan/StepTelemetry rows to "
                        "this JSONL file")
    p.add_argument("--recover", action="store_true",
                   help="divergence-aware recovery: detect NaN, spike and "
                        "variance excursions, roll back to an in-run "
                        "snapshot, intervene (LR backoff -> seq clamp -> "
                        "data skip)")
    p.add_argument("--max-rollbacks", type=int, default=3,
                   help="in-process rollback budget before hard failure")
    p.add_argument("--inject-faults", default="",
                   help="deterministic fault matrix, e.g. "
                        "'nan_grad@12,spike@20:8.0,crash@30:post_tmp,"
                        "stall@8:0.25' (kind@step[:arg], comma-separated)")
    p.add_argument("--inject-seed", type=int, default=0,
                   help="seed for fault placement (which leaf, which byte)")
    args = p.parse_args(argv)

    tc = build_config(args)
    resolve_device(args.device)  # before the drain handlers are installed
    hooks = ([MetricsJsonlHook(args.metrics_jsonl)]
             if args.metrics_jsonl else None)
    recovery = (RecoveryConfig(policy=RetryPolicy(
        max_retries=args.max_rollbacks)) if args.recover else None)
    injector = (FaultInjector.from_cli(args.inject_faults,
                                       seed=args.inject_seed)
                if args.inject_faults else None)
    res = train(tc, resume=args.resume, drain=DrainSignal(), quiet=False,
                dp_size=args.dp_size, hooks=hooks, recovery=recovery,
                fault_injector=injector, device=args.device)
    print(f"\ndone: steps={res.steps} tokens={res.tokens} "
          f"diverged={res.diverged}")
    if res.restored_from_step is not None:
        print(f"resumed from the step-{res.restored_from_step} checkpoint")
    print("stability:", res.tracker_summary)
    print("watchdog:", res.watchdog_summary)
    if tc.gns.enabled:
        print(f"precursor: events={res.precursor_events}")
    if recovery is not None or injector is not None:
        print(f"recovery: rollbacks={res.rollbacks} "
              f"events={res.recovery_events} faults={res.faults_fired}")
    return 0 if not res.diverged else 1


if __name__ == "__main__":
    raise SystemExit(main())
