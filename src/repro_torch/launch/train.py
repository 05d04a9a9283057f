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

The loop is the paper's joint recipe: the regulator stack plans the step
(seqlen bucket, batch size, LR, grad-clip scale) -> the full-length host
batch is row-sliced and truncated/repacked -> the train step (loss, its
gradient through the flash-attention, WKV-6 or SSD kernels, the AdamW
chain) -> loss ratio and Adam-variance telemetry go back into the stack.  Eval, drain,
the watchdog and telemetry recording are ``TrainerHook``s.

The device defaults to CUDA and the run fails on a machine without one
unless ``device="cpu"`` / ``--device cpu`` is given.  The initial weights
are drawn by a generator on that device.  Training runs in fp32 with TF32
off, so fp32 means fp32 on the card.  Checkpoints and
``resume``, divergence recovery, fault injection and the GNS precursor are
not ported yet: their options raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.configs.base import (BatchWarmupConfig, OptimizerConfig,
                                      SLWConfig, TrainConfig)
from repro_torch.core.regulators import (RegulatorStack, StepPlan,
                                         StepTelemetry, build_stack)
from repro_torch.core.stability import LossRatioTracker
from repro_torch.data import DataPipeline, SyntheticCorpus
from repro_torch.distributed.fault_tolerance import DrainSignal, StepWatchdog
from repro_torch.kernels import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model_zoo


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
    # distinct batch shapes the loop ran (the reference's jit compiles)
    n_compiles: int = 0


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
    flushed per step."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

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
        if math.isfinite(tele.grad_norm_clipped):
            row["grad_norm_clipped"] = tele.grad_norm_clipped
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
            print(f"step {tr.step} tokens {tr.tokens_seen} "
                  f"loss {tele.loss:.4f} val_ppl {ppl:.2f} "
                  f"seqlen {plan.seq_len} batch {plan.batch_size} "
                  f"lr {plan.lr:.2e}", flush=True)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

class Trainer:
    """Host-side training control plane around the regulator stack.

    Owns the model and optimizer state on ``device``, the data pipeline,
    the regulator stack and the loss-ratio tracker; eval, drain, the
    watchdog and telemetry are hooks.  ``state`` may be replaced before
    ``run`` (``repro_torch.bridge.train_state_from_numpy`` carries a
    reference state over).
    """

    def __init__(self, tc: TrainConfig, *, dp_size: int = 1,
                 eval_batch: int = 8, stop_on_nan: bool = True,
                 drain: Optional[DrainSignal] = None,
                 callback: Optional[Callable[[int, Dict[str, float]],
                                             None]] = None,
                 quiet: bool = True,
                 hooks: Optional[List[TrainerHook]] = None,
                 device: str = "cuda"):
        """``hooks`` are appended after the default set (drain, watchdog,
        telemetry, eval)."""
        if tc.checkpoint_dir:
            raise NotImplementedError("checkpoints (checkpoint_dir) are not "
                                      "ported yet")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # fp32 means fp32: no TF32 in matmuls or convolutions
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.tc = tc
        self.dp_size = max(dp_size, 1)
        self.stop_on_nan = stop_on_nan
        cfg = tc.model
        self.model = model_zoo.build_model(cfg, remat=tc.remat)
        self.state = steps_lib.init_train_state(
            torch.Generator(device=self.device).manual_seed(tc.seed), cfg,
            tc.optimizer, self.device)
        corpus = SyntheticCorpus(vocab_size=cfg.vocab_size,
                                 seq_len=tc.seq_len, seed=tc.seed)
        self.pipeline = DataPipeline(corpus, tc.global_batch)
        self.stack: RegulatorStack = build_stack(
            tc, dp_size=self.dp_size,
            warmup_steps_hint=tc.optimizer.warmup_steps)
        self.tracker = LossRatioTracker()
        self.watchdog = StepWatchdog()
        self.step_fn = steps_lib.make_train_step(self.model, tc.optimizer)

        self.result = TrainResult()
        self.step = 0
        self.tokens_seen = 0
        self.stopping = False
        self._drain_requested = False
        self._last = StepTelemetry()
        self._seen_shapes = set()
        self.hooks: List[TrainerHook] = [
            DrainHook(drain), WatchdogHook(), TelemetryHook(callback),
            EvalHook(eval_batch=eval_batch, quiet=quiet)]
        self.hooks += list(hooks or [])

    def request_drain(self) -> None:
        self._drain_requested = True

    def to_device(self, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.ascontiguousarray(v),
                                   dtype=torch.int64).to(self.device)
                for k, v in batch.items()}

    @torch.no_grad()
    def eval_loss(self, batch: Dict[str, np.ndarray]) -> float:
        return float(self.model.loss(self.state["params"],
                                     self.to_device(batch))[1]["loss"])

    # -- one training step ---------------------------------------------------
    def run_step(self) -> Tuple[StepTelemetry, StepPlan, Dict[str, float]]:
        tele = dataclasses.replace(self._last, step=self.step,
                                   tokens_seen=self.tokens_seen)
        plan = self.stack.plan(tele)
        batch = self.pipeline.batch_at(self.step)
        batch, tokens_step = self.stack.apply(batch, plan)
        shape_key = tuple(sorted((k, v.shape) for k, v in batch.items()))
        if shape_key not in self._seen_shapes:
            self._seen_shapes.add(shape_key)
            self.result.n_compiles += 1
        # the reference hands the step np.float32 scalars
        self.state, out = self.step_fn(
            self.state, self.to_device(batch), float(np.float32(plan.lr)),
            float(np.float32(plan.grad_clip_scale)))
        metrics = {k: float(v) for k, v in out.items()}
        loss = metrics["loss"]
        ratio = (self.tracker.update(loss) if math.isfinite(loss)
                 else float("inf"))
        post = dataclasses.replace(
            tele, loss=loss, loss_ratio=ratio, grad_norm=metrics["grad_norm"],
            grad_norm_clipped=metrics["grad_norm_clipped"],
            var_max=metrics["var_max"], var_l1=metrics["var_l1"])
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
                    self.result.drained = True
                    break
                tele, plan, metrics = self.run_step()
                if not math.isfinite(tele.loss):
                    self.result.diverged = True
                    self.stopping = self.stop_on_nan
                for h in self.hooks:
                    h.on_step_end(self, tele, plan, metrics)
                if self.stopping:
                    break
        except BaseException:
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
          quiet: bool = True, dp_size: int = 1,
          hooks: Optional[List[TrainerHook]] = None,
          device: str = "cuda") -> TrainResult:
    """Run the training loop on ``device``; returns full telemetry."""
    if resume:
        raise NotImplementedError("resume (checkpoints) is not ported yet")
    trainer = Trainer(tc, dp_size=dp_size, eval_batch=eval_batch,
                      stop_on_nan=stop_on_nan, drain=drain, callback=callback,
                      quiet=quiet, hooks=hooks, device=device)
    return trainer.run(max_steps=max_steps)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

# flags of the reference CLI whose features are not ported yet: any value
# but the default raises
NOT_PORTED = {"optimizer": "adamw", "agc": 0.0, "per_leaf_telemetry": False,
              "grad_noise_batch": False, "gns": False, "gns_batch": False,
              "var_lr_throttle": False, "ckpt_dir": "", "resume": False,
              "recover": False, "inject_faults": "", "gns_shards": 4,
              "gns_precursor_window": 12, "gns_headroom": 2.0,
              "ckpt_interval": 100, "max_rollbacks": 3, "inject_seed": 0}


def build_config(args) -> TrainConfig:
    for name, default in NOT_PORTED.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not ported yet")
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
        decay_mask=args.decay_mask)
    bw = BatchWarmupConfig(enabled=args.batch_warmup,
                           start_batch=max(args.batch // 8, 1),
                           warmup_tokens=total_tokens // 20)
    return TrainConfig(model=cfg, optimizer=opt, slw=slw, batch_warmup=bw,
                       seq_len=args.seq, global_batch=args.batch,
                       seed=args.seed, remat=args.remat,
                       eval_interval=args.eval_interval)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="gpt2-117m")
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
                   help="only adamw is ported")
    p.add_argument("--decay-mask", default="all", choices=["all", "std"])
    p.add_argument("--agc", type=float, default=0.0, help="not ported yet")
    p.add_argument("--per-leaf-telemetry", action="store_true",
                   help="not ported yet")
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
                   help="not ported yet")
    p.add_argument("--gns", action="store_true", help="not ported yet")
    p.add_argument("--gns-shards", type=int, default=4,
                   help="not ported yet")
    p.add_argument("--gns-batch", action="store_true", help="not ported yet")
    p.add_argument("--gns-precursor-window", type=int, default=12,
                   help="not ported yet")
    p.add_argument("--gns-headroom", type=float, default=2.0,
                   help="not ported yet")
    p.add_argument("--var-lr-throttle", action="store_true",
                   help="not ported yet")
    p.add_argument("--dp-size", type=int, default=1,
                   help="data-parallel size for batch quantization")
    p.add_argument("--remat", default="none",
                   choices=["none", "full", "dots"],
                   help='"dots" is not ported yet')
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--eval-interval", type=int, default=50)
    p.add_argument("--ckpt-dir", default="", help="not ported yet")
    p.add_argument("--ckpt-interval", type=int, default=100,
                   help="not ported yet")
    p.add_argument("--resume", action="store_true", help="not ported yet")
    p.add_argument("--metrics-jsonl", default="",
                   help="append per-step StepPlan/StepTelemetry rows to "
                        "this JSONL file")
    p.add_argument("--recover", action="store_true", help="not ported yet")
    p.add_argument("--max-rollbacks", type=int, default=3,
                   help="not ported yet")
    p.add_argument("--inject-faults", default="", help="not ported yet")
    p.add_argument("--inject-seed", type=int, default=0,
                   help="not ported yet")
    args = p.parse_args(argv)

    tc = build_config(args)
    resolve_device(args.device)  # before the drain handlers are installed
    hooks = ([MetricsJsonlHook(args.metrics_jsonl)]
             if args.metrics_jsonl else None)
    res = train(tc, drain=DrainSignal(), quiet=False, dp_size=args.dp_size,
                hooks=hooks, device=args.device)
    print(f"\ndone: steps={res.steps} tokens={res.tokens} "
          f"diverged={res.diverged} compiles={res.n_compiles}")
    print("stability:", res.tracker_summary)
    print("watchdog:", res.watchdog_summary)
    return 0 if not res.diverged else 1


if __name__ == "__main__":
    raise SystemExit(main())
