"""Training cells: the program's ``Trainer`` driven step by step.

Set-up builds one ``repro_torch.launch.train.Trainer`` from the cell's
configuration and traffic files, replaces its weights with the benchmark's
(drawn on the device from the seed) and its corpus with the benchmark's
token batches, and runs the traffic's first steps through
``Trainer.run_step``, the call the window drives.  Those steps warm every
shape the window uses; the first ``compare_steps`` of them are what the
reference follows.  The same trainer then runs the window:

* ``"window": "steps"`` - one step is the unit; the window runs steps.
* ``"window": "ramp"`` - one ramp of the sequence-length warmup is the unit:
  when the curriculum reaches full length, the step-0 ``ControllerState``
  is loaded through ``Trainer.load_controller_state``, as a resume would,
  and the ramp runs again on the trained weights.  Set-up runs one ramp.

The window ends after the unit that brings it nearest to ``seconds``.
Every step ends in the trainer's one host transfer of its metrics, so the
host clock at a step's end has waited for its device work.  A traced run
records the window's device activity alone, then traces the traffic's
``traced_units`` further units with the host's operations and shapes
(``bench/harness/profile.py``).

Correctness: once the window has closed and the program's state is freed,
the plain reference (``bench/reference/train.py``) runs the compared steps
from the same weights and batches with its own plan, and the comparison
reads the plan, each step's loss, the first gradient's per-leaf norms (the
program's from its Adam moment after one step) and the per-leaf norms of
the parameters' change after the last compared step.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bench.harness import inputs
from bench.harness.profile import (STEP_SPAN, Trace, reduce_profile,
                                   reduce_timeline)
from bench.reference import train as ref_train
from bench.reference import transformer as tfm

# leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone under Adam and are left out of the change
NOUGHT = 1e-3
# GPU cycles of each marker kernel at the timeline's ends (under 1 us)
MARK_CYCLES = 1000


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------

def model_dict(config: Dict, over: Optional[Dict] = None) -> Dict:
    m = dict(config["model"])
    m.update(over or {})
    return m


def traffic_dict(traffic: Dict, over: Optional[Dict] = None) -> Dict:
    t = copy.deepcopy(traffic)
    for k, v in (over or {}).items():
        if isinstance(v, dict):
            t[k] = {**t[k], **v}
        else:
            t[k] = v
    return t


def train_config(m: Dict, traffic: Dict, remat: str, seed: int):
    """The program's ``TrainConfig`` of a cell."""
    from repro_torch.configs.base import (BatchWarmupConfig, ModelConfig,
                                          OptimizerConfig, SLWConfig,
                                          TrainConfig)
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(m) - fields
    if unknown:
        raise ValueError(f"configuration keys the program lacks: "
                         f"{sorted(unknown)}")
    opt = traffic["optimizer"]
    return TrainConfig(
        model=ModelConfig(**m),
        optimizer=OptimizerConfig(
            lr=opt["lr"], min_lr=opt["min_lr"], beta1=opt["beta1"],
            beta2=opt["beta2"], eps=opt["eps"],
            weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
            schedule=opt["schedule"], warmup_tokens=opt["warmup_tokens"],
            total_tokens=opt["total_tokens"]),
        slw=SLWConfig(**traffic["slw"]),
        batch_warmup=BatchWarmupConfig(enabled=False),
        seq_len=traffic["seq_len"], global_batch=traffic["batch"],
        seed=seed, remat=remat, eval_interval=0, checkpoint_interval=0)


def flat(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"layers.3.attn.wq": tensor, ...}`` of a tree of dicts and
    lists."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(flat(t, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def per_leaf(stacked: Tuple[tfm.Group, torch.Tensor]):
    """(program leaf name, the group's slice of it) of a drawn group."""
    g, t = stacked
    if not g.layered:
        return [(g.name, t)]
    rest = g.name[len("layers."):]
    return [(f"layers.{i}.{rest}", t[i]) for i in range(t.shape[0])]


class Program:
    """A cell's trainer, built and fed by the benchmark."""

    def __init__(self, m: Dict, traffic: Dict, remat: str, seed: int,
                 device: torch.device,
                 hook: Optional[Callable[[Any], None]] = None):
        from repro_torch.data import DataPipeline
        from repro_torch.launch.train import Trainer
        self.m, self.traffic, self.seed, self.device = m, traffic, seed, device
        self.tc = train_config(m, traffic, remat, seed)
        self.trainer = Trainer(self.tc, device=str(device), quiet=True)
        self.groups = tfm.param_groups(m)
        self.corpus = inputs.Corpus(m["vocab_size"], traffic["seq_len"],
                                    seed, traffic["zipf_a"])
        self.trainer.pipeline = DataPipeline(self.corpus, traffic["batch"],
                                             model_cfg=self.tc.model)
        self._load_weights()
        if hook is not None:
            hook(self.trainer)

    def draw(self):
        return inputs.draw(self.groups, self.m["n_layers"], self.seed,
                           self.device)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The full-length host batch of step ``step``: what the program's
        pipeline hands its trainer."""
        rows = self.traffic["batch"]
        return self.corpus.batch(step * rows, rows)

    def _load_weights(self) -> None:
        leaves = flat(self.trainer.state["params"])
        want = set(tfm.leaf_names(self.m))
        if set(leaves) != want:
            raise RuntimeError(
                f"the program's parameters are not the reference's: only "
                f"the program has {sorted(set(leaves) - want)[:5]}, only "
                f"the reference {sorted(want - set(leaves))[:5]}")
        with torch.no_grad():
            for drawn in self.draw():
                for name, t in per_leaf(drawn):
                    if tuple(leaves[name].shape) != tuple(t.shape):
                        raise RuntimeError(
                            f"{name}: the program's shape "
                            f"{tuple(leaves[name].shape)}, the reference's "
                            f"{tuple(t.shape)}")
                    leaves[name].copy_(t)
                del drawn

    def first_steps(self, warm: bool = True) -> Dict:
        """The traffic's set-up steps (only the compared ones unless
        ``warm``); returns the program's readings of the first
        ``compare_steps``: plans, losses, the first gradient's and the
        change's per-leaf norms."""
        tr, n_cmp = self.trainer, self.traffic["compare_steps"]
        b1 = self.tc.optimizer.beta1
        self.cs0 = copy.deepcopy(tr.controller_state())
        plans, losses = [], []
        grad1: Dict[str, float] = {}
        change: Dict[str, float] = {}
        step = 0
        while True:
            post, plan, metrics = tr.run_step()
            step += 1
            if step <= n_cmp:
                plans.append({"seq_len": plan.seq_len,
                              "batch": plan.batch_size, "lr": plan.lr})
                losses.append(float(metrics["loss"]))
            if step == 1:
                moment = flat(tr.state["opt"]["adam"]["m"])
                grad1 = _norms(moment, 1.0 / (1.0 - b1))
            if step == n_cmp:
                change = self._change()
            if step >= n_cmp and (not warm or self._warm(step)):
                break
        if self.traffic["window"] == "ramp":
            tr.load_controller_state(copy.deepcopy(self.cs0))
        return {"plans": plans, "loss": losses, "grad1": grad1,
                "change": change}

    def _warm(self, step: int) -> bool:
        """Whether the set-up steps have run every shape of the window."""
        if self.traffic["window"] == "ramp":
            return self.trainer.stack["seqlen"].curriculum.at_full_length
        return step >= self.traffic["warmup_steps"]

    def _change(self) -> Dict[str, float]:
        leaves = flat(self.trainer.state["params"])
        out: Dict[str, float] = {}
        with torch.no_grad():
            for drawn in self.draw():
                for name, t0 in per_leaf(drawn):
                    out[name] = float((leaves[name] - t0).norm())
                del drawn
        return out

    def free(self) -> None:
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _norms(leaves: Dict[str, torch.Tensor], scale: float
           ) -> Dict[str, float]:
    names = list(leaves)
    norms = torch.stack(torch._foreach_norm([leaves[n] for n in names]))
    return dict(zip(names, (norms.double() * scale).tolist()))


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _units(prog: Program, done: Callable[[float, List[float]], bool],
           span: Callable[[], Any] = contextlib.nullcontext) -> Dict:
    """Units of the traffic until ``done(now, unit_seconds)`` after one:
    ``{"shapes", "unit_seconds", "tokens", "failed"}``."""
    tr = prog.trainer
    ramp = prog.traffic["window"] == "ramp"
    shapes: List[Tuple[int, int]] = []
    units: List[float] = []
    tokens, failed = 0, 0
    unit_start = time.perf_counter()
    while True:
        before = tr.tokens_seen
        with span():
            post, plan, _ = tr.run_step()
        tokens += tr.tokens_seen - before
        shapes.append((plan.batch_size, plan.seq_len))
        failed += 0 if math.isfinite(post.loss) else 1
        unit_done = True
        if ramp:
            unit_done = tr.stack["seqlen"].curriculum.at_full_length
            if unit_done:
                tr.load_controller_state(copy.deepcopy(prog.cs0))
        if unit_done:
            now = time.perf_counter()
            units.append(now - unit_start)
            unit_start = now
            if done(now, units):
                return {"shapes": shapes, "unit_seconds": units,
                        "tokens": tokens, "failed": failed}


def run_window(prog: Program, seconds: float, timeline: bool = False
               ) -> Dict:
    """Units of the traffic until the window is nearest ``seconds``:
    ``{"seconds", "tokens", "shapes", "unit_seconds", "failed",
    "base_bytes", "peak_bytes", "timeline"}``; with ``timeline`` on a card,
    the window's device activity between two marker kernels."""
    dev = prog.device
    cuda = dev.type == "cuda"
    prof = None
    if timeline and cuda:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    try:
        if prof is not None:
            torch.cuda._sleep(MARK_CYCLES)
        t0 = time.perf_counter()
        out = _units(prog, lambda now, units:
                     now - t0 >= seconds - units[-1] / 2)
        _sync(dev)
        t1 = time.perf_counter()
        if prof is not None:
            torch.cuda._sleep(MARK_CYCLES)
            _sync(dev)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    out.update(seconds=t1 - t0, base_bytes=base,
               peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda
               else 0,
               timeline=reduce_timeline(prof) if prof is not None else None)
    return out


def trace_units(prog: Program) -> Trace:
    """The traffic's ``traced_units`` units under ``torch.profiler`` with
    the host's operations and their shapes, each step in a span."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if prog.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n = prog.traffic["traced_units"]
    with profile(activities=acts, record_shapes=True) as prof:
        got = _units(prog, lambda now, units: len(units) >= n,
                     lambda: record_function(STEP_SPAN))
        _sync(prog.device)
    return reduce_profile(prof, got["shapes"])


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def compare(prog: Dict, ref: Dict) -> Tuple[Dict[str, float], Dict]:
    """The numbers a cell may compare, and where each was read:

    * ``plan_mismatch``: steps whose seq_len, batch or lr differ (exact);
    * ``loss_gap``: the largest relative gap of a step's loss;
    * ``grad_gap``, ``change_gap``: the worst leaf's gap of norms (the gap
      over the larger of the reference's norm of that leaf and of its
      median leaf) of the first gradient and of the change; the change
      leaves out leaves whose reference gradient is nought to rounding;
    * ``grad_gap_median``, ``change_gap_median``: the median leaf's gap,
      steady where one small leaf's gap swings (a MoE router's, when a
      near tie in the routing falls the other way on one side).

    A cell's limits file names the numbers it compares."""
    n = max(len(prog["plans"]), len(ref["plans"]))
    mismatch = sum(1 for a, b in zip(prog["plans"], ref["plans"]) if a != b)
    mismatch += n - min(len(prog["plans"]), len(ref["plans"]))
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(prog["loss"], ref["loss"])]
    g1 = ref["grad1"]
    med = float(np.median(list(g1.values())))
    moving = [k for k, v in g1.items() if v >= NOUGHT * med]
    grad = ref_train.gaps(prog["grad1"], g1)
    change = ref_train.gaps(prog["change"], ref["change"], moving)
    worst = lambda d: max(d, key=d.get)
    numbers = {"plan_mismatch": float(mismatch), "loss_gap": max(losses),
               "grad_gap": grad[worst(grad)],
               "change_gap": change[worst(change)],
               "grad_gap_median": float(np.median(list(grad.values()))),
               "change_gap_median": float(np.median(list(change.values())))}
    where = {"loss_step": int(np.argmax(losses)), "grad_leaf": worst(grad),
             "change_leaf": worst(change),
             "left_out_of_change": sorted(set(g1) - set(moving))}
    return numbers, where


def reference(prog: Program, precision: str = "fp32",
              fault: Optional[str] = None) -> Dict:
    return ref_train.run(prog.m, prog.traffic, prog.draw, prog.batch_at,
                         prog.traffic["compare_steps"], prog.device,
                         precision=precision, fault=fault)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", model_over: Optional[Dict] = None,
        traffic_over: Optional[Dict] = None,
        hook: Optional[Callable[[Any], None]] = None) -> Dict:
    """One run of a training cell -> ``{"setup_s", "window", "memory_peak_
    bytes", "checks", "correct", "m"}``; ``checks`` maps each number
    compared to ``(value, limit)``."""
    dev = torch.device(device)
    m = model_dict(cell.config, model_over)
    traffic = traffic_dict(cell.traffic, traffic_over)
    if dev.type == "cuda":
        from repro_torch.kernels._build import build_all
        build_all()
    prog = Program(m, traffic, cell.config["remat"], seed, dev, hook)
    readings = prog.first_steps()
    setup_peak = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else 0)
    setup_s = time.perf_counter() - t_start
    win = run_window(prog, seconds, timeline=trace)
    cuda = dev.type == "cuda"
    # CUPTI now and then hands back a trace with no device activity
    if trace and cuda and not win["timeline"].kernels:
        win = run_window(prog, seconds, timeline=True)
    peak = max(setup_peak, win["peak_bytes"])
    win["trace"] = trace_units(prog) if trace else None
    if trace and cuda and not win["trace"].kernels:
        win["trace"] = trace_units(prog)
    prog.free()
    t_ref = time.perf_counter()
    ref = reference(prog)
    numbers, where = compare(readings, ref)
    where["reference_s"] = time.perf_counter() - t_ref
    where["numbers"] = numbers
    checks = {k: (numbers[k], float(lim))
              for k, lim in cell.limits["limits"].items()}
    correct = all(math.isfinite(v) and v <= lim
                  for v, lim in checks.values())
    return {"setup_s": setup_s, "window": win, "memory_peak_bytes": peak,
            "checks": checks, "correct": correct, "m": m, "where": where,
            "attempted": len(win["shapes"]), "failed": win["failed"]}
