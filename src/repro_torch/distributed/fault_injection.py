"""Deterministic, seedable fault injection for the recovery paths (copy of
``repro/distributed/fault_injection.py:1-271``).

Every recovery mechanism (divergence rollback, checkpoint quarantine,
supervisor restart, watchdog stragglers) is exercised by *injected*
faults: the :class:`FaultInjector` holds a step-indexed list of
:class:`FaultSpec` entries and fires each one exactly once, with all
randomness (which parameter element to poison, which byte to flip) drawn
from numpy's ``RandomState`` seeded by ``seed`` and the fault's step, as
in the reference, so both packages corrupt the same element, leaf and
byte.

Fault kinds (CLI syntax ``kind@step[:arg]``, comma-separated):

* ``nan_grad@12``       — poison one parameter element with NaN before step
                          12; the forward and backward then produce a NaN
                          loss and gradients.
* ``spike@20:8.0``      — scale all parameters by ``arg`` (default 8.0)
                          before step 20: a finite loss explosion.
* ``stall@8:0.25``      — sleep ``arg`` seconds before step 8 (a straggler
                          for the ``StepWatchdog``).
* ``grad_spike@15:64|attn`` — scale the raw gradients of every parameter
                          group whose label contains ``attn`` by 64 for
                          step 15 only (``factor|leaf_substr``; an empty
                          substring, or one that matches nothing, picks
                          one group from the seed).
* ``crash@30:post_tmp`` — raise :class:`InjectedCrash` inside the
                          checkpoint writer at step 30, at ``post_tmp``
                          (payload and manifest written, before the atomic
                          rename) or ``post_rename`` (after it).

Checkpoint payload corruption is a storage fault, injected directly with
:meth:`FaultInjector.corrupt_checkpoint` (one deterministic bit flipped in
one payload file).

The port keeps each stacked parameter of the reference as a list of
per-layer tensors.  :meth:`FaultInjector.poison_params` draws over the
reference's leaves and their stacked sizes (``core.telemetry.leaf_groups``)
and maps the flat index onto (layer, offset) (the bridge stacks along axis
0 and never transposes), then writes the NaN in place on the device.
:meth:`FaultInjector.scale_params` multiplies the params in place.

Wiring: ``FaultInjectionHook`` mutates the trainer at ``on_step_start``
(a duck-typed ``TrainerHook``); the crash points are armed module-wide
(:func:`arm` / :func:`disarm`) because the checkpoint writer has no
injector handle: ``repro_torch.checkpoint`` calls
:func:`checkpoint_crash_point` at its two rename boundaries, a no-op
unless an armed spec matches.
"""
from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

KINDS = ("nan_grad", "spike", "grad_spike", "stall", "crash")
CRASH_POINTS = ("post_tmp", "post_rename")


class InjectedCrash(RuntimeError):
    """A deliberate, test-only process death (caught by supervisors)."""


@dataclass(frozen=True)
class FaultSpec:
    kind: str   # one of KINDS (or "bitflip", the storage fault's seed)
    step: int
    arg: str = ""

    def __str__(self) -> str:
        return f"{self.kind}@{self.step}" + (f":{self.arg}" if self.arg
                                             else "")


def parse_faults(spec: str) -> Tuple[FaultSpec, ...]:
    """Parse the CLI syntax: ``"nan_grad@12,spike@20:8.0,crash@30:post_tmp"``.

    Raises ValueError on unknown kinds, malformed entries, or a crash point
    that the checkpoint writer does not define.
    """
    out: List[FaultSpec] = []
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        m = re.fullmatch(r"([a-z_]+)@(\d+)(?::([^,]+))?", entry)
        if not m:
            raise ValueError(f"malformed fault spec {entry!r} "
                             f"(want kind@step[:arg])")
        kind, step, arg = m.group(1), int(m.group(2)), m.group(3) or ""
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (one of {KINDS})")
        if kind == "crash" and arg and arg not in CRASH_POINTS:
            raise ValueError(f"unknown crash point {arg!r} "
                             f"(one of {CRASH_POINTS})")
        out.append(FaultSpec(kind, step, arg))
    return tuple(out)


class FaultInjector:
    """Fires each spec exactly once, deterministically.

    After a rollback the trainer runs the faulted step index again; a fault
    that fired again would make every recovery a failure.  Transient
    faults are the model here; persistent ones are what the retry budget
    is for.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs = tuple(specs)
        self.seed = seed
        self.fired: List[str] = []
        self._done = set()

    @classmethod
    def from_cli(cls, spec: str, seed: int = 0) -> "FaultInjector":
        return cls(parse_faults(spec), seed=seed)

    def _rng(self, spec: FaultSpec) -> np.random.RandomState:
        return np.random.RandomState((self.seed * 1_000_003 + spec.step)
                                     % (2 ** 31 - 1))

    def _take(self, kind: str, step: int) -> Optional[FaultSpec]:
        for i, s in enumerate(self.specs):
            if i not in self._done and s.kind == kind and s.step == step:
                self._done.add(i)
                self.fired.append(str(s))
                return s
        return None

    # -- step-indexed faults (before the step is planned) --------------------
    def pre_step(self, trainer) -> None:
        """Apply any fault scheduled for ``trainer.step`` (the parameter
        faults write ``trainer.state`` in place)."""
        step = trainer.step
        s = self._take("stall", step)
        if s is not None:
            time.sleep(float(s.arg or 0.25))
        s = self._take("nan_grad", step)
        if s is not None:
            trainer.state = self.poison_params(trainer.state, step)
        s = self._take("spike", step)
        if s is not None:
            trainer.state = self.scale_params(trainer.state, step,
                                              float(s.arg or 8.0))
        s = self._take("grad_spike", step)
        if s is not None:
            factor, _, substr = (s.arg or "64").partition("|")
            trainer._pending_grad_fault = (float(factor or 64.0), substr)

    def grad_scale_vector(self, labels: Sequence[str], step: int,
                          factor: float, substr: str) -> np.ndarray:
        """(n_leaves,) multiplier vector for a ``grad_spike``: ``factor`` on
        every leaf whose label contains ``substr`` (one leaf drawn from the
        seed when the substring is empty or matches nothing)."""
        scale = np.ones(len(labels), np.float32)
        hit = [i for i, lb in enumerate(labels) if substr and substr in lb]
        if not hit:
            rng = self._rng(FaultSpec("grad_spike", step))
            hit = [rng.randint(len(labels))]
        scale[hit] = factor
        return scale

    @staticmethod
    def poison_target(params: Any, rng: np.random.RandomState
                      ) -> Tuple[str, int, int, int]:
        """``(label, flat index in the reference's stacked leaf, port leaf
        index, offset in that leaf)`` of the element a ``nan_grad`` draws:
        the reference's draws over its stacked float leaves."""
        from repro_torch.core.telemetry import leaf_groups
        from repro_torch.optim.transforms import tree_leaves
        leaves = tree_leaves(params)
        groups = leaf_groups(params)
        float_idx = [g for g, m in enumerate(groups.members)
                     if leaves[m[0]].dtype.is_floating_point]
        g = float_idx[rng.randint(len(float_idx))]
        size = int(np.prod(groups.stacked_shape(leaves, g)))
        flat = rng.randint(size)
        per_layer = leaves[groups.members[g][0]].numel()
        layer, offset = divmod(flat, per_layer)
        return groups.labels[g], flat, groups.members[g][layer], offset

    def poison_params(self, state: Any, step: int) -> Any:
        """NaN one deterministically-chosen parameter element, in place."""
        from repro_torch.optim.transforms import tree_leaves
        rng = self._rng(FaultSpec("nan_grad", step))
        _, _, leaf, offset = self.poison_target(state["params"], rng)
        with torch.no_grad():
            tree_leaves(state["params"])[leaf].view(-1)[offset] = float("nan")
        return state

    def scale_params(self, state: Any, step: int, factor: float) -> Any:
        """Multiply every parameter by ``factor``, in place (a finite loss
        explosion); the optimizer state is untouched."""
        from repro_torch.optim.transforms import tree_leaves
        with torch.no_grad():
            torch._foreach_mul_(tree_leaves(state["params"]), factor)
        return state

    # -- checkpoint crash points ---------------------------------------------
    def maybe_crash(self, point: str, step: int) -> None:
        for i, s in enumerate(self.specs):
            if i in self._done or s.kind != "crash" or s.step != step:
                continue
            if (s.arg or "post_tmp") == point:
                self._done.add(i)
                self.fired.append(str(s))
                raise InjectedCrash(f"injected crash at checkpoint "
                                    f"{point} (step {step})")

    # -- storage faults ------------------------------------------------------
    def corrupt_checkpoint(self, directory: str,
                           step: Optional[int] = None) -> str:
        """Flip one deterministic bit in one payload file of checkpoint
        ``step`` (newest if None).  Returns the corrupted file's path."""
        from repro_torch.checkpoint import latest_step
        if step is None:
            step = latest_step(directory)
        if step is None:
            raise ValueError(f"no checkpoint to corrupt in {directory}")
        path = os.path.join(directory, f"step_{step:012d}")
        payloads = sorted(n for n in os.listdir(path) if n.endswith(".npy"))
        rng = self._rng(FaultSpec("bitflip", step))
        target = os.path.join(path, payloads[rng.randint(len(payloads))])
        with open(target, "r+b") as f:
            data = bytearray(f.read())
            # a bit in the back half: inside the array payload, past the
            # .npy header, so np.load still parses and the checksum has to
            # catch it
            pos = len(data) // 2 + rng.randint(max(len(data) // 2, 1))
            pos = min(pos, len(data) - 1)
            data[pos] ^= 1 << rng.randint(8)
            f.seek(0)
            f.write(data)
        self.fired.append(f"bitflip@{step}:{os.path.basename(target)}")
        return target


class FaultInjectionHook:
    """Duck-typed TrainerHook applying step-indexed faults before the plan
    is made (so the injected state is what the step consumes)."""

    def __init__(self, injector: FaultInjector):
        self.injector = injector

    def on_run_start(self, tr) -> None:
        arm(self.injector)

    def on_step_start(self, tr) -> None:
        self.injector.pre_step(tr)

    def on_step_end(self, tr, tele, plan, metrics) -> None:
        pass

    def on_run_end(self, tr) -> None:
        tr.result.faults_fired = list(self.injector.fired)

    def close(self) -> None:
        disarm()


# ---------------------------------------------------------------------------
# module-level arming for the checkpoint crash points
# ---------------------------------------------------------------------------

_armed: Optional[FaultInjector] = None


def arm(injector: FaultInjector) -> None:
    global _armed
    _armed = injector


def disarm() -> None:
    global _armed
    _armed = None


def checkpoint_crash_point(point: str, step: int) -> None:
    """Called by ``repro_torch.checkpoint`` at its rename boundaries; a
    no-op unless an injector with a matching ``crash@step:point`` spec is
    armed."""
    if _armed is not None:
        _armed.maybe_crash(point, step)
