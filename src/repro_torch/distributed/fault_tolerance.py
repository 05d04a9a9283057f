"""Drain-on-signal, the straggler watchdog and restart supervision (copy
of ``repro/distributed/fault_tolerance.py:30-170``).

* ``DrainSignal`` latches SIGTERM/SIGINT; the loop polls ``should_drain``,
  checkpoints and stops at the next step boundary.
* ``StepWatchdog`` keeps a ring of step wall times and flags a straggler
  when a step exceeds ``factor`` x the rolling median.
* ``TrainSupervisor`` wraps a resumable train function: on an exception
  it records the failure, backs off by its ``RetryPolicy`` and calls the
  function again with ``resume=True``, which restores the last valid
  checkpoint.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


class DrainSignal:
    """Latches SIGTERM/SIGINT; the train loop polls ``should_drain``."""

    def __init__(self, install: bool = True):
        self._flag = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:  # not in the main thread
                    pass

    def _handler(self, signum, frame):
        self._flag = True

    @property
    def should_drain(self) -> bool:
        return self._flag

    def trigger(self) -> None:
        self._flag = True

    def uninstall(self) -> None:
        """Restore the handlers active before installation (idempotent)."""
        for sig, prev in self._prev.items():
            try:
                # == not `is`: each _handler access builds a new bound method
                if signal.getsignal(sig) == self._handler:
                    signal.signal(sig, prev)
            except ValueError:  # not in the main thread
                pass
        self._prev = {}


@dataclass
class StepWatchdog:
    window: int = 64
    factor: float = 3.0
    durations: List[float] = field(default_factory=list)
    straggler_steps: List[int] = field(default_factory=list)
    _t0: Optional[float] = None
    _step: int = 0

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self) -> bool:
        """Record the step; True if it was a straggler.  A ``stop`` without
        a matching ``start`` records nothing."""
        if self._t0 is None:
            return False
        dt = time.monotonic() - self._t0
        self._t0 = None
        self.durations.append(dt)
        self.durations = self.durations[-self.window:]
        self._step += 1
        if len(self.durations) >= 8:
            med = float(np.median(self.durations[:-1]))
            if dt > self.factor * med:
                self.straggler_steps.append(self._step)
                return True
        return False

    def summary(self) -> Dict[str, float]:
        d = np.asarray(self.durations or [0.0])
        return {"step_time_p50": float(np.median(d)),
                "step_time_p95": float(np.percentile(d, 95)),
                "stragglers": len(self.straggler_steps)}


@dataclass(frozen=True)
class RetryPolicy:
    """How many times to retry and how long to wait before each retry: the
    one policy of process-level restarts (:class:`TrainSupervisor`) and
    in-process rollbacks (``core.recovery.RollbackController``), so the two
    layers are budgeted alike."""

    max_retries: int = 3
    backoff_s: float = 0.0       # base sleep before retry 1 (0 = none)
    backoff_factor: float = 2.0  # exponential growth per further retry
    backoff_cap_s: float = 60.0  # ceiling on any single sleep

    def delay(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based)."""
        if self.backoff_s <= 0.0:
            return 0.0
        return min(self.backoff_s * self.backoff_factor ** (attempt - 1),
                   self.backoff_cap_s)


@dataclass
class TrainSupervisor:
    """Retry loop around a resumable train function.

    ``run_fn(resume: bool) -> str`` must restore from the latest checkpoint
    itself when ``resume`` is True.  Retries back off by ``policy`` (the
    ``max_restarts`` / ``backoff_s`` fields seed a default one), and every
    failure is recorded with its wall-clock time and attempt number in
    ``failures``.
    """
    max_restarts: int = 3
    backoff_s: float = 0.0
    restarts: int = 0
    failures: List[Dict] = field(default_factory=list)
    policy: Optional[RetryPolicy] = None

    def run(self, run_fn: Callable[[bool], str]) -> str:
        policy = self.policy or RetryPolicy(max_retries=self.max_restarts,
                                            backoff_s=self.backoff_s)
        resume = False
        while True:
            try:
                return run_fn(resume)
            except Exception as e:  # noqa: BLE001 — supervisor boundary
                self.restarts += 1
                self.failures.append({
                    "error": f"{type(e).__name__}: {e}",
                    "time": time.time(),
                    "attempt": self.restarts,
                })
                if self.restarts > policy.max_retries:
                    raise
                delay = policy.delay(self.restarts)
                if delay:
                    time.sleep(delay)
                resume = True
