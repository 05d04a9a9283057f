"""Drain-on-signal and the straggler watchdog (copy of
``repro/distributed/fault_tolerance.py:30-111``), the two the trainer's
default hooks use.

* ``DrainSignal`` latches SIGTERM/SIGINT; the loop polls ``should_drain``
  and stops at the next step boundary.
* ``StepWatchdog`` keeps a ring of step wall times and flags a straggler
  when a step exceeds ``factor`` x the rolling median.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

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
