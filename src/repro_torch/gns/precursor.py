"""Pre-spike forecasting from per-leaf gradient-direction sketches (copy of
``repro/gns/precursor.py:1-178``).

A loss spike is preceded by a layer's gradient direction repeating step
over step (Molybog et al.): its Adam ``v`` blew up, its update shrank and
its parameters froze.  The train step emits a ``(n_leaves, d)``
random-sign bucket sketch of each leaf's gradient (an unbiased
inner-product sketch at O(n) compute and O(d) memory);
:class:`GradientPrecursor` keeps the last ``window`` row-normalized
sketches and fires a :class:`PrecursorEvent` when a leaf's mean lagged
autocorrelation exceeds an absolute gate AND has risen over its own
trailing baseline.  :class:`PrecursorHook` records each event on
``TrainResult.precursor_events`` and, with recovery on, hands it to the
rollback controller (``core.recovery``: a snapshot now and a temporary LR
cool-down).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import GNSConfig


@dataclass(frozen=True)
class PrecursorEvent:
    """One early warning: which leaf, how correlated, vs what baseline."""

    step: int
    leaf: str
    score: float      # mean lagged autocorrelation of the hot leaf
    baseline: float   # that leaf's trailing score before the excursion

    def __str__(self) -> str:
        return (f"precursor@{self.step}(leaf={self.leaf} "
                f"corr={self.score:.2f} trail={self.baseline:.2f})")


class GradientPrecursor:
    """Ring of row-normalized sketches + per-leaf lagged autocorrelation.

    Memory is bounded at ``window x n_leaves x d`` floats.  During the
    grace period the trailing per-leaf score EMA always advances — the
    grace window *defines* each leaf's baseline, which matters because
    some leaves (positional embeddings under a fixed-format corpus) are
    legitimately direction-correlated every step and must be absorbed,
    not fired on.  After grace it advances only on calm steps (same
    rationale as the detector's trailing var mean: the baseline must not
    chase the excursion it gates).  A fired event starts a refire
    cooldown so one sustained excursion produces one event, not a stream.
    """

    def __init__(self, cfg: GNSConfig):
        self.cfg = cfg
        self.window = max(cfg.precursor_window, cfg.precursor_lags + 1)
        self.ring: Deque[np.ndarray] = deque(maxlen=self.window)
        self.trailing: Optional[np.ndarray] = None
        self.n_scores = 0
        self.cooldown = 0
        self.last_scores: Optional[np.ndarray] = None

    def _scores(self, unit: np.ndarray) -> Optional[np.ndarray]:
        """Mean over lags 1..L of the per-leaf direction autocorrelation
        between the current sketch and the ring (None until filled)."""
        lags = self.cfg.precursor_lags
        if len(self.ring) < lags:
            return None
        acc = np.zeros(unit.shape[0], np.float64)
        for lag in range(1, lags + 1):
            acc += np.sum(unit * self.ring[-lag], axis=1)
        return acc / lags

    def observe(self, step: int, sketch: np.ndarray,
                labels: Tuple[str, ...]) -> Optional[PrecursorEvent]:
        sk = np.asarray(sketch, np.float64)
        if sk.ndim != 2 or not np.all(np.isfinite(sk)):
            # a NaN step poisons direction history; start over
            self.ring.clear()
            return None
        norms = np.linalg.norm(sk, axis=1, keepdims=True)
        unit = sk / np.maximum(norms, 1e-30)

        event: Optional[PrecursorEvent] = None
        scores = self._scores(unit)
        if scores is not None:
            self.last_scores = scores
            if self.trailing is None or self.trailing.shape != scores.shape:
                self.trailing = scores.copy()
            else:
                self.n_scores += 1
                in_grace = self.n_scores <= self.cfg.precursor_grace
                # hot = above the absolute gate AND risen over the leaf's
                # own baseline.  The rise term is additive — scores are
                # bounded cosines, so a multiplicative baseline gate
                # would be unreachable for leaves whose ambient
                # correlation is already moderate
                hot = (scores > self.cfg.precursor_gate) \
                    & (scores - self.trailing > self.cfg.precursor_rise)
                if self.cooldown > 0:
                    self.cooldown -= 1
                elif not in_grace and bool(np.any(hot)):
                    margin = np.where(hot, scores - self.trailing, -np.inf)
                    i = int(np.argmax(margin))
                    leaf = (labels[i] if i < len(labels)
                            else f"leaf_{i}")
                    event = PrecursorEvent(
                        step=step, leaf=leaf, score=float(scores[i]),
                        baseline=float(self.trailing[i]))
                    self.cooldown = self.cfg.precursor_cooldown_steps
                if in_grace or (event is None and not bool(np.any(hot))):
                    # grace defines the baseline; afterwards only calm
                    # steps advance it
                    self.trailing = 0.9 * self.trailing + 0.1 * scores
        self.ring.append(unit)
        return event


class PrecursorHook:
    """Trainer wiring (a duck-typed ``TrainerHook``).

    Feeds the precursor from the per-leaf sketch riding
    ``StepTelemetry.per_leaf`` and records each event on
    ``TrainResult.precursor_events``.  A ``controller`` (the trainer's
    ``core.recovery.RollbackController`` when recovery is on, else
    ``None``) also gets the event through ``handle_precursor``.
    """

    def __init__(self, precursor: GradientPrecursor, controller=None,
                 cool: Tuple[float, int] = (0.5, 8)):
        self.precursor = precursor
        self.controller = controller
        self.cool = cool

    def on_run_start(self, tr) -> None:
        pass

    def on_step_start(self, tr) -> None:
        pass

    def on_step_end(self, tr, tele, plan, metrics: Dict[str, Any]) -> None:
        if tele.per_leaf is None:
            return
        sketch = tele.per_leaf.get("gns_sketch")
        if sketch is None:
            return
        event = self.precursor.observe(tele.step, sketch, tele.leaf_labels)
        if event is None:
            return
        tr.result.precursor_events.append(str(event))
        if self.controller is not None:
            self.controller.handle_precursor(tr, event,
                                             factor=self.cool[0],
                                             ttl=self.cool[1])

    def on_run_end(self, tr) -> None:
        pass

    def close(self) -> None:
        pass
