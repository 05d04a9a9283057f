"""B_noise-measured batch warmup: the ``critical_batch`` regulator kind
(copy of ``repro/gns/regulator.py:1-85``).

Warmup advances while the measured ``B_noise > headroom * batch`` (noise
dominates: a bigger batch converts almost 1:1 into fewer steps) and holds
once that headroom is gone.  It composes on the ``RegulatorStack`` like the
other batch regulators (fold by min, monotone, quantized to the
data-parallel size) and checkpoints the estimator's EMAs through its
``ControllerState`` slice, so a mid-warmup restore resumes the batch and
the smoothed measurement exactly.
"""
from __future__ import annotations

import math
from typing import Any, Dict

from repro_torch.configs.base import GNSConfig
from repro_torch.core.batch_warmup import quantize_batch
from repro_torch.core.regulators import Regulator, StepPlan, StepTelemetry
from repro_torch.gns.estimator import GNSEstimator


class CriticalBatchRegulator(Regulator):
    """Batch warmup driven by the measured gradient noise scale."""

    name = "critical_batch"

    def __init__(self, cfg: GNSConfig, full_batch: int, dp_size: int = 1):
        self.cfg = cfg
        self.full_batch = full_batch
        self.dp_size = max(dp_size, 1)
        # floor of 2 rows: the estimator needs >= 2 emulated shards to
        # produce a (small, big) norm pair — a 1-row warmup batch would
        # never measure anything and so never grow
        self.batch = self._quantize(
            max(cfg.min_batch or full_batch // 8, 2))
        self.est = GNSEstimator(ema_window=cfg.ema_window,
                                warmup_obs=cfg.warmup_obs)

    def _quantize(self, b: float) -> int:
        return quantize_batch(b, self.dp_size, self.dp_size, self.full_batch)

    def plan(self, tele: StepTelemetry, plan: StepPlan) -> StepPlan:
        plan.batch_size = min(plan.batch_size, self.batch)
        return plan

    def observe(self, tele: StepTelemetry, tokens_step: int) -> None:
        # per-leaf vectors preferred (the global ratio recomposes from
        # them and the leaf breakdown rides along for free); the scalar
        # pair is the fallback when per-leaf telemetry is off
        if tele.per_leaf is not None \
                and "gns_small_sq" in tele.per_leaf \
                and "gns_big_sq" in tele.per_leaf \
                and math.isfinite(tele.gns_b_small):
            self.est.update(tele.per_leaf["gns_small_sq"],
                            tele.per_leaf["gns_big_sq"],
                            tele.gns_b_small, tele.gns_b_big)
        elif math.isfinite(tele.gns_small_sq) \
                and math.isfinite(tele.gns_big_sq) \
                and math.isfinite(tele.gns_b_small):
            self.est.update(tele.gns_small_sq, tele.gns_big_sq,
                            tele.gns_b_small, tele.gns_b_big)
        if not self.est.ready or self.batch >= self.full_batch:
            return
        b_noise = self.est.b_noise
        if math.isfinite(b_noise) or b_noise == float("inf"):
            if b_noise > self.cfg.headroom * self.batch:
                self.batch = self._quantize(
                    max(self.batch * self.cfg.growth,
                        self.batch + self.dp_size))

    def state_dict(self) -> Dict[str, Any]:
        return {"batch": self.batch, "est": self.est.state_dict()}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.batch = int(d["batch"])
        self.est.load_state_dict(dict(d.get("est", {})))
