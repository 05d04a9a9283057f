"""Gradient-noise-scale subsystem (``repro/gns``): the measured critical
batch size and the pre-spike precursor on the per-leaf telemetry.

* :mod:`repro_torch.gns.estimator` — the unbiased ``B_noise =
  tr(Sigma)/|G|^2`` from the train step's per-shard / full-batch gradient
  norm pair, EMA-smoothed, with the critical batch and efficiency curve.
* :mod:`repro_torch.gns.precursor` — random-sign sketches of per-leaf
  gradient directions in a short ring; a rising lagged autocorrelation
  is an early warning.
* :mod:`repro_torch.gns.regulator` — ``CriticalBatchRegulator``: batch
  warmup driven by the measured noise scale.
"""
from repro_torch.gns.estimator import GNSEstimator, gns_estimates
from repro_torch.gns.precursor import (GradientPrecursor, PrecursorEvent,
                                       PrecursorHook)
from repro_torch.gns.regulator import CriticalBatchRegulator

__all__ = [
    "GNSEstimator", "gns_estimates",
    "GradientPrecursor", "PrecursorEvent", "PrecursorHook",
    "CriticalBatchRegulator",
]
