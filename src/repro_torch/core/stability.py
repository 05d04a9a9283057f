"""Stability instrumentation of the paper's analysis (copy of
``repro/core/stability.py:25-86``).

* loss ratio: current-step loss / min previous loss; > 1.2 counts as a
  spike (Table 1).
* Adam variance telemetry: l1 norm and max element of sqrt(v_t)
  (Fig. 1 c-f), plus the momentum l1 norm (A.3.2), reduced on the device.

``pearson`` (Table 3) is not ported yet: the reference computes its
p-value with ``jax.scipy``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import torch


@dataclass
class LossRatioTracker:
    spike_threshold: float = 1.2
    min_loss: float = float("inf")
    max_ratio: float = 0.0
    n_steps: int = 0
    n_spikes: int = 0
    ratios: List[float] = field(default_factory=list)

    def update(self, loss: float) -> float:
        """The loss ratio of this step (1.0 on the first step)."""
        ratio = loss / self.min_loss if np.isfinite(self.min_loss) else 1.0
        self.ratios.append(ratio)
        self.n_steps += 1
        if ratio > self.spike_threshold:
            self.n_spikes += 1
        self.max_ratio = max(self.max_ratio, ratio)
        self.min_loss = min(self.min_loss, loss)
        return ratio

    def summary(self) -> Dict[str, float]:
        return {"steps": self.n_steps, "spikes": self.n_spikes,
                "spike_frac": self.n_spikes / max(self.n_steps, 1),
                "max_loss_ratio": self.max_ratio}


def variance_stats(v_leaves: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """l1 norm and max element of sqrt(v_t) over all leaves (0-dim fp32
    tensors on the leaves' device; sqrt(v) >= 0, so its l1 and inf norms
    are its sum and its max)."""
    roots = torch._foreach_sqrt([v.float() for v in v_leaves])
    return {"var_l1": torch.stack(torch._foreach_norm(roots, 1)).sum(),
            "var_max": torch.stack(torch._foreach_norm(roots, float("inf")))
            .max()}


def momentum_stats(m_leaves: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"mom_l1": torch.stack(torch._foreach_norm(
        [m.float() for m in m_leaves], 1)).sum()}
