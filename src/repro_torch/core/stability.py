"""Stability instrumentation of the paper's analysis (copy of
``repro/core/stability.py:25-107``).

* loss ratio: current-step loss / min previous loss; > 1.2 counts as a
  spike (Table 1).
* Adam variance telemetry: l1 norm and max element of sqrt(v_t)
  (Fig. 1 c-f), plus the momentum l1 norm (A.3.2), reduced on the device.
* Pearson correlation between the loss-ratio series and the variance
  series (Table 3), with the exact t-distribution p-value.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

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

    def state_dict(self) -> Dict[str, Any]:
        return {"min_loss": self.min_loss, "max_ratio": self.max_ratio,
                "n_steps": self.n_steps, "n_spikes": self.n_spikes,
                "spike_threshold": self.spike_threshold}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        for k, v in d.items():
            setattr(self, k, v)


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


def pearson(x: np.ndarray, y: np.ndarray) -> Tuple[float, float]:
    """Pearson r and its two-sided p-value from the exact t distribution,
    ``p = I_{df/(df+t^2)}(df/2, 1/2)``: the regularized incomplete beta of
    ``scipy.special`` in float64 (the reference takes ``jax.scipy``'s in
    float32, up to ~4e-5 relative off).  nan for fewer than 3 points or a
    constant series; p = 0 when |r| = 1."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = x.size
    if n < 3:
        return float("nan"), float("nan")
    xc = x - x.mean()
    yc = y - y.mean()
    denom = np.sqrt((xc * xc).sum() * (yc * yc).sum())
    if denom == 0:
        return float("nan"), float("nan")
    r = float(np.clip((xc * yc).sum() / denom, -1.0, 1.0))
    df = n - 2
    if abs(r) >= 1.0:
        return r, 0.0
    t2 = df * r * r / (1.0 - r * r)
    from scipy.special import betainc
    return r, float(betainc(df / 2.0, 0.5, df / (df + t2)))
