"""Unbiased gradient-noise-scale estimation (McCandlish et al., *An
Empirical Model of Large-Batch Training*); a copy of
``repro/gns/estimator.py:1-160``, host-side numpy.

With ``k`` emulated shards of size ``b = B/k`` the train step emits

    S_small = mean_i |g_i|^2        (per-shard gradients)
    S_big   = |mean_i g_i|^2        (the full-batch gradient)

biased estimates of ``|G|^2 + tr(Sigma)/b`` and ``|G|^2 + tr(Sigma)/B``;
solving the 2x2 system gives the unbiased pair

    |G|^2_est     = (B * S_big - b * S_small) / (B - b)
    tr(Sigma)_est = (S_small - S_big) / (1/b - 1/B)

and ``B_noise = tr(Sigma) / |G|^2``.  Numerator and denominator are
EMA-smoothed separately (the per-step estimates are noisy and may go
negative; their ratio of EMAs is the stable quantity).  Everything works
elementwise, so the same class smooths the global scalars and the
per-leaf ``(n_leaves,)`` vectors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

ArrayLike = Union[float, np.ndarray]


def gns_estimates(small_sq: ArrayLike, big_sq: ArrayLike,
                  b_small: float, b_big: float
                  ) -> Tuple[ArrayLike, ArrayLike]:
    """The unbiased ``(|G|^2, tr(Sigma))`` pair from one step's norms.

    Elementwise — scalars in, scalars out; ``(n_leaves,)`` vectors in,
    vectors out.  Requires ``b_big > b_small`` (the train step only emits
    the pair when it realized >= 2 shards).
    """
    small_sq = np.asarray(small_sq, np.float64)
    big_sq = np.asarray(big_sq, np.float64)
    g_sq = (b_big * big_sq - b_small * small_sq) / (b_big - b_small)
    tr_sigma = (small_sq - big_sq) / (1.0 / b_small - 1.0 / b_big)
    return g_sq, tr_sigma


class GNSEstimator:
    """EMA-smoothed noise-scale estimate + the derived efficiency curve.

    ``update`` takes one step's ``(S_small, S_big, b, B)`` observation
    (scalars or per-leaf vectors — the state adapts to whichever shape it
    is fed, and a shape change resets the EMAs).  ``b_noise`` is the
    smoothed ``tr(Sigma)/|G|^2``; :meth:`efficiency` is the per-step
    progress ratio ``1 / (1 + B_noise/B)`` — the diminishing-returns curve
    a batch-size schedule should ride (critical batch == B_noise: the
    point where doubling the batch stops halving the steps needed).

    ``state_dict``/``load_state_dict`` round-trip through the regulator's
    slice of ``ControllerState``, so a mid-warmup restore resumes the
    smoothed estimate exactly.
    """

    def __init__(self, ema_window: int = 32, warmup_obs: int = 8):
        self.alpha = 2.0 / (max(ema_window, 1) + 1.0)
        self.warmup_obs = max(warmup_obs, 1)
        self.ema_g_sq: Optional[np.ndarray] = None
        self.ema_tr: Optional[np.ndarray] = None
        self.n_obs = 0

    def update(self, small_sq: ArrayLike, big_sq: ArrayLike,
               b_small: float, b_big: float) -> None:
        if b_big <= b_small or b_small <= 0:
            return
        g_sq, tr = gns_estimates(small_sq, big_sq, b_small, b_big)
        g_sq = np.atleast_1d(np.asarray(g_sq, np.float64))
        tr = np.atleast_1d(np.asarray(tr, np.float64))
        if not (np.all(np.isfinite(g_sq)) and np.all(np.isfinite(tr))):
            return
        if self.ema_g_sq is None or self.ema_g_sq.shape != g_sq.shape:
            self.ema_g_sq, self.ema_tr = g_sq.copy(), tr.copy()
            self.n_obs = 1
            return
        a = self.alpha
        self.ema_g_sq = (1 - a) * self.ema_g_sq + a * g_sq
        self.ema_tr = (1 - a) * self.ema_tr + a * tr
        self.n_obs += 1

    # -- derived quantities --------------------------------------------------
    @property
    def ready(self) -> bool:
        return self.n_obs >= self.warmup_obs

    def _ratio(self) -> np.ndarray:
        """tr(Sigma)/|G|^2 elementwise; +inf where the signal has vanished
        (|G|^2 EMA <= 0 — pure noise, no batch is big enough)."""
        assert self.ema_g_sq is not None and self.ema_tr is not None
        tr = np.maximum(self.ema_tr, 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.where(self.ema_g_sq > 0.0, tr / self.ema_g_sq, np.inf)
        return r

    @property
    def b_noise(self) -> float:
        """The smoothed global noise scale (NaN before any observation).
        When fed per-leaf vectors, recomposes the global ratio as
        ``sum(tr_leaf) / sum(g_sq_leaf)``."""
        if self.ema_g_sq is None:
            return float("nan")
        if self.ema_g_sq.shape == (1,):
            return float(self._ratio()[0])
        g_sq = float(np.sum(self.ema_g_sq))
        tr = float(np.sum(np.maximum(self.ema_tr, 0.0)))
        return tr / g_sq if g_sq > 0.0 else float("inf")

    @property
    def leaf_b_noise(self) -> Optional[np.ndarray]:
        """Per-leaf noise-scale vector when fed per-leaf norms, else None."""
        if self.ema_g_sq is None or self.ema_g_sq.shape == (1,):
            return None
        return self._ratio()

    def critical_batch(self) -> float:
        """McCandlish et al.'s B_crit ~= B_noise: the batch size where the
        compute/time tradeoff turns — below it, growing the batch is nearly
        free in compute; above it, returns diminish linearly."""
        return self.b_noise

    def efficiency(self, batch: float) -> float:
        """Per-step progress at ``batch`` relative to the infinite-batch
        step: ``delta L(B) / delta L_max = 1 / (1 + B_noise/B)``."""
        bn = self.b_noise
        if not np.isfinite(bn) or batch <= 0:
            return float("nan")
        return 1.0 / (1.0 + bn / batch)

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "n_obs": self.n_obs,
            "ema_g_sq": (None if self.ema_g_sq is None
                         else self.ema_g_sq.tolist()),
            "ema_tr": (None if self.ema_tr is None
                       else self.ema_tr.tolist()),
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.n_obs = int(d.get("n_obs", 0))
        g, t = d.get("ema_g_sq"), d.get("ema_tr")
        self.ema_g_sq = None if g is None else np.asarray(g, np.float64)
        self.ema_tr = None if t is None else np.asarray(t, np.float64)
