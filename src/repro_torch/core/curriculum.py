"""SLW curriculum (copy of ``repro/core/curriculum.py:36-140``, text only).

``apply_seqlen`` cuts a full-length host batch to the step's length:
``truncate`` (paper-faithful) keeps the first ``s_t`` tokens of each
sequence; ``repack`` reshapes ``(B, S) -> (B * S // s_t, s_t)`` so no token
is dropped.  ``SLWCurriculum`` holds the pacing state (step, tokens seen,
the variance gate's level).  numpy only.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from repro_torch.configs.base import SLWConfig
from repro_torch.core import pacing

SEQ_KEYS = ("tokens", "labels", "loss_mask")


@dataclass
class CurriculumState:
    step: int = 0
    tokens_seen: int = 0
    gate_level: int = 0  # index into the bucket ladder (variance_gated)
    var_trailing: float = 0.0  # trailing mean of the Adam variance max


def apply_seqlen(batch: Dict[str, np.ndarray], s_t: int,
                 mode: str = "truncate") -> Tuple[Dict[str, np.ndarray], int]:
    """Apply sequence length ``s_t`` to a host batch; returns (batch,
    tokens of the step)."""
    seq_keys = [k for k in SEQ_KEYS if k in batch]
    full = batch[seq_keys[0]].shape[1]
    s_t = min(s_t, full)
    out = dict(batch)
    if mode == "truncate" or s_t == full:
        for k in seq_keys:
            out[k] = batch[k][:, :s_t]
    elif mode == "repack":
        folds = full // s_t
        for k in seq_keys:
            v = batch[k][:, :folds * s_t]
            out[k] = v.reshape((v.shape[0] * folds, s_t) + v.shape[2:])
    else:
        raise ValueError(f"unknown SLW mode {mode!r}")
    return out, int(np.prod(out[seq_keys[0]].shape[:2]))


class SLWCurriculum:
    def __init__(self, cfg: SLWConfig, full_seq: int,
                 warmup_steps_hint: int = 0):
        self.cfg = cfg
        self.full_seq = full_seq
        self.warmup_steps_hint = warmup_steps_hint
        self.ladder = pacing.bucket_ladder(cfg, full_seq)
        self.state = CurriculumState()

    def seqlen_for_step(self) -> int:
        step = self.state.step
        envelope = pacing.seqlen_at(self.cfg, step, self.full_seq,
                                    self.warmup_steps_hint, self.ladder)
        if self.cfg.enabled and self.cfg.pacing == "variance_gated":
            gated = self.ladder[min(self.state.gate_level,
                                    len(self.ladder) - 1)]
            return min(envelope, gated) if step else min(envelope,
                                                         self.ladder[0])
        return envelope

    def observe(self, var_max: float) -> None:
        """variance_gated pacing: climb the ladder only while the Adam
        variance max stays below gate x its trailing mean."""
        st = self.state
        if st.var_trailing == 0.0:
            st.var_trailing = var_max
        ok = var_max <= self.cfg.variance_gate * st.var_trailing
        st.var_trailing = 0.9 * st.var_trailing + 0.1 * var_max
        if ok and st.gate_level < len(self.ladder) - 1:
            st.gate_level += 1

    def step_complete(self, tokens_this_step: int) -> None:
        self.state.step += 1
        self.state.tokens_seen += tokens_this_step

    def state_dict(self) -> Dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: Dict) -> None:
        self.state = CurriculumState(**d)
