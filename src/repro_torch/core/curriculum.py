"""SLW curriculum (copy of ``repro/core/curriculum.py:36-140``).

``apply_seqlen`` cuts a full-length host batch to the step's length:
``truncate`` (paper-faithful) keeps the first ``s_t`` tokens of each
sequence; ``repack`` reshapes ``(B, S) -> (B * S // s_t, s_t)`` so no token
is dropped.  Audio ``frames`` are cut with the tokens; a vision patch
prefix (``patch_embeds``) is never cut (SLW warms up only the text) and is
repeated per fold when repacking.  ``SLWCurriculum`` holds the pacing state
(step, tokens seen, the variance gate's level) and paces the text segment,
``full_seq - prefix_tokens``.  numpy only.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import SLWConfig
from repro_torch.core import pacing

SEQ_KEYS = ("tokens", "labels", "loss_mask", "frames")


@dataclass
class CurriculumState:
    step: int = 0
    tokens_seen: int = 0
    gate_level: int = 0  # index into the bucket ladder (variance_gated)
    var_trailing: float = 0.0  # trailing mean of the Adam variance max


def apply_seqlen(batch: Dict[str, np.ndarray], s_t: int,
                 mode: str = "truncate") -> Tuple[Dict[str, np.ndarray], int]:
    """Apply sequence length ``s_t`` to a host batch; returns (batch,
    tokens of the step), the patch prefix's tokens included."""
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
        if "patch_embeds" in out:
            out["patch_embeds"] = np.repeat(out["patch_embeds"], folds,
                                            axis=0)
    else:
        raise ValueError(f"unknown SLW mode {mode!r}")
    tokens = int(np.prod(out[seq_keys[0]].shape[:2]))
    if "patch_embeds" in out:
        tokens += int(out["patch_embeds"].shape[0]
                      * out["patch_embeds"].shape[1])
    return out, tokens


class SLWCurriculum:
    def __init__(self, cfg: SLWConfig, full_seq: int,
                 warmup_steps_hint: int = 0, prefix_tokens: int = 0):
        self.cfg = cfg
        self.full_seq = full_seq
        self.warmup_steps_hint = warmup_steps_hint
        self.prefix_tokens = prefix_tokens  # a vision patch prefix, frozen
        self.ladder = pacing.bucket_ladder(cfg, full_seq - prefix_tokens)
        self.state = CurriculumState()

    def seqlen_for_step(self) -> int:
        step = self.state.step
        envelope = pacing.seqlen_at(self.cfg, step,
                                    self.full_seq - self.prefix_tokens,
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

    def apply(self, batch: Dict[str, np.ndarray], seqlen: Optional[int] = None
              ) -> Tuple[Dict[str, np.ndarray], int]:
        """The step's length (or ``seqlen``) applied to a host batch ->
        (batch, tokens of the step) (``curriculum.py:116-124``)."""
        s_t = self.seqlen_for_step() if seqlen is None else seqlen
        return apply_seqlen(batch, s_t, self.cfg.mode)

    def step_complete(self, tokens_this_step: int) -> None:
        self.state.step += 1
        self.state.tokens_seen += tokens_this_step

    @property
    def at_full_length(self) -> bool:
        """The step runs the whole text segment (``curriculum.py:
        131-133``)."""
        return self.seqlen_for_step() >= self.full_seq - self.prefix_tokens

    def state_dict(self) -> Dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: Dict) -> None:
        self.state = CurriculumState(**d)
