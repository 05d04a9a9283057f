"""Continuous-batching scheduler: length-bucketed admission into fixed slots
(``repro/serve/scheduler.py``, without the paged-admission hook).

A prompt's length is quantized down onto ``core.pacing.bucket_ladder``; the
bucket prefix runs through one prefill call and the sub-bucket remainder
replays through the decode step, which is exact.  Up to ``prefill_batch``
pending requests that share a split are admitted as one ``(k, bucket)``
prefill.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import SLWConfig
from repro_torch.core.pacing import bucket_ladder, quantize
from repro_torch.serve.types import GenerationResult, Request


@dataclass(frozen=True)
class SchedulerConfig:
    """Slot and bucket composition (``scheduler.py:38-114``).

    n_slots: decode batch width.  cache_len: per-slot KV capacity; every
    request needs prompt_len + max_tokens <= cache_len.  min_prompt_bucket /
    round_multiple / max_buckets feed the prompt ladder.  prefill_batch: max
    same-split requests per prefill call.  max_pending: bound on the pending
    queue (0 = unbounded).  policy: admission policy name (serve/policies.py).
    """

    n_slots: int = 8
    cache_len: int = 512
    min_prompt_bucket: int = 16
    round_multiple: int = 32
    max_buckets: int = 8
    prefill_batch: int = 1
    max_pending: int = 0
    policy: str = "fcfs"

    def ladder(self) -> Tuple[int, ...]:
        slw = SLWConfig(enabled=True, start_seq_len=self.min_prompt_bucket,
                        end_seq_len=self.cache_len,
                        round_multiple=self.round_multiple,
                        max_buckets=self.max_buckets)
        return bucket_ladder(slw, self.cache_len)


def prefill_split(prompt_len: int, ladder: Tuple[int, ...]) -> int:
    """Tokens to prefill at a bucketed shape; the rest replays via decode.
    Prompts shorter than the smallest bucket prefill one token."""
    if prompt_len < ladder[0]:
        return 1
    return quantize(prompt_len, ladder)


@dataclass
class ActiveSlot:
    """Host-side bookkeeping for one occupied slot."""

    request: Request
    result: GenerationResult
    generator: Optional[torch.Generator]  # the request's sampling stream
    last_token: int = 0

    @property
    def n_generated(self) -> int:
        return len(self.result.tokens)


class Scheduler:
    """Admission queue + slot lifecycle: which request occupies which slot
    and when a slot retires (length budget or stop token)."""

    def __init__(self, cfg: SchedulerConfig):
        if cfg.n_slots < 1 or cfg.cache_len < 1:
            raise ValueError(f"need n_slots >= 1 and cache_len >= 1, got "
                             f"{cfg.n_slots}, {cfg.cache_len}")
        self.cfg = cfg
        self.ladder = cfg.ladder()
        self.pending: Deque[Request] = deque()
        self.active: Dict[int, ActiveSlot] = {}
        self.free: List[int] = list(range(cfg.n_slots))[::-1]  # pop() -> 0
        self.finished: List[GenerationResult] = []

    # -- admission ---------------------------------------------------------
    def _validate(self, request: Request, uids: set) -> None:
        need = request.prompt_len + request.max_tokens
        if need > self.cfg.cache_len:
            raise ValueError(
                f"request {request.uid}: prompt_len + max_tokens = {need} "
                f"exceeds cache_len {self.cfg.cache_len}")
        if request.max_tokens < 1:
            raise ValueError(f"request {request.uid}: max_tokens must be >= 1")
        if request.prompt_len < 1:
            raise ValueError(f"request {request.uid}: empty prompt")
        if request.uid in uids:
            raise ValueError(f"request uid {request.uid} already in flight")
        uids.add(request.uid)

    def _in_flight_uids(self) -> set:
        return ({r.uid for r in self.pending}
                | {s.request.uid for s in self.active.values()})

    @property
    def has_room(self) -> bool:
        return (not self.cfg.max_pending
                or len(self.pending) < self.cfg.max_pending)

    def validate_batch(self, requests) -> None:
        """Validate a request set against in-flight uids and each other."""
        uids = self._in_flight_uids()
        for r in requests:
            self._validate(r, uids)

    def enqueue_validated(self, request: Request) -> None:
        self.pending.append(request)

    def next_admission(self, k: int = 1) -> List[Tuple[int, Request]]:
        """Pop up to ``k`` same-split (free slot, request) pairs: the queue
        head fixes the split, later same-split requests are pulled forward,
        skipped requests keep their order."""
        if not self.pending or not self.free:
            return []
        head = self.pending.popleft()
        out = [(self.free.pop(), head)]
        if k > 1:
            split = prefill_split(head.prompt_len, self.ladder)
            skipped: List[Request] = []
            while self.pending and self.free and len(out) < k:
                r = self.pending.popleft()
                if prefill_split(r.prompt_len, self.ladder) != split:
                    skipped.append(r)
                    continue
                out.append((self.free.pop(), r))
            self.pending.extendleft(reversed(skipped))
        return out

    def activate(self, slot: int, request: Request, first_token: int,
                 prefill_s: float,
                 generator: Optional[torch.Generator]) -> ActiveSlot:
        st = ActiveSlot(request=request,
                        result=GenerationResult(uid=request.uid,
                                                prompt_len=request.prompt_len,
                                                prefill_s=prefill_s),
                        generator=generator, last_token=first_token)
        st.result.tokens.append(first_token)
        self.active[slot] = st
        return st

    # -- stopping ----------------------------------------------------------
    def stop_reason(self, st: ActiveSlot) -> str:
        sp = st.request.sampling
        if sp.stop_token is not None and st.result.tokens \
                and st.result.tokens[-1] == sp.stop_token:
            return "stop_token"
        if st.n_generated >= st.request.max_tokens:
            return "length"
        return ""

    def finish(self, slot: int, reason: str) -> GenerationResult:
        st = self.active.pop(slot)
        st.result.finish_reason = reason
        self.free.append(slot)
        self.finished.append(st.result)
        return st.result

    def abort(self, slot: int, request: Request) -> GenerationResult:
        """Retire a slot whose request failed; a partial result (tokens
        already streamed) survives with finish_reason "error"."""
        st = self.active.pop(slot, None)
        if st is not None:
            res = st.result
            res.finish_reason = "error"
        else:
            res = GenerationResult(uid=request.uid,
                                   prompt_len=request.prompt_len,
                                   finish_reason="error")
        self.free.append(slot)
        self.finished.append(res)
        return res

    @property
    def busy(self) -> bool:
        return bool(self.active) or bool(self.pending)
