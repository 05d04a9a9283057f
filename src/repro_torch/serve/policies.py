"""Admission policies: who gets the next free slots
(``repro/serve/policies.py:36-193``).

A policy returns up to ``k`` (slot, request) pairs that share one prefill
split (the engine stacks them into a single ``(k, bucket)`` prefill) and
honors the ``reserve`` page-budget hook: a pair is emitted only after
``reserve(slot, request)`` accepted it, and a blocked head returns []
with the queue untouched.  None of them starves a request under sustained
load: shortest-prompt-first ages skipped requests into forced heads, the
other two keep a strict-FCFS head.
"""
from __future__ import annotations

from typing import (Callable, Dict, List, Optional, Protocol, Tuple,
                    runtime_checkable)

from repro_torch.serve.scheduler import (Scheduler, SchedulerConfig,
                                         prefill_split)
from repro_torch.serve.types import Request

Reserve = Optional[Callable[[int, Request], bool]]


@runtime_checkable
class AdmissionPolicy(Protocol):
    """Decides which pending requests occupy which free slots."""

    name: str

    def select(self, scheduler: Scheduler, k: int, reserve: Reserve = None
               ) -> List[Tuple[int, Request]]:
        """Pop up to ``k`` same-split (slot, request) pairs off
        ``scheduler.pending``/``scheduler.free``; [] admits nothing."""
        ...


class FCFSPolicy:
    """Strict first-come-first-served: ``Scheduler.next_admission``."""

    name = "fcfs"

    def select(self, scheduler: Scheduler, k: int, reserve: Reserve = None
               ) -> List[Tuple[int, Request]]:
        return scheduler.next_admission(k, reserve=reserve)


class ShortestPromptFirstPolicy:
    """Admit the shortest pending prompt first; same-split pull-forward
    fills the batch shortest-first.  A request passed over ``age_limit``
    times becomes the forced head, so a long prompt cannot starve under a
    stream of short arrivals."""

    name = "shortest-prompt-first"

    def __init__(self, age_limit: int = 16):
        if age_limit < 1:
            raise ValueError(f"need age_limit >= 1, got {age_limit}")
        self.age_limit = age_limit
        self._skips: Dict[int, int] = {}

    def select(self, scheduler: Scheduler, k: int, reserve: Reserve = None
               ) -> List[Tuple[int, Request]]:
        pend = scheduler.pending
        if not pend or not scheduler.free:
            return []
        head_i = next((i for i in range(len(pend))  # oldest over-aged wins
                       if self._skips.get(pend[i].uid, 0) >= self.age_limit),
                      None)
        if head_i is None:
            head_i = min(range(len(pend)),
                         key=lambda i: (pend[i].prompt_len, i))
        head = pend[head_i]
        if reserve is not None and not reserve(scheduler.free[-1], head):
            return []  # the chosen head waits; queue untouched
        del pend[head_i]
        out = [(scheduler.free.pop(), head)]
        if k > 1 and pend and scheduler.free:
            split = prefill_split(head.prompt_len, scheduler.ladder)
            cands = sorted(
                (i for i in range(len(pend))
                 if prefill_split(pend[i].prompt_len,
                                  scheduler.ladder) == split),
                key=lambda i: (pend[i].prompt_len, i))
            taken: List[int] = []
            for i in cands:
                if len(out) >= k or not scheduler.free:
                    break
                r = pend[i]
                if reserve is not None and \
                        not reserve(scheduler.free[-1], r):
                    continue
                out.append((scheduler.free.pop(), r))
                taken.append(i)
            for i in sorted(taken, reverse=True):
                del pend[i]
        for r in pend:
            self._skips[r.uid] = self._skips.get(r.uid, 0) + 1
        for _, r in out:
            self._skips.pop(r.uid, None)
        return out


class BudgetPackingPolicy:
    """FCFS head, then same-split requests pulled forward in queue order
    while the round's worst-case footprint (``prompt_len + max_tokens`` per
    request) stays within ``budget``."""

    name = "budget-packing"

    def __init__(self, budget: int):
        if budget < 1:
            raise ValueError(f"need budget >= 1, got {budget}")
        self.budget = budget

    @staticmethod
    def _need(r: Request) -> int:
        return r.prompt_len + r.max_tokens

    def select(self, scheduler: Scheduler, k: int, reserve: Reserve = None
               ) -> List[Tuple[int, Request]]:
        pend = scheduler.pending
        if not pend or not scheduler.free:
            return []
        if reserve is not None and not reserve(scheduler.free[-1], pend[0]):
            return []
        head = pend.popleft()
        out = [(scheduler.free.pop(), head)]
        spent = self._need(head)
        if k > 1:
            split = prefill_split(head.prompt_len, scheduler.ladder)
            skipped: List[Request] = []
            while pend and scheduler.free and len(out) < k:
                r = pend.popleft()
                if prefill_split(r.prompt_len, scheduler.ladder) != split \
                        or spent + self._need(r) > self.budget \
                        or (reserve is not None
                            and not reserve(scheduler.free[-1], r)):
                    skipped.append(r)
                    continue
                out.append((scheduler.free.pop(), r))
                spent += self._need(r)
            pend.extendleft(reversed(skipped))
        return out


POLICIES = ("fcfs", "shortest-prompt-first", "budget-packing")


def make_policy(cfg: SchedulerConfig) -> AdmissionPolicy:
    """The policy ``cfg.policy`` names, or its alias "spf" / "budget"
    (``policies.py:179-192``); one instance per replica
    (shortest-prompt-first keeps per-queue aging state)."""
    name = cfg.policy
    if name == "fcfs":
        return FCFSPolicy()
    if name in ("shortest-prompt-first", "spf"):
        return ShortestPromptFirstPolicy()
    if name in ("budget-packing", "budget"):
        return BudgetPackingPolicy(cfg.resolved_pack_budget)
    raise ValueError(
        f"unknown admission policy {name!r} (want one of {POLICIES})")
