"""Admission policies (``repro/serve/policies.py:36-58, 179``): the protocol,
first-come-first-served, and ``make_policy``.  Shortest-prompt-first and
budget packing come with a later slice."""
from __future__ import annotations

from typing import List, Protocol, Tuple, runtime_checkable

from repro_torch.serve.scheduler import Scheduler, SchedulerConfig
from repro_torch.serve.types import Request

POLICIES = ("fcfs",)


@runtime_checkable
class AdmissionPolicy(Protocol):
    """Decides which pending requests occupy which free slots."""

    name: str

    def select(self, scheduler: Scheduler, k: int
               ) -> List[Tuple[int, Request]]:
        """Pop up to ``k`` same-split (slot, request) pairs off
        ``scheduler.pending``/``scheduler.free``; [] admits nothing."""
        ...


class FCFSPolicy:
    """Strict first-come-first-served: ``Scheduler.next_admission``."""

    name = "fcfs"

    def select(self, scheduler: Scheduler, k: int
               ) -> List[Tuple[int, Request]]:
        return scheduler.next_admission(k)


def make_policy(cfg: SchedulerConfig) -> AdmissionPolicy:
    if cfg.policy == "fcfs":
        return FCFSPolicy()
    raise ValueError(f"unknown admission policy {cfg.policy!r} (the port "
                     f"has {POLICIES})")
