"""Router: a request front-end over N serving replicas
(``repro/serve/router.py``).

Routes each request to one replica by its admission telemetry (requests in
flight, ties on replica order) or round-robin, spills to the next replica
on ``QueueFull``, sheds explicitly when every replica is full, and sums the
replicas' :class:`EngineStats` into a summary.  All replicas live on one
device and share one set of params; a request's tokens do not depend on
where it lands, since its stream is a function of its own prompt,
sampling parameters and ``(seed, uid)``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.serve.engine import Replica
from repro_torch.serve.scheduler import QueueFull, SchedulerConfig
from repro_torch.serve.types import (GenerationResult, ReplicaTelemetry,
                                     Request)

OnToken = Callable[[int, int], None]

ROUTES = ("least-loaded", "round-robin")


@dataclass
class RouterStats:
    """Where requests landed and what bounced: ``routed[name]`` counts
    acceptances per replica, ``spilled`` requests that bounced off a full
    replica before landing, ``shed`` requests every replica refused."""

    routed: Dict[str, int] = field(default_factory=dict)
    spilled: int = 0
    shed: int = 0

    @property
    def total_routed(self) -> int:
        return sum(self.routed.values())


class Router:
    """Route requests over N replicas; drive them; merge their results."""

    def __init__(self, replicas: Sequence[Replica],
                 route: str = "least-loaded"):
        if not replicas:
            raise ValueError("need at least one replica")
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r} "
                             f"(want one of {ROUTES})")
        for rep in replicas:
            if rep.role == "prefill":
                raise ValueError(
                    f"replica {rep.name!r} has role='prefill': route to "
                    f"serving replicas (role 'both'/'decode'); prefill "
                    f"workers are reached through their decode partner")
        self.replicas = list(replicas)
        self.route = route
        self._rr = 0
        self.stats = RouterStats()

    def telemetry(self) -> List[ReplicaTelemetry]:
        """Each replica's telemetry, in replica order (``router.py:75-76``)."""
        return [rep.telemetry() for rep in self.replicas]

    @property
    def busy(self) -> bool:
        return any(rep.scheduler.busy for rep in self.replicas)

    # -- routing -------------------------------------------------------------
    def _candidates(self) -> List[Replica]:
        """Replicas in routing-preference order for one request."""
        n = len(self.replicas)
        if self.route == "round-robin":
            order = [self.replicas[(self._rr + i) % n] for i in range(n)]
            self._rr = (self._rr + 1) % n
            return order
        return sorted(self.replicas,
                      key=lambda rep: rep.telemetry().load)  # stable: ties

    def _try_route(self, request: Request, count_shed: bool) -> bool:
        spilled = False
        for rep in self._candidates():
            try:
                rep.scheduler.submit(request)
            except QueueFull:
                spilled = True
                continue
            if spilled:
                self.stats.spilled += 1
            self.stats.routed[rep.name] = \
                self.stats.routed.get(rep.name, 0) + 1
            return True
        if count_shed:
            self.stats.shed += 1
        return False

    def submit(self, request: Request) -> bool:
        """Route one request; False (counted as shed) when every replica's
        queue is full.  An invalid request raises."""
        return self._try_route(request, count_shed=True)

    # -- run loop ------------------------------------------------------------
    def pump(self, on_token: Optional[OnToken] = None) -> bool:
        """One admission and decode round on every replica."""
        progressed = False
        for rep in self.replicas:
            progressed = rep.pump(on_token) or progressed
        return progressed

    def take_finished(self) -> List[GenerationResult]:
        return [res for rep in self.replicas for res in rep.take_finished()]

    def run(self, requests: Sequence[Request],
            on_token: Optional[OnToken] = None) -> List[GenerationResult]:
        """Generate for all ``requests`` across the fleet; results in
        request order.  Validation is all-or-nothing and a request must be
        valid on every replica.  Nothing is shed: a backlog head no replica
        can queue now waits for the next round."""
        requests = list(requests)
        uids = set()
        for r in requests:
            if r.uid in uids:
                raise ValueError(f"request uid {r.uid} duplicated")
            uids.add(r.uid)
        for rep in self.replicas:
            rep.scheduler.validate_batch(requests)
        backlog = deque(requests)
        done: Dict[int, GenerationResult] = {}
        while backlog or self.busy:
            while backlog and self._try_route(backlog[0], count_shed=False):
                backlog.popleft()
            self.pump(on_token)
            for res in self.take_finished():
                done[res.uid] = res
        return [done[r.uid] for r in requests]

    def summary(self) -> dict:
        """Fleet accounting (CLI report, metrics JSONL summary row)."""
        agg = {"generated_tokens": 0, "admitted": 0, "decode_steps": 0,
               "prefill_s": 0.0, "decode_s": 0.0, "slot_errors": 0,
               "replica_shed": 0}
        per = {}
        for rep in self.replicas:
            s = rep.stats
            agg["generated_tokens"] += s.generated_tokens
            agg["admitted"] += s.admitted
            agg["decode_steps"] += s.decode_steps
            agg["prefill_s"] += s.prefill_s
            agg["decode_s"] += s.decode_s
            agg["slot_errors"] += s.slot_errors
            agg["replica_shed"] += s.shed
            per[rep.name] = {
                "generated_tokens": s.generated_tokens,
                "admitted": s.admitted,
                "decode_tok_s": s.decode_tok_s,
                "p95_step_s": s.latency_percentile(95),
                "slot_errors": s.slot_errors,
            }
        return {"routed": dict(self.stats.routed),
                "spilled": self.stats.spilled, "shed": self.stats.shed,
                "aggregate": agg, "replicas": per}


def make_replicas(model, params, cfg: SchedulerConfig, n_replicas: int, *,
                  device="cuda", disaggregate: bool = False) -> List[Replica]:
    """A fleet of ``n_replicas`` sharing one model and one set of params.

    ``disaggregate`` builds each serving unit as a prefill-role and a
    decode-role replica; the list holds the routable decode replicas, each
    with its partner at ``.prefill_replica``.
    """
    if n_replicas < 1:
        raise ValueError(f"need n_replicas >= 1, got {n_replicas}")
    reps: List[Replica] = []
    for i in range(n_replicas):
        if disaggregate:
            pre = Replica(model, params, cfg, device=device, role="prefill",
                          name=f"prefill{i}")
            reps.append(Replica(model, params, cfg, device=device,
                                role="decode", prefill_source=pre,
                                name=f"decode{i}"))
        else:
            reps.append(Replica(model, params, cfg, device=device,
                                name=f"replica{i}"))
    return reps
