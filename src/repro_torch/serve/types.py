"""Typed serving API surface: Request -> GenerationResult
(copy of ``repro/serve/types.py``).

Frozen dataclasses so request/sampling configurations are hashable and safe
to log, diff and replay.  ``SamplingParams`` defaults to greedy decoding
(``temperature == 0``), which is the mode the engine-vs-legacy parity tests
pin down tokenwise.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class SamplingParams:
    """Pure-function-of-logits sampling configuration (see serve.sampling).

    temperature == 0 selects greedy argmax (rng unused); top_k == 0 and
    top_p == 1.0 disable the respective truncations.  ``seed`` and the
    request's uid seed its own ``torch.Generator`` — results are
    reproducible independently of batch composition or admission order.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop_token: Optional[int] = None

    def replace(self, **kw) -> "SamplingParams":
        import dataclasses
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Request:
    """One generation request: prompt tokens + a generation budget."""

    uid: int
    tokens: Tuple[int, ...]
    max_tokens: int = 16
    sampling: SamplingParams = field(default_factory=SamplingParams)

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)


@dataclass
class PrefillOutcome:
    """Per-row result of one ``EngineCore.prefill_batch`` call.

    The device layer reports *which phase* failed for *which row*
    (``error`` in ``"" | "prefill" | "replay" | "sample"``); what to do
    about it — abort, retire, count — is the ``Replica`` layer's call.
    A ``"prefill"`` error means the shared ``(k, bucket)`` phase failed,
    so every row of the admission carries it.
    """

    slot: int
    request: "Request"
    first_token: Optional[int] = None
    error: str = ""  # "" = ok | "prefill" | "replay" | "sample"
    # the request's sampling stream, created at admission; it has drawn
    # the first token when sampling is on (serve/sampling.py)
    generator: Optional[torch.Generator] = None


@dataclass(frozen=True)
class ReplicaTelemetry:
    """Admission telemetry one replica exposes to the router.

    ``free_pages`` is ``-1`` for dense (non-paged) replicas; ``p95_step_s``
    is the trailing p95 fused-step latency from the stats ring.
    """

    name: str
    queue_depth: int
    active: int
    free_slots: int
    free_pages: int
    p95_step_s: float

    @property
    def load(self) -> int:
        """Requests in flight (queued + decoding) — the least-loaded
        routing score.  Ties break on replica order, so an idle fleet
        fills deterministically."""
        return self.queue_depth + self.active


@dataclass
class GenerationResult:
    """Completed (or in-flight) generation for one request."""

    uid: int
    prompt_len: int
    tokens: list = field(default_factory=list)
    finish_reason: str = ""  # length | stop_token | aborted | error
    # engine accounting (host wall-clock, seconds)
    prefill_s: float = 0.0
    decode_steps: int = 0

    @property
    def n_generated(self) -> int:
        return len(self.tokens)
