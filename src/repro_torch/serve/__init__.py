"""Continuous-batching serving on one device (``repro/serve``).

    from repro_torch.serve import InferenceEngine, Request

    engine = InferenceEngine.from_arch("gpt2-117m", use_reduced=False)
    results = engine.run([Request(uid=0, tokens=(1, 2, 3), max_tokens=16)])

The stack is layered as the reference's: ``EngineCore`` (device layer,
dense or paged cache) / ``AdmissionPolicy`` (serve/policies.py) /
``Replica`` (slot lifecycle, roles, migration) / ``Router``
(serve/router.py).  ``device`` defaults to "cuda"; pass ``device="cpu"``
to run on the CPU.
"""
from repro_torch.serve.engine import (EngineCore, EngineStats,
                                      InferenceEngine, Replica)
from repro_torch.serve.paging import (PageAllocator, PagedDecodeState,
                                      PageExhausted, cache_nbytes, pages_for)
from repro_torch.serve.policies import (POLICIES, AdmissionPolicy,
                                        BudgetPackingPolicy, FCFSPolicy,
                                        ShortestPromptFirstPolicy, make_policy)
from repro_torch.serve.router import (ROUTES, Router, RouterStats,
                                      make_replicas)
from repro_torch.serve.scheduler import (QueueFull, Scheduler,
                                         SchedulerConfig, prefill_split)
from repro_torch.serve.state import DecodeState, SlotDecodeState
from repro_torch.serve.types import (GenerationResult, PrefillOutcome,
                                     ReplicaTelemetry, Request,
                                     SamplingParams)

__all__ = [
    "AdmissionPolicy", "BudgetPackingPolicy", "DecodeState", "EngineCore",
    "EngineStats", "FCFSPolicy", "GenerationResult", "InferenceEngine",
    "POLICIES", "PageAllocator", "PageExhausted", "PagedDecodeState",
    "PrefillOutcome", "QueueFull", "ROUTES", "Replica", "ReplicaTelemetry",
    "Request", "Router", "RouterStats", "SamplingParams", "Scheduler",
    "SchedulerConfig", "ShortestPromptFirstPolicy", "SlotDecodeState",
    "cache_nbytes", "make_policy", "make_replicas", "pages_for",
    "prefill_split",
]
