"""Continuous-batching serving on one device (``repro/serve``, first slice).

    from repro_torch.serve import InferenceEngine, Request

    engine = InferenceEngine.from_arch("gpt2-117m", use_reduced=False)
    results = engine.run([Request(uid=0, tokens=(1, 2, 3), max_tokens=16)])

``device`` defaults to "cuda"; pass ``device="cpu"`` to run on the CPU.
"""
from repro_torch.serve.engine import (EngineCore, EngineStats,
                                      InferenceEngine, Replica)
from repro_torch.serve.policies import POLICIES, FCFSPolicy, make_policy
from repro_torch.serve.scheduler import (Scheduler, SchedulerConfig,
                                         prefill_split)
from repro_torch.serve.state import SlotDecodeState
from repro_torch.serve.types import (GenerationResult, PrefillOutcome,
                                     Request, SamplingParams)

__all__ = [
    "EngineCore", "EngineStats", "FCFSPolicy", "GenerationResult",
    "InferenceEngine", "POLICIES", "PrefillOutcome", "Replica",
    "Request", "SamplingParams", "Scheduler", "SchedulerConfig",
    "SlotDecodeState", "make_policy", "prefill_split",
]
