"""The SLW control plane: pacing, curriculum, batch warmup, stability
telemetry, the regulator stack and divergence recovery (``repro/core``)."""
from repro_torch.core.recovery import (  # noqa: F401
    DivergenceDetector,
    DivergenceError,
    DivergenceEvent,
    RecoveryConfig,
    RecoveryHook,
    RecoveryRegulator,
    RollbackController,
    StateRing,
)
