"""The SLW control plane: pacing, curriculum, batch warmup, stability
telemetry and the regulator stack (``repro/core``)."""
