"""Roofline analysis of the port on the H100 (``repro/roofline``)."""
from repro_torch.roofline import hw  # noqa: F401
from repro_torch.roofline.analysis import (  # noqa: F401
    RooflineReport, build_report, model_flops, record_collectives)
