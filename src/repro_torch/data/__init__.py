"""Synthetic data and the training pipeline (numpy only)."""
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import SyntheticCorpus

__all__ = ["DataPipeline", "SyntheticCorpus"]
