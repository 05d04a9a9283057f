"""Synthetic data (numpy only)."""
from repro_torch.data.synthetic import SyntheticCorpus

__all__ = ["SyntheticCorpus"]
