"""Synthetic data (mirrors ``repro.data``)."""
from repro_torch.data.synthetic import SyntheticClassification, dirichlet_partition

__all__ = ["SyntheticClassification", "dirichlet_partition"]
