"""Synthetic data and the node-sharded loader (mirrors ``repro.data``)."""
from repro_torch.data.pipeline import NodeShardedLoader
from repro_torch.data.synthetic import (SyntheticClassification,
                                        SyntheticLMStream, dirichlet_partition)

__all__ = ["NodeShardedLoader", "SyntheticLMStream", "SyntheticClassification",
           "dirichlet_partition"]
