"""Network topologies beyond the paper's circulants (mirrors ``repro.net``;
the graph families only so far)."""
from repro_torch.net.graphs import (
    ErdosRenyiGraph,
    RandomMatchingGraph,
    RandomSequenceTopology,
    SmallWorldGraph,
    TorusGraph,
    fold_seed,
    metropolis_weights,
)

__all__ = [
    "ErdosRenyiGraph",
    "RandomMatchingGraph",
    "RandomSequenceTopology",
    "SmallWorldGraph",
    "TorusGraph",
    "fold_seed",
    "metropolis_weights",
]
