"""Network realism (mirrors ``repro.net``): random and structured graph
families, faults (:class:`FaultModel`, the "dynamic" schedule), bounded-delay
async push-sum (:class:`DelayModel`, :class:`Mailbox`) and the realized
network's record (:class:`NetworkStats`, :class:`NetworkStatsHook`).

``Session.build(topology, faults=FaultModel(...), delays=DelayModel(...))``
threads the models through the plan, the engine and the loop driver.
"""
from repro_torch.net.delays import DELAY_SALT, DelayDraws, DelayModel, Mailbox
from repro_torch.net.faults import FAULT_SALT, FaultDraws, FaultModel
from repro_torch.net.graphs import (
    ErdosRenyiGraph,
    RandomMatchingGraph,
    RandomSequenceTopology,
    SmallWorldGraph,
    TorusGraph,
    fold_seed,
    metropolis_weights,
)
from repro_torch.net.stats import (NetworkStats, NetworkStatsHook,
                                   strongly_connected)

__all__ = [
    "DELAY_SALT",
    "DelayDraws",
    "DelayModel",
    "Mailbox",
    "FAULT_SALT",
    "FaultDraws",
    "FaultModel",
    "ErdosRenyiGraph",
    "RandomMatchingGraph",
    "RandomSequenceTopology",
    "SmallWorldGraph",
    "TorusGraph",
    "NetworkStats",
    "NetworkStatsHook",
    "fold_seed",
    "metropolis_weights",
    "strongly_connected",
]
