"""Protocol plan, round drivers and the sharded engine (mirrors
``repro.engine``)."""
from repro_torch.engine.plan import ProtocolPlan
from repro_torch.engine.rounds import (run_decode, run_dpps, run_partpsp,
                                      run_segments, stack_rounds, wire_layout)
from repro_torch.engine.shard import (shard_run_dpps, shard_run_partpsp,
                                     sharded_gossip_builder, sharded_node_ops)

__all__ = ["ProtocolPlan", "run_decode", "run_dpps", "run_partpsp",
           "run_segments", "stack_rounds", "wire_layout", "shard_run_dpps", "shard_run_partpsp",
           "sharded_gossip_builder", "sharded_node_ops"]
