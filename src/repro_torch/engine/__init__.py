"""Protocol plan and round drivers (mirrors ``repro.engine``)."""
from repro_torch.engine.plan import ProtocolPlan
from repro_torch.engine.rounds import (run_decode, run_dpps, run_partpsp,
                                      wire_layout)

__all__ = ["ProtocolPlan", "run_decode", "run_dpps", "run_partpsp",
           "wire_layout"]
