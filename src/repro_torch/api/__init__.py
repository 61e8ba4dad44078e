"""Front door of the port (mirrors ``repro.api``): the session, the hook
pipeline, the typed results and the shared CLI flags (``cli.py``)."""
from repro_torch.api.cli import (TOPOLOGY_CHOICES, add_delay_arguments,
                                 add_fault_arguments, add_protocol_arguments,
                                 add_topology_arguments, delays_from_args,
                                 faults_from_args, make_topology,
                                 topology_from_args, validate_protocol_args,
                                 wire_from_args)
from repro_torch.api.hooks import (BudgetExhausted, BudgetHook, LedgerHook,
                                   MetricsHook, RealSensitivityHook,
                                   RoundHook, RunAbort, RunContext,
                                   TraceSpec, TranscriptHook, capture_rows,
                                   hook_trace_spec)
from repro_torch.api.results import RunReport, ServeReport, estimate_wire_bytes
from repro_torch.api.session import PrivacySpec, ProtocolSession, Session

__all__ = ["BudgetExhausted", "BudgetHook", "LedgerHook", "MetricsHook",
           "PrivacySpec", "ProtocolSession", "RealSensitivityHook",
           "RoundHook", "RunAbort", "RunContext", "RunReport", "ServeReport",
           "Session", "TOPOLOGY_CHOICES", "TraceSpec", "TranscriptHook",
           "add_delay_arguments", "add_fault_arguments",
           "add_protocol_arguments", "add_topology_arguments",
           "capture_rows", "delays_from_args", "estimate_wire_bytes",
           "faults_from_args", "hook_trace_spec", "make_topology",
           "topology_from_args", "validate_protocol_args", "wire_from_args"]
