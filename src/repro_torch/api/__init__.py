"""Front door of the port (mirrors ``repro.api``)."""
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
           "Session", "TraceSpec", "TranscriptHook", "capture_rows",
           "estimate_wire_bytes", "hook_trace_spec"]
