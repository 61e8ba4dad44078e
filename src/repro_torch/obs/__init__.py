"""The observability layer of the port (mirrors ``repro.obs``).

Six pieces, wired through the session's RoundHook seam:

* **Phase tracing** (:mod:`repro_torch.obs.trace`): ``phase()`` ranges on
  the round phases, a ``torch.profiler.record_function`` only while a
  profiler records, and the per-phase device-time breakdown of
  :meth:`repro_torch.api.Session.profile`.
* **Metrics and event bus** (:mod:`repro_torch.obs.metrics`): one
  timestamped :class:`Event` schema, counter, gauge and histogram
  aggregates, and the ``repro.obs`` logger the hooks' sinks go through.
* **Exporters** (:mod:`repro_torch.obs.export`): a JSONL event stream and
  the Prometheus text exposition.
* **Health watchdogs** (:mod:`repro_torch.obs.watchdog`): the round's
  ``wd_*`` diagnostics (NaN/Inf on the wire, push-sum mass drift,
  consensus residual) and the sensitivity, async and wire-residual checks,
  judged at segment boundaries as :class:`Alert` events, with a strict
  policy that aborts as ``BudgetHook(strict=True)`` does.
* **Run timeline** (:mod:`repro_torch.obs.timeline`): host segment spans,
  device phase slices and the async message lifecycle as Chrome
  trace-event JSON (:class:`TimelineHook` / :class:`Timeline`).
* **Cross-run registry** (:mod:`repro_torch.obs.registry`):
  :class:`RunRecord` history with rolling-median regression gates
  (``python -m repro_torch.obs.registry check``).

This package imports only torch and the standard library, so the core
protocol can annotate its phases without an import cycle. The watchdog and
timeline hooks subclass :class:`repro_torch.api.hooks.RoundHook`, so they
load lazily (module ``__getattr__``), as the registry does.
"""
from __future__ import annotations

from repro_torch.obs.export import (JsonlExporter, prometheus_text,
                                    write_prometheus)
from repro_torch.obs.metrics import (Event, HistogramSummary, MetricsBus,
                                     default_bus, get_logger, log_sink)
from repro_torch.obs.trace import KNOWN_PHASES, ProfileReport, phase

__all__ = [
    "Alert",
    "Event",
    "HistogramSummary",
    "JsonlExporter",
    "KNOWN_PHASES",
    "MetricGate",
    "MetricsBus",
    "ProfileReport",
    "RunRecord",
    "Timeline",
    "TimelineHook",
    "WatchdogAbort",
    "WatchdogHook",
    "default_bus",
    "get_logger",
    "log_sink",
    "phase",
    "prometheus_text",
    "validate_chrome_trace",
    "write_prometheus",
]

# Resolved lazily: the watchdog and timeline hooks subclass
# repro_torch.api.hooks.RoundHook, and the registry is needed only by
# record and check.
_LAZY = {
    "Alert": "repro_torch.obs.watchdog",
    "WatchdogAbort": "repro_torch.obs.watchdog",
    "WatchdogHook": "repro_torch.obs.watchdog",
    "Timeline": "repro_torch.obs.timeline",
    "TimelineHook": "repro_torch.obs.timeline",
    "validate_chrome_trace": "repro_torch.obs.timeline",
    "RunRecord": "repro_torch.obs.registry",
    "MetricGate": "repro_torch.obs.registry",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
