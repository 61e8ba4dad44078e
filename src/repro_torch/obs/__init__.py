"""Observability (mirrors ``repro.obs``): so far the metrics bus and the
hooks' log sink. The rest of the reference's layer is ROADMAP Queue 1
item 10."""
from repro_torch.obs.metrics import (Event, HistogramSummary, MetricsBus,
                                     default_bus, get_logger, log_sink)

__all__ = ["Event", "HistogramSummary", "MetricsBus", "default_bus",
           "get_logger", "log_sink"]
