"""Event-stream and metrics-snapshot writers for the obs bus (port of
``repro.obs.export``; stdlib only).

Two output formats, both host-side and both driven off
:class:`repro_torch.obs.metrics.MetricsBus`:

* :class:`JsonlExporter` — a streaming subscriber appending one JSON line
  per :class:`Event` (same append-only discipline as the audit lab's
  privacy ledger: lines survive a crash mid-run).
* :func:`prometheus_text` — Prometheus text exposition (version 0.0.4) of
  the bus's aggregate state: counters, gauges, and histogram summaries as
  ``_count`` / ``_sum`` / ``_min`` / ``_max`` series. Hand-written on
  purpose — no client-library dependency, and the protocol's metric
  names map through :func:`_sanitize` (dots -> underscores).
"""
from __future__ import annotations

import json
import re
from typing import IO, Any

from repro_torch.obs.metrics import Event, MetricsBus

__all__ = ["JsonlExporter", "prometheus_text", "write_prometheus"]


class JsonlExporter:
    """Stream bus events to a JSONL file (or any writable handle).

    Attach with ``exporter.attach(bus)`` (subscribes; returns self for
    chaining) and ``close()`` when done — or use as a context manager.
    Every event is written and flushed as it is emitted.
    """

    def __init__(self, path_or_file: str | IO[str]):
        if isinstance(path_or_file, str):
            self._file: IO[str] = open(path_or_file, "w")
            self._owns = True
        else:
            self._file = path_or_file
            self._owns = False
        self._detach = None
        self._bus: MetricsBus | None = None
        self.written = 0

    def attach(self, bus: MetricsBus) -> "JsonlExporter":
        self._detach = bus.subscribe(self)
        self._bus = bus
        return self

    def __call__(self, event: Event) -> None:
        self._file.write(json.dumps(event.to_dict()) + "\n")
        self._file.flush()
        self.written += 1

    def close(self) -> None:
        if self._detach is not None:
            self._detach()
            self._detach = None
        # Ring drops never pass through subscribe (subscribers see every
        # event; only the bus's replay window loses them) — but a stream
        # consumer still wants to know the bus was overrunning, so the
        # closing line records the final bus.dropped count.
        if (self._bus is not None and self._bus.dropped
                and not self._file.closed):
            import time as _time

            self._file.write(json.dumps({
                "ts": round(_time.time(), 6), "kind": "counter",
                "name": "bus.dropped", "value": float(self._bus.dropped),
                "message": "events evicted from the bus ring "
                           "(replay window overrun)"}) + "\n")
            self._file.flush()
            self.written += 1
        self._bus = None
        if self._owns and not self._file.closed:
            self._file.close()

    def __enter__(self) -> "JsonlExporter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_label(value: str) -> str:
    """Label-value escaping per the exposition format: backslash, double
    quote and newline must be escaped inside the quoted value."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_sanitize(k)}="{_escape_label(v)}"'
                     for k, v in labels)
    return "{" + inner + "}"


def _fmt_value(value: float) -> str:
    """Exposition-format float rendering: Python's ``nan``/``inf`` spell
    ``NaN`` / ``+Inf`` / ``-Inf`` in Prometheus text."""
    value = float(value)
    if value != value:
        return "NaN"
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    return repr(value)


def prometheus_text(bus: MetricsBus) -> str:
    """Text exposition of the bus's aggregate state (module docstring)."""
    series = bus.series()
    lines: list[str] = []
    typed: set[str] = set()

    def emit(name: str, kind: str, labels: tuple, value: float) -> None:
        metric = _sanitize(name)
        if metric not in typed:
            typed.add(metric)
            lines.append(f"# TYPE {metric} {kind}")
        lines.append(f"{metric}{_labels(labels)} {_fmt_value(value)}")

    for (name, labels), value in sorted(series["counters"].items()):
        emit(name, "counter", labels, value)
    for (name, labels), value in sorted(series["gauges"].items()):
        emit(name, "gauge", labels, value)
    for (name, labels), hist in sorted(series["histograms"].items()):
        base = _sanitize(name)
        # An empty summary (a series created but never observed) has
        # min=+inf / max=-inf sentinels — render NaN, not fake bounds.
        empty = hist.count == 0
        for suffix, value in (
                ("_count", hist.count), ("_sum", hist.total),
                ("_min", float("nan") if empty else hist.min),
                ("_max", float("nan") if empty else hist.max)):
            emit(base + suffix, "gauge", labels, value)
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(bus: MetricsBus, path: str) -> None:
    """Write :func:`prometheus_text` to ``path`` (snapshot, not stream)."""
    with open(path, "w") as f:
        f.write(prometheus_text(bus))
