"""The metrics/event bus (port of ``repro.obs.metrics``; stdlib only).

Everything an operator sees about a run flows through one schema:
:class:`Event`, a timestamped (kind, name, value) record with optional
labels, a protocol round and (for alerts and log lines) a message.
Producers are host-side only: the session hooks (``MetricsHook``,
``LedgerHook``) emit at segment boundaries, so the bus never touches a
round.

:class:`MetricsBus` keeps three aggregate views (counters, gauges,
histogram summaries), a bounded ring of recent events and a subscriber list
for streaming consumers. ``default_bus()`` is the process-wide instance the
hooks fall back to when none is injected.

The module also owns the ``repro_torch.obs`` logger: :func:`log_sink` is the
default warn/print sink of the session hooks, a plain-message stdout
logger, so ``print``-compatible output by default but capturable and
silenceable through standard ``logging`` configuration.
"""
from __future__ import annotations

import dataclasses
import logging
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable

__all__ = [
    "Event",
    "HistogramSummary",
    "MetricsBus",
    "default_bus",
    "get_logger",
    "log_sink",
]

_KINDS = ("counter", "gauge", "histogram", "alert", "log")


@dataclasses.dataclass(frozen=True)
class Event:
    """One timestamped observation — the bus's single wire format.

    ``kind`` is one of counter/gauge/histogram (numeric instruments),
    alert (a watchdog finding; ``message`` carries the human line) or log
    (a routed log line). ``labels`` is a sorted tuple of (key, value)
    pairs; ``round`` is the absolute protocol round when the observation
    is round-scoped.
    """

    ts: float
    kind: str
    name: str
    value: float
    labels: tuple[tuple[str, str], ...] = ()
    round: int | None = None
    message: str | None = None
    # Histogram weight: one emitted event standing for ``count`` identical
    # observations (segment-boundary producers aggregate per-round arrays
    # — e.g. the async staleness histogram's per-delay bins — into one
    # event per bin instead of one per message).
    count: int = 1

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"ts": round(self.ts, 6), "kind": self.kind,
                               "name": self.name, "value": self.value}
        if self.labels:
            out["labels"] = dict(self.labels)
        if self.round is not None:
            out["round"] = self.round
        if self.message is not None:
            out["message"] = self.message
        if self.count != 1:
            out["count"] = self.count
        return out


@dataclasses.dataclass
class HistogramSummary:
    """Streaming summary of one histogram series (no bucket boundaries —
    count/sum/min/max is what the text exposition and the JSONL stream
    need; full distributions live in the event ring)."""

    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")

    def observe(self, value: float, count: int = 1) -> None:
        if count < 1:
            return
        self.count += count
        self.total += value * count
        self.min = min(self.min, value)
        self.max = max(self.max, value)


def _label_key(labels: Iterable[tuple[str, str]]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels))


class MetricsBus:
    """Aggregating event bus (see module docstring).

    ``ring`` bounds the retained raw events (oldest dropped first);
    aggregates are unbounded but one entry per (name, labels) series.
    All methods are safe to call from hook ``consume`` bodies — a single
    lock serializes emission, and subscriber exceptions propagate (a
    broken exporter should fail the run loudly, not drop events).
    """

    def __init__(self, ring: int = 4096):
        self._lock = threading.Lock()
        self._events: deque[Event] = deque(maxlen=ring)
        self._counters: dict[tuple[str, tuple], float] = {}
        self._gauges: dict[tuple[str, tuple], float] = {}
        self._hists: dict[tuple[str, tuple], HistogramSummary] = {}
        self._subscribers: list[Callable[[Event], None]] = []
        self._dropped = 0

    # -- emission ------------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Events pushed out of the bounded ring so far (aggregates and
        subscribers never lose anything — only the raw-event replay
        window does). Surfaced as the ``bus.dropped`` counter in
        :meth:`snapshot` / :meth:`series`, so the Prometheus exposition
        and the JSONL exporter's closing line both carry it."""
        return self._dropped

    def emit(self, event: Event) -> None:
        if event.kind not in _KINDS:
            raise ValueError(f"unknown event kind {event.kind!r}")
        warn_drop = False
        with self._lock:
            if (self._events.maxlen is not None
                    and len(self._events) == self._events.maxlen):
                # append() below silently evicts the oldest event — count
                # it instead of losing it without a trace.
                self._dropped += 1
                warn_drop = self._dropped == 1
            self._events.append(event)
            series = (event.name, event.labels)
            if event.kind == "counter":
                self._counters[series] = (
                    self._counters.get(series, 0.0) + event.value)
            elif event.kind == "gauge":
                self._gauges[series] = event.value
            elif event.kind == "histogram":
                self._hists.setdefault(
                    series, HistogramSummary()).observe(event.value,
                                                        count=event.count)
            subscribers = list(self._subscribers)
        if warn_drop:
            get_logger().warning(
                f"MetricsBus ring full (maxlen={self._events.maxlen}): "
                "oldest raw events are being dropped — counted in the "
                "bus.dropped counter (aggregates and subscribers are "
                "unaffected)")
        for fn in subscribers:
            fn(event)

    def _event(self, kind: str, name: str, value: float, *,
               labels: Iterable[tuple[str, str]] = (),
               round: int | None = None,
               message: str | None = None,
               count: int = 1) -> Event:
        event = Event(ts=time.time(), kind=kind, name=name,
                      value=float(value), labels=_label_key(labels),
                      round=round, message=message, count=int(count))
        self.emit(event)
        return event

    def count(self, name: str, value: float = 1.0, **kw) -> Event:
        """Increment the counter series ``name`` by ``value``."""
        return self._event("counter", name, value, **kw)

    def gauge(self, name: str, value: float, **kw) -> Event:
        """Set the gauge series ``name`` to ``value`` (last write wins)."""
        return self._event("gauge", name, value, **kw)

    def observe(self, name: str, value: float, *, count: int = 1,
                **kw) -> Event:
        """Record one observation into the histogram series ``name``
        (``count`` weights it as that many identical observations)."""
        return self._event("histogram", name, value, count=count, **kw)

    def alert(self, name: str, message: str, value: float = 1.0,
              **kw) -> Event:
        """Emit a structured alert (watchdog findings land here)."""
        return self._event("alert", name, value, message=message, **kw)

    def log(self, message: str, name: str = "obs.log", **kw) -> Event:
        return self._event("log", name, 1.0, message=message, **kw)

    # -- consumption ---------------------------------------------------------

    def subscribe(self, fn: Callable[[Event], None]) -> Callable[[], None]:
        """Attach a streaming consumer; returns the detach callable."""
        with self._lock:
            self._subscribers.append(fn)

        def unsubscribe() -> None:
            with self._lock:
                if fn in self._subscribers:
                    self._subscribers.remove(fn)

        return unsubscribe

    def events(self, kind: str | None = None) -> list[Event]:
        """Recent events (the bounded ring), optionally filtered by kind."""
        with self._lock:
            evs = list(self._events)
        return [e for e in evs if kind is None or e.kind == kind]

    def snapshot(self) -> dict[str, Any]:
        """Aggregate state: {counters, gauges, histograms} keyed by name
        (label-free series) or ``name{k=v,...}``."""
        def fmt(series: tuple[str, tuple]) -> str:
            name, labels = series
            if not labels:
                return name
            inner = ",".join(f"{k}={v}" for k, v in labels)
            return f"{name}{{{inner}}}"

        with self._lock:
            counters = {fmt(s): v for s, v in self._counters.items()}
            if self._dropped:
                counters["bus.dropped"] = float(self._dropped)
            return {
                "counters": counters,
                "gauges": {fmt(s): v for s, v in self._gauges.items()},
                "histograms": {
                    fmt(s): {"count": h.count, "sum": h.total,
                             "min": h.min, "max": h.max}
                    for s, h in self._hists.items()},
            }

    def series(self) -> dict[str, dict[tuple[str, tuple], Any]]:
        """Raw aggregate maps keyed by (name, labels), the input of an
        exposition writer."""
        with self._lock:
            counters = dict(self._counters)
            if self._dropped:
                counters[("bus.dropped", ())] = float(self._dropped)
            return {"counters": counters,
                    "gauges": dict(self._gauges),
                    "histograms": {k: dataclasses.replace(v)
                                   for k, v in self._hists.items()}}


_DEFAULT_BUS: MetricsBus | None = None


def default_bus() -> MetricsBus:
    """The process-wide bus the session hooks publish to by default."""
    global _DEFAULT_BUS
    if _DEFAULT_BUS is None:
        _DEFAULT_BUS = MetricsBus()
    return _DEFAULT_BUS


# ---------------------------------------------------------------------------
# The obs logger — default sink for hook warn/print output
# ---------------------------------------------------------------------------


class _StdoutHandler(logging.StreamHandler):
    """StreamHandler that re-resolves ``sys.stdout`` per record, so test
    capture (capsys) and driver-level stream redirection both work."""

    def emit(self, record: logging.LogRecord) -> None:
        self.stream = sys.stdout
        super().emit(record)


def get_logger() -> logging.Logger:
    """The ``repro_torch.obs`` logger: plain-message lines on stdout by
    default (byte-compatible with the bare ``print`` sinks it replaces),
    fully reconfigurable through standard ``logging``."""
    logger = logging.getLogger("repro_torch.obs")
    if not logger.handlers:
        handler = _StdoutHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def log_sink(message: str) -> None:
    """Default warn/print sink of the session hooks (``BudgetHook.warn``,
    ``MetricsHook.print_fn``): one INFO line through :func:`get_logger`."""
    get_logger().info(message)
