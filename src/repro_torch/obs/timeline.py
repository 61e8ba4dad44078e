"""Run timeline: a causal span and event record of one protocol run (port
of ``repro.obs.timeline``).

The metrics stream (the bus) and the device breakdown
(``Session.profile``) lack a time axis that joins them: when each segment
executed, how long the host spent in the hooks' consume, and, on the async
runtime, when a message was enqueued, delivered or timed out.
:class:`Timeline` collects exactly that and exports it as Chrome
trace-event JSON (``{"traceEvents": [...]}``), so a run's artifact opens
in Perfetto or ``chrome://tracing``.

Three tracks (trace processes):

* **host** (pid 1): the session driver's segment spans: the first
  segment (which builds and loads the kernels on first use), the later
  ``execute`` spans, and the ``hook-consume`` span of each boundary (tid
  2). ``Session._drive`` feeds them through the duck-typed
  ``segment_span`` method (``repro_torch.api`` never imports
  ``repro_torch.obs``'s hooks).
* **device** (pid 2): the per-phase device seconds of a
  :class:`repro_torch.obs.trace.ProfileReport`
  (:meth:`Timeline.add_profile`), laid out as sequential slices under the
  profile's execute window.
* **protocol** (pid 3): the async message lifecycle rebuilt from the
  ``async_*`` rows: each round's delivered-message histogram becomes
  ``msg send->deliver`` async spans from the enqueue round's wall time to
  the delivery round's, timeouts become ``msg send->timeout`` instants,
  and the in-flight mass, active nodes and staleness become counter
  series. The rows are aggregates (no per-edge data), so one span stands
  for ``count`` messages of one delay; its ``args`` carry the count.

:class:`TimelineHook` wires it into a run and publishes on the bus:
per-segment ``timeline.execute_s`` / ``timeline.consume_s`` histograms and
the run's ``run.compile_s`` / ``run.run_s`` gauges. It adds no round-side
capture, so the run is unchanged; its run-time cost is one device
synchronization a segment (so the span boundaries are real device time)
and host bookkeeping.
"""
from __future__ import annotations

import json
from typing import Any

import numpy as np

from repro_torch.api.hooks import RoundHook, RunContext, _resolve_bus

__all__ = ["Timeline", "TimelineHook", "validate_chrome_trace"]

PID_HOST = 1
PID_DEVICE = 2
PID_MSG = 3

# Trajectory rows the hook reconstructs message lifecycle from (emitted by
# repro_torch.net.DelayModel.open_round on every async run).
_ASYNC_ROWS = (
    "async_delay_hist",
    "async_timeouts",
    "async_staleness_max",
    "async_active",
    "async_inflight_mass",
)

_PHASES = ("b", "e", "i", "X", "C", "M")


class Timeline:
    """An in-memory trace-event collection with Chrome-trace export.

    Events are recorded with absolute wall-clock seconds and converted to
    the format's microsecond offsets (relative to the earliest event) at
    export, so numbers stay small and runs recorded at different times
    diff cleanly. ``meta`` lands in the export's ``otherData``.
    """

    def __init__(self, meta: dict[str, Any] | None = None):
        self._events: list[dict[str, Any]] = []
        self._procs: dict[int, str] = {PID_HOST: "host",
                                       PID_DEVICE: "device",
                                       PID_MSG: "protocol"}
        self._threads: dict[tuple[int, int], str] = {
            (PID_HOST, 1): "driver", (PID_HOST, 2): "hooks",
            (PID_HOST, 3): "profile", (PID_DEVICE, 1): "phases",
            (PID_MSG, 1): "messages"}
        self._next_id = 1
        self.meta: dict[str, Any] = dict(meta or {})

    def __len__(self) -> int:
        return len(self._events)

    # -- naming --------------------------------------------------------------

    def name_process(self, pid: int, name: str) -> None:
        self._procs[pid] = name

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        self._threads[(pid, tid)] = name

    # -- recording -----------------------------------------------------------

    def _add(self, ph: str, name: str, ts_s: float, *, pid: int, tid: int,
             cat: str, dur_s: float | None = None,
             id_: int | None = None, args: dict | None = None,
             scope: str | None = None) -> None:
        ev: dict[str, Any] = {"ph": ph, "name": name, "cat": cat,
                              "ts_s": float(ts_s), "pid": pid, "tid": tid}
        if dur_s is not None:
            ev["dur_s"] = max(float(dur_s), 0.0)
        if id_ is not None:
            ev["id"] = id_
        if args is not None:
            ev["args"] = args
        if scope is not None:
            ev["s"] = scope
        self._events.append(ev)

    def span(self, name: str, ts_s: float, dur_s: float, *,
             pid: int = PID_HOST, tid: int = 1, cat: str = "host",
             args: dict | None = None) -> None:
        """A complete ("X") slice of ``dur_s`` seconds starting ``ts_s``."""
        self._add("X", name, ts_s, pid=pid, tid=tid, cat=cat, dur_s=dur_s,
                  args=args)

    def instant(self, name: str, ts_s: float, *, pid: int = PID_HOST,
                tid: int = 1, cat: str = "host",
                args: dict | None = None) -> None:
        """An instant ("i") event (thread-scoped)."""
        self._add("i", name, ts_s, pid=pid, tid=tid, cat=cat, args=args,
                  scope="t")

    def async_span(self, name: str, ts_s: float, dur_s: float, *,
                   pid: int = PID_MSG, tid: int = 1, cat: str = "async_msg",
                   args: dict | None = None) -> None:
        """A nestable async "b"/"e" pair — the only event type that may
        overlap on one track, which message lifetimes do."""
        id_ = self._next_id
        self._next_id += 1
        self._add("b", name, ts_s, pid=pid, tid=tid, cat=cat, id_=id_,
                  args=args)
        self._add("e", name, ts_s + max(float(dur_s), 0.0), pid=pid,
                  tid=tid, cat=cat, id_=id_)

    def counter(self, name: str, ts_s: float, values: dict[str, float], *,
                pid: int = PID_MSG, cat: str = "counter") -> None:
        """A counter ("C") sample: ``values`` series under one name."""
        self._add("C", name, ts_s, pid=pid, tid=0, cat=cat,
                  args={k: float(v) for k, v in values.items()})

    def end_ts(self) -> float:
        """Latest recorded timestamp (span ends included); 0.0 if empty."""
        if not self._events:
            return 0.0
        return max(e["ts_s"] + e.get("dur_s", 0.0) for e in self._events)

    def add_profile(self, profile: Any, at: float | None = None) -> None:
        """Merge a :class:`repro_torch.obs.trace.ProfileReport`.

        A profile pass carries durations, not wall timestamps, so the
        spans are laid out sequentially from ``at`` (default: after the
        last recorded event): trace -> compile -> execute on the host
        profile track, and the per-phase device seconds as sequential
        slices on the device track under the execute window. An empty
        phase dict (no device time in the trace) leaves the device track
        empty; the profile's ``note`` is kept in ``meta``.
        """
        base = at if at is not None else self.end_ts()
        t = base
        for name, dur in (("profile:trace", profile.trace_s),
                          ("profile:compile", profile.compile_s),
                          ("profile:execute", profile.execute_s)):
            self.span(name, t, dur, pid=PID_HOST, tid=3, cat="profile",
                      args={"rounds": profile.rounds,
                            "backend": profile.backend})
            t += dur
        dev0 = base + profile.trace_s + profile.compile_s
        t = dev0
        for phase_name, secs in sorted(profile.phases.items(),
                                       key=lambda kv: -kv[1]):
            self.span(phase_name, t, secs, pid=PID_DEVICE, tid=1,
                      cat="device_phase", args={"seconds": secs})
            t += secs
        self.meta.setdefault("profile", {})
        self.meta["profile"] = {
            "rounds": profile.rounds, "backend": profile.backend,
            "device_total_s": profile.device_total_s,
            "note": profile.note}

    # -- export --------------------------------------------------------------

    def to_chrome_trace(self) -> dict[str, Any]:
        """The Chrome trace-event JSON object (``traceEvents`` array form,
        timestamps in microseconds relative to the earliest event)."""
        origin = min((e["ts_s"] for e in self._events), default=0.0)

        def us(ts_s: float) -> float:
            return round((ts_s - origin) * 1e6, 3)

        out: list[dict[str, Any]] = []
        for pid, name in sorted(self._procs.items()):
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "ts": 0, "cat": "__metadata",
                        "args": {"name": name}})
        for (pid, tid), name in sorted(self._threads.items()):
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "ts": 0, "cat": "__metadata",
                        "args": {"name": name}})
        for e in sorted(self._events, key=lambda e: e["ts_s"]):
            ev: dict[str, Any] = {"ph": e["ph"], "name": e["name"],
                                  "cat": e["cat"], "ts": us(e["ts_s"]),
                                  "pid": e["pid"], "tid": e["tid"]}
            if "dur_s" in e:
                ev["dur"] = round(e["dur_s"] * 1e6, 3)
            if "id" in e:
                ev["id"] = e["id"]
            if "s" in e:
                ev["s"] = e["s"]
            if "args" in e:
                ev["args"] = e["args"]
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": dict(self.meta)}

    def save(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path``; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


def validate_chrome_trace(obj: dict[str, Any]) -> None:
    """Schema-check a Chrome trace-event object (raises ``ValueError``).

    Checks the ``traceEvents`` array form: every event carries
    name/ph/pid/tid/ts, phases are from the known set, "X" events carry a
    non-negative ``dur``, and "b"/"e" pairs balance per id. This is the
    check the exports are held to.
    """
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a trace object: missing 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    open_async: dict[tuple, int] = {}
    for i, e in enumerate(events):
        for field in ("name", "ph", "pid", "tid", "ts"):
            if field not in e:
                raise ValueError(f"event {i} missing {field!r}: {e!r}")
        if e["ph"] not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {e['ph']!r}")
        if not isinstance(e["ts"], (int, float)) or e["ts"] < 0:
            raise ValueError(f"event {i} has bad ts {e['ts']!r}")
        if e["ph"] == "X":
            if not isinstance(e.get("dur"), (int, float)) or e["dur"] < 0:
                raise ValueError(f"X event {i} needs dur >= 0: {e!r}")
        if e["ph"] in ("b", "e"):
            if "id" not in e:
                raise ValueError(f"async event {i} missing id: {e!r}")
            key = (e["pid"], e["cat"], e["id"])
            open_async[key] = open_async.get(key, 0) + (
                1 if e["ph"] == "b" else -1)
    bad = {k: v for k, v in open_async.items() if v != 0}
    if bad:
        raise ValueError(f"unbalanced async b/e pairs: {bad}")


class TimelineHook(RoundHook):
    """Record a run's timeline (see module docstring) and publish the
    wall split on the bus.

    ``path`` (optional) writes the Chrome trace JSON when the run report
    is assembled; pass ``timeline=`` to accumulate several runs (or a
    run + a profile pass) into one artifact. No round-side capture: the
    run is bit-identical with this hook attached; the session
    driver feeds host spans through the duck-typed ``segment_span``.
    """

    def __init__(self, path: str | None = None, *,
                 timeline: Timeline | None = None, bus: Any = None):
        self.timeline = timeline if timeline is not None else Timeline()
        self.path = path
        self.bus = bus
        self._segments: list[tuple[int, int, float, float]] = []
        self._async: list[tuple[int, dict[str, np.ndarray]]] = []

    # -- RoundHook lifecycle -------------------------------------------------

    def prepare(self, ctx: RunContext) -> None:
        self._segments = []
        self._async = []
        self.timeline.meta.update({
            "algorithm": ctx.algorithm, "n_nodes": ctx.n_nodes,
            "rounds_requested": ctx.rounds, "d_s": ctx.d_s,
            "schedule": getattr(ctx.plan, "schedule", None),
            "max_delay": getattr(getattr(ctx.plan, "delays", None),
                                 "max_delay", 0)})

    def consume(self, rows: dict[str, Any], *, t0: int) -> None:
        keep = {k: np.asarray(rows[k]) for k in _ASYNC_ROWS if k in rows}
        if keep:
            self._async.append((t0, keep))

    def segment_span(self, *, t0: int, n: int, start: float,
                     execute_end: float, consume_end: float,
                     compiled: bool) -> None:
        """Called by ``Session._drive`` once per segment (duck-typed)."""
        name = "trace/compile+execute" if compiled else "execute"
        self.timeline.span(
            name, start, execute_end - start, pid=PID_HOST, tid=1,
            cat="segment",
            args={"t0": t0, "rounds": n, "compiled": bool(compiled)})
        self.timeline.span(
            "hook-consume", execute_end, consume_end - execute_end,
            pid=PID_HOST, tid=2, cat="segment",
            args={"t0": t0, "rounds": n})
        self._segments.append((t0, n, start, execute_end))
        bus = self.bus = _resolve_bus(self.bus)
        bus.observe("timeline.execute_s", execute_end - start,
                    round=t0 + n - 1)
        bus.observe("timeline.consume_s", consume_end - execute_end,
                    round=t0 + n - 1)

    def _round_ts(self, r: int) -> float:
        """Wall time of round ``r``: linear within its segment's execute
        window, extrapolated at the last segment's per-round rate for
        deliveries that land past the end of the run."""
        for t0, n, start, end in self._segments:
            if t0 <= r < t0 + n:
                return start + (r - t0) / n * (end - start)
        t0, n, start, end = self._segments[-1]
        return end + (r - (t0 + n)) * (end - start) / n

    def finish(self) -> None:
        if not self._segments:
            return
        tl = self.timeline
        for t0, rows in self._async:
            hist = rows.get("async_delay_hist")          # (n, B+1) i32
            touts = rows.get("async_timeouts")           # (n,) i32
            stale = rows.get("async_staleness_max")      # (n,) i32
            active = rows.get("async_active")            # (n,) i32
            mass = rows.get("async_inflight_mass")       # (n,) f32
            n = next(iter(rows.values())).shape[0]
            for i in range(n):
                r = t0 + i
                ts = self._round_ts(r)
                if hist is not None:
                    for d in range(hist.shape[1]):
                        c = int(hist[i, d])
                        if c <= 0:
                            continue
                        tl.async_span(
                            f"msg send->deliver (d={d})", ts,
                            self._round_ts(r + d) - ts,
                            args={"count": c, "delay_rounds": d,
                                  "enqueue_round": r,
                                  "deliver_round": r + d})
                if touts is not None and int(touts[i]) > 0:
                    tl.instant("msg send->timeout", ts, pid=PID_MSG,
                               cat="async_msg",
                               args={"count": int(touts[i]), "round": r})
                vals: dict[str, float] = {}
                if mass is not None:
                    vals["inflight_mass"] = float(mass[i])
                if active is not None:
                    vals["active_nodes"] = float(active[i])
                if stale is not None:
                    vals["staleness_max"] = float(stale[i])
                if vals:
                    tl.counter("async", ts, vals)
        self._async = []

    def finish_run(self, report: Any) -> None:
        """Post-report lifecycle: run-level wall-split gauges + artifact."""
        bus = self.bus = _resolve_bus(self.bus)
        bus.gauge("run.compile_s", float(report.compile_s))
        bus.gauge("run.run_s", float(report.run_s))
        self.timeline.meta.update({
            "rounds": report.rounds,
            "compile_s": round(float(report.compile_s), 6),
            "run_s": round(float(report.run_s), 6),
            "aborted": bool(report.aborted)})
        if self.path is not None:
            self.timeline.save(self.path)
