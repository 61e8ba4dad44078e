"""The traced window: ``torch.profiler`` over it, and the records that the
per-layer metrics read.

Records (a dict):

* ``kernels``: {device event name: [events, seconds]} of the window;
* ``phases``: device seconds by the program's phase ranges
  (``repro_torch.obs.trace.phase_breakdown``: each device event belongs
  to the outermost phase range open on the host when it was launched);
* ``busy_s``: seconds in which some device event ran (their union);
* ``launches``: the program's own count of its kernels' launches
  (``repro_torch.kernels.ops.launch_counts``) over the window;
* ``port_events``: device events of the program's kernels in the trace;
  ``complete`` is False where they fall short of ``launches`` (the
  profiler has dropped device events), and no share is read then;
* ``device_ops`` / ``idle_gaps``: the ten device operations that took
  most time, and the ten longest idle gaps of the device, each named by
  the host work (a phase range, else the outermost host op) open at the
  gap's start.
"""
from __future__ import annotations

import bisect
from typing import NamedTuple

# the profiler's own utility events, which ``prof.events()`` leaves out too
_UTILITY = {"[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
            "profiler::_record_function_enter_new",
            "profiler::_record_function_exit", "aten::is_leaf",
            "aten::output_nr", "aten::_version"}


class Span(NamedTuple):
    start: float
    end: float


class Event(NamedTuple):
    """The fields of a ``FunctionEvent`` that the readings here and
    ``repro_torch.obs.trace.attribute`` take, read straight from the
    profiler's raw results (times in microseconds from the trace's
    start)."""
    name: str
    device_type: object
    time_range: Span
    id: int
    linked_correlation_id: int
    is_user_annotation: bool


def raw_events(prof) -> list:
    """The finished profile's events as :class:`Event`, without building
    ``prof.events()``: its ``FunctionEvent`` objects and their tree take
    minutes over the hundreds of thousands of events of a training
    window, and nothing here reads the tree."""
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    out = []
    for e in results.events():
        name = e.name()
        if name in _UTILITY or getattr(e, "is_hidden_event",
                                       lambda: False)():
            continue
        out.append(Event(name, e.device_type(),
                         Span((e.start_ns() - t0) / 1000,
                              (e.end_ns() - t0) / 1000),
                         e.correlation_id(), e.linked_correlation_id(),
                         bool(e.is_user_annotation())))
    return out


class Tracer:
    """``start()`` before the window, ``stop()`` after its synchronise."""

    def __init__(self, torch):
        self.torch = torch
        from repro_torch.kernels import ops
        self.ops = ops
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self.prof.start()
        self.ops.reset_launch_counts()

    def stop(self) -> None:
        self.launches = dict(self.ops.launch_counts())
        self.prof.stop()

    def records(self) -> dict:
        from repro_torch.obs.trace import KNOWN_PHASES, phase_breakdown

        torch = self.torch
        events = raw_events(self.prof)
        cpu = torch.autograd.DeviceType.CPU
        device = [e for e in events if e.device_type != cpu
                  and e.name not in KNOWN_PHASES
                  and not getattr(e, "is_user_annotation", False)]
        kernels: dict[str, list] = {}
        spans = []
        for e in device:
            t0, t1 = e.time_range.start, e.time_range.end
            spans.append((t0, t1))
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += (t1 - t0) * 1e-6
        spans.sort()
        busy, merged = 0.0, []
        for t0, t1 in spans:
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        busy = sum(t1 - t0 for t0, t1 in merged) * 1e-6
        phases, _, note = phase_breakdown(events, device="cuda")
        port = sum(1 for e in device if "repro_torch::" in e.name)
        launched = sum(self.launches.values())
        host = _HostWork(events, cpu, KNOWN_PHASES)
        gaps = []
        for (a0, a1), (b0, _) in zip(merged, merged[1:]):
            gaps.append((host.at(a1), (b0 - a1) * 1e-6))
        gaps.sort(key=lambda g: -g[1])
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
        return dict(kernels=kernels, phases=phases, phase_note=note,
                    busy_s=busy, launches=self.launches, port_events=port,
                    complete=port >= launched and note is None,
                    device_ops=[[name, v[1]] for name, v in top[:10]],
                    idle_gaps=[[name, s] for name, s in gaps[:10]])


class _HostWork:
    """What the host was doing at a time: the outermost phase range open
    then, else the outermost host op open then."""

    def __init__(self, events, cpu, phases):
        host = sorted(((e.time_range.start, e.time_range.end, e.name)
                       for e in events if e.device_type == cpu),
                      key=lambda x: (x[0], -x[1]))
        self.ranges = [self._outer([h for h in host if h[2] in phases]),
                       self._outer(host)]

    @staticmethod
    def _outer(items):
        starts, spans = [], []
        for t0, t1, name in items:
            if spans and t0 < spans[-1][0]:
                continue
            starts.append(t0)
            spans.append((t1, name))
        return starts, spans

    def at(self, ts: float) -> str:
        for starts, spans in self.ranges:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts < spans[i][0]:
                return spans[i][1]
        return "host idle between calls"
