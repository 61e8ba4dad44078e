"""Phase tracing: named ranges on the round phases, and the profile's
per-phase breakdown (port of ``repro.obs.trace``).

:func:`phase` is the annotation the protocol code wraps its phases in. It
registers the name in :data:`KNOWN_PHASES` and, while a
``torch.profiler`` session is recording, opens a
``torch.profiler.record_function`` range of that name. With no profiler
on it returns one shared no-op context: a ``record_function`` costs host
time even when nothing records it, and the hot path pays only the check.

The breakdown (:func:`phase_breakdown`) stands in for the reference's join
of XLA's ``op_name`` metadata against the xplane trace (``hlo_phase_map``,
``xplane_durations``), which have no PyTorch counterpart. It reads the
events of one ``torch.profiler.profile`` run:

* on the card, every device event (kernel, memcpy, memset) counts its
  duration; it is placed at the host time of the runtime call that
  launched it (the ``cuda*`` event of the same correlation id, else the
  CPU op it is linked to). The profiler also draws each phase range on
  the device timeline, over the kernels it launched; those spans are not
  device work and are left out;
* on the CPU, every op counts its self time, placed at its start.

**The attribution rule: outermost.** An event belongs to the outermost
registered phase range open on the host at its time, as the reference
takes the first phase name on an op's ``op_name`` path. So
``pushsum_mix`` (which nests in ``dpps_gossip``) attributes to
``dpps_gossip``, and a phase only named inside another never appears.
Time is the key, not the thread: the backward pass of a training step runs
on autograd's threads while the calling thread waits inside its phase.
Anything outside every phase is ``"unattributed"``; the phases sum to
``device_total_s``. A phase whose range was entered but launched nothing
(a view-only unpack on the card) is listed with 0.0.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Any, Iterable

import torch

__all__ = [
    "KNOWN_PHASES",
    "PHASE_DPPS_PERTURB",
    "PHASE_DPPS_SENSITIVITY",
    "PHASE_DPPS_NOISE",
    "PHASE_DPPS_GOSSIP",
    "PHASE_DPPS_SYNC",
    "PHASE_DPPS_WIRE_STATS",
    "PHASE_PUSHSUM_MIX",
    "PHASE_GRADS_LOCAL",
    "PHASE_GRADS_SHARED",
    "PHASE_CLIP",
    "PHASE_PACK",
    "PHASE_UNPACK",
    "PHASE_FAULTS",
    "ProfileReport",
    "attribute",
    "phase",
    "phase_breakdown",
]

# Every phase name the protocol code has annotated (insertion ordered);
# the breakdown attributes time only to names registered here.
KNOWN_PHASES: dict[str, None] = {}

# The reference's vocabulary, string for string.
PHASE_DPPS_PERTURB = "dpps_perturb"
PHASE_DPPS_SENSITIVITY = "dpps_sensitivity"
PHASE_DPPS_NOISE = "dpps_noise"
PHASE_DPPS_GOSSIP = "dpps_gossip"
PHASE_DPPS_SYNC = "dpps_sync"
PHASE_DPPS_WIRE_STATS = "dpps_wire_stats"
PHASE_PUSHSUM_MIX = "pushsum_mix"   # nests inside dpps_gossip
PHASE_GRADS_LOCAL = "partpsp_local_grads"
PHASE_GRADS_SHARED = "partpsp_shared_grads"
PHASE_CLIP = "partpsp_clip"
PHASE_PACK = "engine_pack"
PHASE_UNPACK = "engine_unpack"
PHASE_FAULTS = "net_faults"

_NO_RANGE = contextlib.nullcontext()


def phase(name: str):
    """Annotate a round phase: ``with phase("dpps_gossip"): ...``.

    Registers ``name`` in :data:`KNOWN_PHASES`; returns
    ``torch.profiler.record_function(name)`` while a profiler records, and
    a shared no-op context otherwise.
    """
    KNOWN_PHASES.setdefault(name)
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_RANGE


@dataclasses.dataclass
class ProfileReport:
    """One profiled segment (see :meth:`repro_torch.api.Session.profile`).

    ``trace_s`` / ``compile_s`` / ``execute_s`` split the wall clock (eager
    PyTorch traces nothing: ``trace_s`` is 0.0, ``compile_s`` the warm-up
    round that builds and loads the kernels); ``phases`` maps phase name
    -> device seconds (plus ``"unattributed"``), summing to
    ``device_total_s``.
    """

    rounds: int
    backend: str
    trace_s: float
    compile_s: float
    execute_s: float
    phases: dict[str, float]
    device_total_s: float
    trace_dir: str | None = None
    note: str | None = None

    @property
    def wall_clock(self) -> float:
        return self.trace_s + self.compile_s + self.execute_s

    def summary(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "rounds": self.rounds,
            "backend": self.backend,
            "trace_s": round(self.trace_s, 4),
            "compile_s": round(self.compile_s, 4),
            "execute_s": round(self.execute_s, 4),
            "wall_clock_s": round(self.wall_clock, 4),
            "device_total_s": round(self.device_total_s, 4),
            "phases": {k: round(v, 6) for k, v in sorted(
                self.phases.items(), key=lambda kv: -kv[1])},
        }
        if self.note:
            out["note"] = self.note
        return out


def _is_cpu(event) -> bool:
    return event.device_type == torch.autograd.DeviceType.CPU


def _is_runtime(event) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``, ``cuLaunch*``,
    ``cudaMemcpyAsync``, ...): a host event of the launch's correlation."""
    return event.name.startswith("cu")


class _Ranges:
    """The outermost registered phase ranges on the host, for lookups by
    time."""

    def __init__(self, events: Iterable[Any]):
        ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in events
                        if _is_cpu(e) and e.name in KNOWN_PHASES)
        self.starts: list[float] = []
        self.spans: list[tuple[float, str]] = []
        for start, end, name in ranges:
            if self.spans and start < self.spans[-1][0]:
                continue  # nested in the last outermost range
            self.starts.append(start)
            self.spans.append((end, name))
        self.names = {name for _, name in self.spans}

    def at(self, ts: float) -> str:
        i = bisect.bisect_right(self.starts, ts) - 1
        if i >= 0 and ts < self.spans[i][0]:
            return self.spans[i][1]
        return "unattributed"


def attribute(events: Iterable[Any], *, device: str = "cuda"
              ) -> tuple[list[tuple[str, str, float]], set[str]]:
    """Each timed event of one profiled run with its phase ->
    ``([(event name, phase, seconds), ...], entered phases)`` (module
    docstring): the card's device events (``device="cuda"``) or the CPU
    ops' self time (``device="cpu"``). ``events`` are the
    ``FunctionEvent`` s of a finished ``torch.profiler.profile``
    (``prof.events()``)."""
    events = list(events)
    ranges = _Ranges(events)
    out: list[tuple[str, str, float]] = []
    if device == "cpu":
        for e in events:
            if _is_cpu(e) and e.name not in KNOWN_PHASES \
                    and not getattr(e, "is_user_annotation", False):
                out.append((e.name, ranges.at(e.time_range.start),
                            e.self_cpu_time_total * 1e-6))
        return out, ranges.names
    host = [e for e in events if _is_cpu(e)]
    launch = {e.id: e.time_range.start for e in host if _is_runtime(e)}
    ops = {e.id: e.time_range.start for e in host if not _is_runtime(e)}
    for e in events:
        if _is_cpu(e) or e.name in KNOWN_PHASES:
            continue  # host events; a phase's span on the device timeline
        ts = launch.get(e.id)
        if ts is None:
            ts = ops.get(getattr(e, "linked_correlation_id", 0) or -1)
        out.append((e.name, "unattributed" if ts is None else ranges.at(ts),
                    (e.time_range.end - e.time_range.start) * 1e-6))
    return out, ranges.names


def phase_breakdown(events: Iterable[Any], *, device: str = "cuda"
                    ) -> tuple[dict[str, float], float, str | None]:
    """The per-phase time of one profiled run -> ``(phases,
    device_total_s, note)``: :func:`attribute`'s events summed by phase,
    with every entered phase listed (0.0 when it ran nothing)."""
    timed, entered = attribute(events, device=device)
    phases = {name: 0.0 for name in entered}
    for _, key, seconds in timed:
        phases[key] = phases.get(key, 0.0) + seconds
    total = sum(seconds for _, _, seconds in timed)
    if total == 0.0:
        return {}, 0.0, (f"no {device} time in the profiler trace; "
                         "wall-clock split only")
    return phases, total, None
