"""RoundHook — the observer pipeline of the session API (port of
``repro.api.hooks``).

A hook couples one round-side capture with one host-side consumer:

* ``capture(diag) -> dict | None`` runs on every round's diagnostics
  (device tensors) in the drivers; whatever it returns is stacked into
  extra ``(T, ...)`` trajectory leaves beside the engine's own metrics.
* ``consume(rows, *, t0)`` runs on the host at every segment boundary with
  the segment's stacked trajectory as numpy arrays (``t0`` the segment's
  first absolute round): JSONL streaming, budget enforcement, logging.

Four declarations tell the drivers what a round must provide (collected
into a :class:`TraceSpec` by :func:`hook_trace_spec`): ``tap`` (a
:class:`repro_torch.audit.transcript.TranscriptTap`, which
:class:`TranscriptHook` carries), ``needs_s_half`` (the perturbed pre-noise state
``s^(t+1/2)`` in the diagnostics), ``needs_adjacency`` (the realized
adjacency under faults: :class:`repro_torch.net.NetworkStatsHook`) and ``needs_wire_stats`` (the ``wd_*``
health diagnostics). With no hooks the rounds are the hook-free ones; with
hooks the protocol state's trajectory is unchanged, since hooks only add
rows.

The lifecycle around a run, as in the reference: ``prepare(ctx)`` once
before the first segment (the :class:`RunContext` carries the resolved
config, so hooks default their b, gamma_n and sync interval from the
session), then capture and consume per segment, then ``finish()`` in a
``finally``, then ``finish_run(report)`` once the
:class:`repro_torch.api.results.RunReport` exists. A hook with a
``segment_span(t0=, n=, start=, execute_end=, consume_end=, compiled=)``
method gets per-segment host timing, and the driver then synchronizes the
card at every segment boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np

from repro_torch.core.dpps import DPPSConfig, is_sync_round
from repro_torch.core.privacy import PrivacyAccountant
from repro_torch.core.sensitivity import real_sensitivity
from repro_torch.audit.ledger import PrivacyLedger
from repro_torch.obs.metrics import default_bus, log_sink

__all__ = [
    "RoundHook",
    "RunContext",
    "TraceSpec",
    "capture_rows",
    "TranscriptHook",
    "LedgerHook",
    "BudgetHook",
    "RealSensitivityHook",
    "MetricsHook",
    "RunAbort",
    "BudgetExhausted",
    "hook_trace_spec",
]


def _default_sink() -> Callable[[str], None]:
    """The obs logger's INFO sink."""
    return log_sink


def _resolve_bus(bus: Any) -> Any:
    """``bus=None`` -> the process-wide default bus."""
    return default_bus() if bus is None else bus


@dataclasses.dataclass(frozen=True)
class RunContext:
    """What a hook may read about the run it is attached to (``prepare``)."""

    cfg: DPPSConfig            # the resolved protocol config of this run
    plan: Any                  # ProtocolPlan (None for plan-less loop runs)
    n_nodes: int
    rounds: int                # rounds requested (not necessarily executed)
    algorithm: str = "dpps"
    protected: bool = True     # noise on (cfg.noise and gamma_n > 0)
    d_s: int = 0               # shared wire dimension (per-node scalars)


class RoundHook:
    """Base hook: every method is optional; defaults are no-ops.

    Subclasses override ``capture`` (pure: return a dict of new trajectory
    leaves or None) and/or ``consume`` (host side effects).
    """

    tap: Any = None            # TranscriptTap to thread into dpps_step
    needs_s_half: bool = False  # request s^(t+1/2) in the diagnostics
    needs_adjacency: bool = False   # realized (N, N) adjacency under faults
    needs_wire_stats: bool = False  # the round's health diagnostics (wd_*)

    def prepare(self, ctx: RunContext) -> None:  # noqa: B027 — optional
        pass

    def capture(self, diag: dict[str, Any]) -> dict[str, Any] | None:
        return None

    def consume(self, rows: dict[str, Any], *, t0: int) -> None:  # noqa: B027
        pass

    def finish(self) -> None:  # noqa: B027 — optional
        pass

    def finish_run(self, report: Any) -> None:  # noqa: B027 — optional
        """Called once after the driver assembled the run's
        :class:`repro_torch.api.results.RunReport` (aborted runs included) —
        the place to publish run-level figures that only exist after the
        wall-clock split is known."""


def capture_rows(diag: dict[str, Any], hooks) -> dict[str, Any]:
    """Round diagnostics -> emitted trajectory rows, hook captures merged.

    ``s_half`` (the pre-noise perturbed state, present when a
    ``needs_s_half`` hook requested it) is visible to the hooks' capture
    but never emitted itself: it is the full (N, d) shared state, T
    copies of which would dwarf the metrics. Both drivers (the engine's
    round loop in :mod:`repro_torch.engine.rounds` and the session's
    per-round loop) run this one merge.
    """
    view = dict(diag)
    out = {k: v for k, v in view.items() if k != "s_half"}
    for hook in hooks:
        extra = hook.capture(view)
        if extra:
            out.update(extra)
    return out


class TraceSpec(NamedTuple):
    """Everything the compiled round must provide for a hook pipeline.

    The four switches of the base class, reduced over the pipeline: the
    (at most one) transcript tap, and the three or-folded request flags.
    Both drivers (the engine and the session's per-round loop) derive what
    a round provides from this one spec.
    """

    tap: Any
    needs_s_half: bool
    needs_adjacency: bool
    needs_wire_stats: bool


def hook_trace_spec(hooks) -> TraceSpec:
    """The :class:`TraceSpec` the round must provide for ``hooks``.

    The one place both drivers derive their switches from the pipeline;
    enforces the at-most-one-tap rule. Flags are read with ``getattr`` so
    duck-typed hooks keep working.
    """
    taps = [h.tap for h in hooks if getattr(h, "tap", None) is not None]
    if len(taps) > 1:
        raise ValueError(
            f"{len(taps)} hooks carry a transcript tap; at most one "
            "tap-bearing hook per run (taps share the tap_* namespace)")
    return TraceSpec(
        tap=taps[0] if taps else None,
        needs_s_half=any(getattr(h, "needs_s_half", False) for h in hooks),
        needs_adjacency=any(getattr(h, "needs_adjacency", False)
                            for h in hooks),
        needs_wire_stats=any(getattr(h, "needs_wire_stats", False)
                             for h in hooks))


# ---------------------------------------------------------------------------
# Built-in hooks
# ---------------------------------------------------------------------------


class TranscriptHook(RoundHook):
    """Record the wire-visible transcript.

    The capture happens inside ``dpps_step`` (the tap's ``tap_*`` rows are
    part of the round's diagnostics), so ``capture`` adds nothing;
    ``consume`` keeps each segment's ``tap_*`` rows and ``transcript()``
    reassembles them into a round-indexed
    :class:`repro_torch.audit.transcript.Transcript`. Both drivers (the
    engine and the per-round loop) thread the tap alike.
    """

    def __init__(self, tap: Any = None):
        from repro_torch.audit.transcript import TranscriptTap

        self.tap = TranscriptTap() if tap is None else tap
        self._segments: list[dict[str, np.ndarray]] = []

    def consume(self, rows: dict[str, Any], *, t0: int) -> None:
        self._segments.append({k: np.asarray(v) for k, v in rows.items()
                               if k.startswith("tap_")})

    def transcript(self):
        from repro_torch.audit.transcript import Transcript

        if not self._segments:
            raise ValueError("no segments consumed yet")
        keys = self._segments[0].keys()
        return Transcript.from_trajectory(
            {k: np.concatenate([s[k] for s in self._segments]) for k in keys})


class RealSensitivityHook(RoundHook):
    """Track the exact network sensitivity per round (paper Fig. 2 /
    Table III validation).

    ``chunk=`` bounds the O(N^2 d) pairwise buffer to blocks of ``chunk``
    rows (:func:`repro_torch.core.sensitivity.real_sensitivity`; a no-op
    at N <= chunk). ``reals`` / ``violations`` accumulate the consumed
    values on the host (a violation: the real value exceeding the
    estimate, which Remark 1 says must not happen).
    """

    needs_s_half = True

    def __init__(self, chunk: int = 16):
        self.chunk = chunk
        self.reals: list[float] = []
        self.violations = 0

    def capture(self, diag: dict[str, Any]) -> dict[str, Any]:
        return {"sensitivity_real":
                real_sensitivity(diag["s_half"], chunk=self.chunk)}

    def consume(self, rows: dict[str, Any], *, t0: int) -> None:
        real = np.asarray(rows["sensitivity_real"])
        est = np.asarray(rows["sensitivity_estimate"])
        self.reals.extend(real.tolist())
        self.violations += int(np.sum(real > est + 1e-6))


class LedgerHook(RoundHook):
    """Stream the per-round privacy ledger.

    Builds the ledger from the run context at ``prepare`` (b, gamma_n,
    algorithm and sync cadence come from the session's resolved config);
    records every consumed segment through
    :meth:`PrivacyLedger.record_trajectory`; closes the JSONL on finish.
    Pass a pre-built ``ledger=`` to keep ownership outside the hook.

    Also a bus producer: each consumed segment publishes
    ``privacy.rounds`` (counter) and ``privacy.epsilon_total`` (gauge) to
    ``bus`` (default: the process bus). The ledger JSONL itself is
    untouched — byte-identical to the pre-bus format.
    """

    def __init__(self, path: str | None = None, budget: float | None = None,
                 mechanism: str = "laplace", ledger: Any = None,
                 bus: Any = None):
        self.path = path
        self.budget = budget
        self.mechanism = mechanism
        self.ledger = ledger
        self.bus = bus
        self._protected = True
        self._sync_interval = 0

    def prepare(self, ctx: RunContext) -> None:
        if self.ledger is None:
            codec = getattr(ctx.plan, "wire", None) \
                if ctx.plan is not None else None
            d_s = int(getattr(ctx, "d_s", 0) or 0)
            if codec is not None and getattr(codec, "active", False):
                wire_codec = codec.name
                bytes_edge = int(codec.payload_bytes(d_s)) if d_s else None
            else:
                # a raw wire: the bytes are implied by the dtype, so the
                # per-edge figure stays unset, as the reference leaves it
                wire_codec = ctx.cfg.wire_dtype
                bytes_edge = None
            self.ledger = PrivacyLedger(
                b=ctx.cfg.b, gamma_n=ctx.cfg.gamma_n, budget=self.budget,
                mechanism=self.mechanism, path=self.path,
                algorithm=ctx.algorithm, wire_dtype=ctx.cfg.wire_dtype,
                wire_codec=wire_codec, wire_bytes_per_edge=bytes_edge)
        self._protected = ctx.protected
        self._sync_interval = ctx.cfg.sync_interval

    def consume(self, rows: dict[str, Any], *, t0: int) -> None:
        self.ledger.record_trajectory(
            rows, t0=t0, protected=self._protected,
            sync_interval=self._sync_interval)
        n = int(np.asarray(rows["sensitivity_estimate"]).shape[0])
        bus = self.bus = _resolve_bus(self.bus)
        bus.count("privacy.rounds", n, round=t0 + n - 1)
        bus.gauge("privacy.epsilon_total",
                  float(self.ledger.accountant.epsilon_total),
                  round=t0 + n - 1)

    def finish(self) -> None:
        if self.ledger is not None:
            self.ledger.close()

    def summary(self) -> dict[str, Any]:
        return self.ledger.summary()


class RunAbort(RuntimeError):
    """Base of the hook-raised abort family: the session driver catches
    it at segment boundaries, stops the run, and reports ``aborted=True``
    with the message as ``abort_reason``. Subclasses:
    :class:`BudgetExhausted` (strict privacy budget) and
    ``WatchdogAbort`` (strict health watchdog,
    :mod:`repro_torch.obs.watchdog`)."""


class BudgetExhausted(RunAbort):
    """Raised by a strict :class:`BudgetHook` once the epsilon ceiling is
    crossed; the session catches it, stops the run, and reports
    ``aborted=True`` (over-budget parameters are never released)."""

    def __init__(self, message: str, round_: int, epsilon_total: float):
        super().__init__(message)
        self.round = round_
        self.epsilon_total = epsilon_total


class BudgetHook(RoundHook):
    """Enforce a total-epsilon ceiling (the ``--privacy-budget`` /
    ``--strict-budget`` logic of launch/train.py, as a hook).

    Steps a :class:`PrivacyAccountant` per consumed round (sync rounds are
    unprotected and spend nothing). On first exceeding the budget it warns
    once through ``warn`` — default: the obs logger
    (:func:`repro_torch.obs.log_sink`), so quiet/structured drivers capture it
    through standard ``logging``; inject a callable (e.g. ``print`` or a
    list's ``append``) to override. With ``strict=True`` it raises
    :class:`BudgetExhausted` at the segment boundary — the engine driver's
    enforcement granularity.
    """

    def __init__(self, budget: float, *, strict: bool = False,
                 warn: Callable[[str], None] | None = None, note: str = ""):
        self.budget = budget
        self.strict = strict
        self.warn = warn if warn is not None else _default_sink()
        self.note = note
        self.exceeded_at: int | None = None
        self.accountant: PrivacyAccountant | None = None
        self._protected = True
        self._sync_interval = 0

    def prepare(self, ctx: RunContext) -> None:
        self.accountant = PrivacyAccountant(
            b=ctx.cfg.b, gamma_n=ctx.cfg.gamma_n, budget=self.budget)
        self._protected = ctx.protected
        self._sync_interval = ctx.cfg.sync_interval

    def consume(self, rows: dict[str, Any], *, t0: int) -> None:
        n = int(np.asarray(rows["sensitivity_estimate"]).shape[0])
        for i in range(n):
            t = t0 + i
            protected = (self._protected
                         and not is_sync_round(t, self._sync_interval))
            self.accountant = self.accountant.step(protected=protected)
            if self.accountant.exhausted and self.exceeded_at is None:
                self.exceeded_at = t
                self.warn(
                    f"WARNING: privacy budget {self.budget} exceeded at "
                    f"round {t} (epsilon_total="
                    f"{self.accountant.epsilon_total:.3f}){self.note}")
        if self.strict and self.exceeded_at is not None:
            raise BudgetExhausted(
                f"privacy budget {self.budget} exhausted at round "
                f"{self.exceeded_at}", self.exceeded_at,
                self.accountant.epsilon_total)


class MetricsHook(RoundHook):
    """Host-side metric logging. ``fields`` maps output names to
    trajectory keys; every round lands in ``history`` and is printed every
    ``log_every`` rounds (plus the final round when ``total`` is known)
    through ``formatter``.

    ``print_fn`` defaults to the obs logger
    (:func:`repro_torch.obs.log_sink`): the same lines on stdout, but
    capturable and silenceable through standard ``logging``; inject any
    callable to override (tests pass ``lines.append``). Each history row is also published to ``bus``
    (default: the process bus) as ``metrics.<name>`` gauges.
    """

    def __init__(self, fields: dict[str, str] | None = None,
                 log_every: int = 10, total: int | None = None,
                 formatter: Callable[[dict[str, Any]], str] | None = None,
                 print_fn: Callable[[str], None] | None = None,
                 bus: Any = None):
        self.fields = fields or {"loss": "loss_mean",
                                 "sensitivity": "sensitivity_used"}
        self.log_every = max(int(log_every), 1)
        self.total = total
        self.formatter = formatter or self._default_format
        self.print_fn = print_fn if print_fn is not None else _default_sink()
        self.bus = bus
        self.history: list[dict[str, Any]] = []

    @staticmethod
    def _default_format(row: dict[str, Any]) -> str:
        vals = " ".join(f"{k}={v:.4f}" for k, v in row.items() if k != "step")
        return f"step {row['step']:5d} {vals}"

    def consume(self, rows: dict[str, Any], *, t0: int) -> None:
        cols = {name: np.asarray(rows[key])
                for name, key in self.fields.items() if key in rows}
        if not cols:
            return
        n = next(iter(cols.values())).shape[0]
        bus = self.bus = _resolve_bus(self.bus)
        for i in range(n):
            row = {"step": t0 + i,
                   **{name: float(col[i]) for name, col in cols.items()}}
            self.history.append(row)
            t = row["step"]
            for name, value in row.items():
                if name != "step":
                    bus.gauge(f"metrics.{name}", value, round=t)
            if t % self.log_every == 0 or (self.total is not None
                                           and t == self.total - 1):
                self.print_fn(self.formatter(row))

    def finish_run(self, report: Any) -> None:
        """Publish the report's wall-clock split as ``run.compile_s`` /
        ``run.run_s`` gauges — exporters and the cross-run registry read
        the split off the bus instead of parsing RunReports."""
        bus = self.bus = _resolve_bus(self.bus)
        bus.gauge("run.compile_s", float(report.compile_s))
        bus.gauge("run.run_s", float(report.run_s))
