"""Health watchdogs: round-side diagnostics, host-side judgement (port of
``repro.obs.watchdog``).

A protocol run can rot silently: a NaN on the wire poisons every
neighbour within one gossip round, push-sum mass can leak under a buggy
mixing matrix, consensus can diverge while the loss still prints, and a
broken sensitivity estimator under-noises the wire (the failure Remark 1
rules out, so seeing it means the guarantee is void).

:class:`WatchdogHook` watches all of them. The first three read the
``wd_*`` diagnostics a round adds when a hook declares
``needs_wire_stats`` (:func:`repro_torch.core.dpps.dpps_step` computes
them on the device each round: the non-finite count over the wire
buffer, the ``|mean(a) - 1|`` mass drift and the consensus residual of
the corrected iterates); the sensitivity check compares the
``sensitivity_real`` rows against the broadcast estimate whenever a
:class:`repro_torch.api.hooks.RealSensitivityHook` rides the same
pipeline; async runs add the staleness and participation checks on the
``async_*`` rows, and a stateful wire codec the residual trend on
``wd_wire_resid``. Judgement happens at segment boundaries on the host:
findings become :class:`Alert` records, warned through the obs logger and
published to the bus as ``alert`` events. ``strict=True`` mirrors
``BudgetHook.strict``: a critical finding raises :class:`WatchdogAbort`
(a :class:`repro_torch.api.hooks.RunAbort`) at the boundary, and the
session reports ``aborted=True``.

Without this hook no ``wd_*`` row is computed, and with it the protocol
state's trajectory is unchanged: the rows are only read.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from repro_torch.api.hooks import (RoundHook, RunAbort, _default_sink,
                                   _resolve_bus)

__all__ = ["Alert", "WatchdogAbort", "WatchdogHook"]

# checks -> severity: critical findings abort under strict=True, warnings
# never do (mass drift and a rising residual are degradation signals; a
# non-finite wire or a violated sensitivity bound is a broken run).
_SEVERITY = {
    "nonfinite_wire": "critical",
    "sensitivity_gap": "critical",
    "mass_drift": "warn",
    "residual_trend": "warn",
    # Async runtime (ProtocolPlan.delays): a message older than the
    # staleness bound B surviving to delivery, or a node silent for
    # longer than its rate explains, are both broken-runtime findings.
    "staleness_bound": "critical",
    "participation_gap": "critical",
    # Wire compression (ProtocolPlan.wire): a stateful codec's
    # error-feedback residual should stay bounded — top-k is a
    # contraction, so a rising residual means the compressor is falling
    # behind the iterates (degradation, not breakage).
    "wire_residual": "warn",
}


@dataclasses.dataclass(frozen=True)
class Alert:
    """One watchdog finding, surfaced at a segment boundary."""

    round: int
    check: str       # nonfinite_wire | mass_drift | residual_trend | sensitivity_gap
    severity: str    # "warn" | "critical"
    value: float
    threshold: float
    message: str


class WatchdogAbort(RunAbort):
    """Raised by a strict :class:`WatchdogHook` on a critical finding;
    the session catches it at the segment boundary and reports
    ``aborted=True`` (same enforcement granularity as the budget)."""

    def __init__(self, message: str, alert: Alert):
        super().__init__(message)
        self.alert = alert


class WatchdogHook(RoundHook):
    """Watch the run's health (module docstring). Thresholds:

    * ``mass_tol``      — ``|mean(a) - 1|`` above this warns (push-sum
      with column-stochastic W conserves total mass exactly; drift is
      f32 rounding, so the default is generous at 1e-3).
    * ``trend_window`` / ``trend_factor`` — the consensus residual's
      trailing window; when the newer half's mean exceeds
      ``trend_factor`` x the older half's, consensus is diverging.
    * ``gap_tol``       — slack on real > estimate sensitivity violations
      (matches :class:`RealSensitivityHook`'s tolerance).
    * ``participation_window`` — async runs only: rounds a node may go
      without participating before the participation-gap check fires.
      ``None`` derives it at ``prepare`` from the plan's
      :class:`repro_torch.net.DelayModel` rates (``2 * max rate`` —
      twice what the declared heterogeneity explains).

    Async runs (``ProtocolPlan.delays``) add two checks on the
    trajectory's ``async_*`` rows: a delivered message whose assigned
    delay exceeds the staleness bound ``B`` (impossible by construction —
    seeing it means the mailbox runtime is broken) and a node silent for
    longer than ``participation_window`` rounds. Both are critical and
    abort under ``strict=True``.

    Wire-compression runs (``ProtocolPlan.wire`` with a stateful codec —
    top-k + error feedback) add a warn-only bounded-residual check on the
    ``wd_wire_resid`` rows: the same trailing-window trend test as the
    consensus residual, on the mean per-node L1 of the codec's
    error-feedback residual.

    ``alerts`` accumulates every finding; each is warned once through
    ``warn`` (default: the obs logger) and published to ``bus`` as an
    ``alert`` event named ``watchdog.<check>``.
    """

    needs_wire_stats = True

    def __init__(self, *, strict: bool = False, mass_tol: float = 1e-3,
                 trend_window: int = 20, trend_factor: float = 4.0,
                 gap_tol: float = 1e-6,
                 participation_window: int | None = None,
                 warn: Callable[[str], None] | None = None,
                 bus: Any = None):
        self.strict = strict
        self.mass_tol = mass_tol
        self.trend_window = max(int(trend_window), 2)
        self.trend_factor = trend_factor
        self.gap_tol = gap_tol
        self.participation_window = participation_window
        self.warn = warn if warn is not None else _default_sink()
        self.bus = bus
        self.alerts: list[Alert] = []
        self._residuals: list[float] = []
        self._trend_round: int | None = None  # last round a trend fired at
        self._wire_resid: list[float] = []    # EF residual L1 (wire codecs)
        self._wire_round: int | None = None
        self._staleness_bound: int | None = None  # plan's B (async runs)
        self._part_gap = None  # (N,) rounds-since-participation, cross-segment

    def prepare(self, ctx) -> None:
        delays = getattr(getattr(ctx, "plan", None), "delays", None)
        if delays is None:
            return
        self._staleness_bound = int(delays.max_delay)
        if self.participation_window is None:
            max_rate = max(delays.rates) if delays.rates else 1
            self.participation_window = max(2, 2 * int(max_rate))

    # -- findings ------------------------------------------------------------

    def _raise_alert(self, check: str, round_: int, value: float,
                     threshold: float, message: str) -> Alert:
        alert = Alert(round=round_, check=check, severity=_SEVERITY[check],
                      value=float(value), threshold=float(threshold),
                      message=message)
        self.alerts.append(alert)
        self.warn(f"WATCHDOG[{alert.severity}] {message}")
        bus = self.bus = _resolve_bus(self.bus)
        bus.alert(f"watchdog.{check}", message, value=alert.value,
                  round=round_, labels=(("severity", alert.severity),))
        return alert

    def consume(self, rows: dict[str, Any], *, t0: int) -> None:
        critical: Alert | None = None

        nonfinite = np.asarray(rows["wd_nonfinite"])
        bad = np.flatnonzero(nonfinite > 0)
        if bad.size:
            t = t0 + int(bad[0])
            alert = self._raise_alert(
                "nonfinite_wire", t, float(nonfinite[bad[0]]), 0.0,
                f"round {t}: {int(nonfinite[bad[0]])} non-finite elements "
                "on the wire buffer (noised message)")
            critical = critical or alert

        mass = np.asarray(rows["wd_mass_drift"])
        worst = int(np.argmax(mass))
        if mass[worst] > self.mass_tol:
            t = t0 + worst
            self._raise_alert(
                "mass_drift", t, float(mass[worst]), self.mass_tol,
                f"round {t}: push-sum mass drift |mean(a)-1|="
                f"{float(mass[worst]):.3e} exceeds {self.mass_tol:.1e}")

        self._residuals.extend(
            np.asarray(rows["wd_consensus_residual"]).tolist())
        trend = self._check_trend(t0 + len(np.atleast_1d(mass)) - 1)
        if trend is not None:
            self._raise_alert(*trend)

        if "wd_wire_resid" in rows:
            self._wire_resid.extend(
                np.asarray(rows["wd_wire_resid"]).tolist())
            wtrend = self._check_wire_resid(
                t0 + len(np.atleast_1d(mass)) - 1)
            if wtrend is not None:
                self._raise_alert(*wtrend)

        if "sensitivity_real" in rows and "sensitivity_estimate" in rows:
            real = np.asarray(rows["sensitivity_real"])
            est = np.asarray(rows["sensitivity_estimate"])
            viol = np.flatnonzero(real > est + self.gap_tol)
            if viol.size:
                t = t0 + int(viol[0])
                alert = self._raise_alert(
                    "sensitivity_gap", t, float(real[viol[0]]),
                    float(est[viol[0]]),
                    f"round {t}: real sensitivity {float(real[viol[0]]):.4f}"
                    f" exceeds the broadcast estimate "
                    f"{float(est[viol[0]]):.4f} — the Remark-1 bound is "
                    "violated and the round is under-noised")
                critical = critical or alert

        if "async_staleness_max" in rows:
            critical = self._check_async(rows, t0) or critical

        if self.strict and critical is not None:
            raise WatchdogAbort(
                f"watchdog critical: {critical.message}", critical)

    def _check_async(self, rows: dict[str, Any], t0: int) -> Alert | None:
        """Async-runtime checks: staleness bound + participation gap."""
        critical: Alert | None = None
        bound = self._staleness_bound
        if bound is None:
            # A plan-less (loop) run still carries the rows; trust them.
            bound = int(np.asarray(rows["async_delay_hist"]).shape[-1]) - 1
        stale = np.asarray(rows["async_staleness_max"])
        viol = np.flatnonzero(stale > bound)
        if viol.size:
            t = t0 + int(viol[0])
            critical = self._raise_alert(
                "staleness_bound", t, float(stale[viol[0]]), float(bound),
                f"round {t}: a delivered message carries staleness "
                f"{int(stale[viol[0]])} > bound B={bound} — the mailbox "
                "runtime is broken (delays are drawn in {0..B})")
        part = np.asarray(rows["async_participated"], dtype=bool)  # (T, N)
        if self._part_gap is None:
            self._part_gap = np.zeros((part.shape[1],), dtype=np.int64)
        window = self.participation_window or 2
        for i in range(part.shape[0]):
            self._part_gap = np.where(part[i], 0, self._part_gap + 1)
            worst = int(np.argmax(self._part_gap))
            if self._part_gap[worst] > window:
                t = t0 + i
                critical = critical or self._raise_alert(
                    "participation_gap", t, float(self._part_gap[worst]),
                    float(window),
                    f"round {t}: node {worst} has not participated for "
                    f"{int(self._part_gap[worst])} rounds (> window "
                    f"{window}) — it is effectively down, not just slow")
                self._part_gap[worst] = 0  # one finding per outage, not per round
        return critical

    def _check_wire_resid(self, t_last: int):
        """Rising error-feedback-residual check (stateful wire codecs).

        Same trailing-window shape as :meth:`_check_trend`, on the
        ``wd_wire_resid`` rows ``dpps_step`` emits when a stateful codec
        (top-k + error feedback) is on the wire: mean per-node L1 of the
        residual. A bounded residual tracks the iterate scale; a
        sustained rise means compression error is accumulating faster
        than the feedback re-injects it.
        """
        w = self.trend_window
        if len(self._wire_resid) < w:
            return None
        if self._wire_round is not None and t_last - self._wire_round < w:
            return None
        tail = np.asarray(self._wire_resid[-w:])
        older, newer = tail[: w // 2].mean(), tail[w // 2:].mean()
        if older > 0.0 and newer > self.trend_factor * older:
            self._wire_round = t_last
            return ("wire_residual", t_last, float(newer),
                    float(self.trend_factor * older),
                    f"round {t_last}: wire-codec error-feedback residual "
                    f"rising — trailing mean L1 {newer:.3e} vs {older:.3e} "
                    f"a half-window ago (> {self.trend_factor:g}x); the "
                    "compressor is falling behind the iterates")
        return None

    def _check_trend(self, t_last: int):
        """Rising-consensus-residual check over the trailing window."""
        w = self.trend_window
        if len(self._residuals) < w:
            return None
        if self._trend_round is not None and t_last - self._trend_round < w:
            return None  # one finding per window, not one per segment
        tail = np.asarray(self._residuals[-w:])
        older, newer = tail[: w // 2].mean(), tail[w // 2:].mean()
        if older > 0.0 and newer > self.trend_factor * older:
            self._trend_round = t_last
            return ("residual_trend", t_last, float(newer),
                    float(self.trend_factor * older),
                    f"round {t_last}: consensus residual rising — trailing "
                    f"mean {newer:.3e} vs {older:.3e} a half-window ago "
                    f"(> {self.trend_factor:g}x)")
        return None
