"""Streaming per-round privacy ledger (port of ``repro.audit.ledger``).

Wraps :class:`repro_torch.core.privacy.PrivacyAccountant` with a
round-indexed record of what the deployment did: the epsilon spent, the
sensitivity estimate the noise was calibrated with, the exact sensitivity
when tracked, whether the round was a synchronization round (unprotected:
exact values cross the wire), and the per-node estimate spread. Entries
stream to JSONL as they are recorded, so a killed training run still
leaves a complete privacy audit trail on disk.

The session's :class:`repro_torch.api.hooks.LedgerHook` records each
segment's trajectory through :meth:`PrivacyLedger.record_trajectory`, for
both drivers (the per-round loop's segments are one round long). The
entries equal the reference's field for field.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, IO

import numpy as np

from repro_torch.core.dpps import is_sync_round
from repro_torch.core.privacy import PrivacyAccountant

__all__ = ["PrivacyLedger"]


def _f(x) -> float | None:
    """JSON-safe float: None stays None, non-finite (inf epsilon under
    gamma_n = 0, inf remaining under no budget) maps to None so every
    entry is strict JSON."""
    if x is None:
        return None
    x = float(x)
    return x if np.isfinite(x) else None


@dataclasses.dataclass
class PrivacyLedger:
    """Round-indexed privacy spend record on top of the accountant.

    ``budget`` forwards to the accountant's epsilon ceiling;
    ``path`` enables streaming JSONL (one entry per line, flushed per
    round so the trail survives crashes). ``mechanism`` is a display name
    recorded with every entry; ``wire_dtype`` records the gossip wire
    format the round's messages actually left the node in (the packed
    engine's bf16 wire halves the bytes an eavesdropper sees — the audit
    trail must say which format the transcript was recorded at).
    ``wire_codec`` / ``wire_bytes_per_edge`` extend that to the
    ``repro.wire`` compression subsystem: the codec name and the
    effective post-compression payload bytes one message carries, so the
    ledger and ``RunReport.network`` agree on bytes accounting.
    """

    b: float
    gamma_n: float
    budget: float | None = None
    mechanism: str = "laplace"
    path: str | None = None
    algorithm: str = "dpps"
    wire_dtype: str = "f32"
    wire_codec: str = "f32"
    wire_bytes_per_edge: int | None = None

    accountant: PrivacyAccountant = dataclasses.field(init=False)
    entries: list[dict[str, Any]] = dataclasses.field(
        init=False, default_factory=list)
    _fh: IO[str] | None = dataclasses.field(init=False, default=None,
                                            repr=False)

    def __post_init__(self):
        self.accountant = PrivacyAccountant(b=self.b, gamma_n=self.gamma_n,
                                            budget=self.budget)
        if self.path is not None:
            self._fh = open(self.path, "w")

    # -- recording -----------------------------------------------------------

    def record_round(
        self,
        t: int,
        *,
        sensitivity_estimate: float | None = None,
        sensitivity_real: float | None = None,
        sens_local: Any = None,
        protected: bool = True,
        synced: bool = False,
        out_degree: Any = None,
        dropped_edges: int | None = None,
        staleness_max: int | None = None,
        timeouts: int | None = None,
        participating: Any = None,
    ) -> dict[str, Any]:
        """Record round ``t``; returns the (JSON-ready) ledger entry.

        Synchronization rounds exchange exact parameters and are recorded
        as unprotected regardless of ``protected``. ``out_degree`` (the
        per-node *realized* non-self out-degrees under fault injection —
        repro.net) and ``dropped_edges`` record what actually crossed the
        wire; empirical-epsilon audits (benchmarks/fig5_audit.py) stay
        valid under faults because the trail states the realized graph
        each round's transcript was produced on, not the nominal one.
        Async runs (``repro.net.delays``) add ``staleness_max`` (oldest
        message delivered this round), ``timeouts`` (messages whose mass
        was re-credited to the sender) and ``participating`` (per-node
        active mask — recorded as a count): a transcript observed under
        delays spans several rounds of sends, and the trail must say which.
        """
        protected = protected and not synced
        self.accountant = self.accountant.step(protected=protected)
        eps_round = self.accountant.epsilon_per_round if protected else 0.0
        entry: dict[str, Any] = {
            "round": int(t),
            "mechanism": self.mechanism,
            "algorithm": self.algorithm,
            "wire_dtype": self.wire_dtype,
            "wire_codec": self.wire_codec,
            "protected": bool(protected),
            **({"wire_bytes_per_edge": int(self.wire_bytes_per_edge)}
               if self.wire_bytes_per_edge is not None else {}),
            "synced": bool(synced),
            "epsilon_round": _f(eps_round),
            "epsilon_total": _f(self.accountant.epsilon_total),
            "remaining": _f(self.accountant.remaining()),
            "exhausted": bool(self.accountant.exhausted),
            "sensitivity_estimate": _f(sensitivity_estimate),
            "sensitivity_real": _f(sensitivity_real),
        }
        if sens_local is not None:
            # Every node spends the same epsilon_round (the noise scale is
            # the shared network maximum), so per-node epsilon is the
            # scalar above; the per-node sensitivity estimates are the
            # genuinely per-node data — their spread shows which node
            # forced the calibration.
            arr = np.asarray(sens_local, dtype=np.float64)
            entry["sens_local_max"] = float(arr.max())
            entry["sens_local_min"] = float(arr.min())
        if out_degree is not None:
            deg = np.asarray(out_degree, dtype=np.float64)
            entry["out_degree_min"] = int(deg.min())
            entry["out_degree_mean"] = float(deg.mean())
        if dropped_edges is not None:
            entry["dropped_edges"] = int(dropped_edges)
        if staleness_max is not None:
            entry["staleness_max"] = int(staleness_max)
        if timeouts is not None:
            entry["timeouts"] = int(timeouts)
        if participating is not None:
            part = np.asarray(participating, dtype=bool)
            entry["participating"] = int(part.sum())
        self.entries.append(entry)
        if self._fh is not None:
            self._fh.write(json.dumps(entry) + "\n")
            self._fh.flush()
        return entry

    def record_trajectory(
        self,
        traj: dict[str, Any],
        *,
        t0: int = 0,
        protected: bool = True,
        sync_interval: int = 0,
    ) -> None:
        """Engine path: record a scan segment's captured (T, ...) trajectory.

        Under fault injection (repro.net) the trajectory carries
        ``net_out_degree`` / ``net_dropped_edges`` rows; they land on each
        entry so the trail records the realized graph, not the nominal one.
        Async trajectories (``ProtocolPlan.delays``) add
        ``async_staleness_max`` / ``async_timeouts`` /
        ``async_participated`` rows — recorded per entry so the trail says
        how stale each round's delivered transcript actually was.
        """
        ests = np.asarray(traj["sensitivity_estimate"])
        reals = traj.get("sensitivity_real")
        reals = None if reals is None else np.asarray(reals)
        locals_ = traj.get("sensitivity_local")
        locals_ = None if locals_ is None else np.asarray(locals_)
        degs = traj.get("net_out_degree")
        degs = None if degs is None else np.asarray(degs)
        drops = traj.get("net_dropped_edges")
        drops = None if drops is None else np.asarray(drops)
        stale = traj.get("async_staleness_max")
        stale = None if stale is None else np.asarray(stale)
        touts = traj.get("async_timeouts")
        touts = None if touts is None else np.asarray(touts)
        parts = traj.get("async_participated")
        parts = None if parts is None else np.asarray(parts)
        for i in range(ests.shape[0]):
            t = t0 + i
            synced = is_sync_round(t, sync_interval)
            self.record_round(
                t,
                sensitivity_estimate=ests[i],
                sensitivity_real=None if reals is None else reals[i],
                sens_local=None if locals_ is None else locals_[i],
                protected=protected,
                synced=synced,
                out_degree=None if degs is None else degs[i],
                dropped_edges=None if drops is None else drops[i],
                staleness_max=None if stale is None else stale[i],
                timeouts=None if touts is None else touts[i],
                participating=None if parts is None else parts[i],
            )

    # -- reading -------------------------------------------------------------

    def theoretical_epsilon(self) -> float:
        """Total claimed epsilon so far (the attack battery's null)."""
        return self.accountant.epsilon_total

    def summary(self) -> dict[str, Any]:
        out = {k: (_f(v) if isinstance(v, float) else v)
               for k, v in self.accountant.summary().items()}
        out["mechanism"] = self.mechanism
        out["algorithm"] = self.algorithm
        out["wire_dtype"] = self.wire_dtype
        out["wire_codec"] = self.wire_codec
        if self.wire_bytes_per_edge is not None:
            out["wire_bytes_per_edge"] = int(self.wire_bytes_per_edge)
        if self.entries:
            ests = [e["sensitivity_estimate"] for e in self.entries
                    if e["sensitivity_estimate"] is not None]
            reals = [(e["sensitivity_real"], e["sensitivity_estimate"])
                     for e in self.entries
                     if e["sensitivity_real"] is not None]
            out["rounds_recorded"] = len(self.entries)
            out["sensitivity_estimate_mean"] = (
                float(np.mean(ests)) if ests else None)
            out["sensitivity_violations"] = sum(
                1 for r, e in reals if e is not None and r > e + 1e-6)
        return out

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "PrivacyLedger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def read_jsonl(path: str) -> list[dict[str, Any]]:
        with open(path) as fh:
            return [json.loads(line) for line in fh if line.strip()]
