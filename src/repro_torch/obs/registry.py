"""Cross-run registry: durable run records and regression detection (port
of ``repro.obs.registry``; stdlib only).

The repo's tracked ``BENCH_*.json`` each hold the latest measurement and
its own gate, but no history, so a slow creep under the gate is invisible,
and session runs (``run`` / ``train``) leave no trace at all. This module
is the cross-run memory:

* :class:`RunRecord`: one schema-versioned record of one run: bench name,
  timestamp, git sha, backend, the scale dict that makes records
  comparable, the headline metrics, a config and plan fingerprint for
  session runs, and the full payload.
* a history file (``BENCH_history.jsonl`` by default): append-only, one
  JSON object a line, so lines survive a crash mid-run. Sessions append
  through :meth:`repro_torch.api.Session.record` (the port's records
  carry a ``"torch-<device>"`` backend, so they never share a scale key
  with the JAX package's); ``backfill`` seeds it from the committed BENCH
  JSONs.
* :func:`check`: the regression detector. The latest record per (bench,
  scale key) is compared metric by metric against the rolling **median**
  of the previous records in the window, through per-metric
  :class:`MetricGate` tolerances: ``lower`` is better for timings,
  ``higher`` for speedups, ``equal`` for exact accounting such as wire
  bytes; timing gates relax 2x under ``--smoke`` (shared machines). The
  report names every violated metric with its baseline, latest value and
  threshold.

The gates, the record schema and the report lines are the reference's,
line for line.

CLI::

    python -m repro_torch.obs.registry check    [--history PATH] [--smoke]
    python -m repro_torch.obs.registry backfill [--history PATH] [--repo-root P]
    python -m repro_torch.obs.registry record --json BENCH_x.json [--history P]
    python -m repro_torch.obs.registry show     [--history PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import time
from typing import Any

__all__ = [
    "SCHEMA_VERSION",
    "MetricGate",
    "RunRecord",
    "GATES",
    "SESSION_GATES",
    "append_record",
    "load_history",
    "backfill",
    "check",
    "extract_path",
    "git_sha",
]

SCHEMA_VERSION = 1

# The default history file name; the CLI resolves it against the cwd.
HISTORY_NAME = "BENCH_history.jsonl"

# The six tracked bench artifacts the registry seeds from (repo root).
BENCH_FILES = (
    "BENCH_protocol.json",
    "BENCH_sparse.json",
    "BENCH_net.json",
    "BENCH_obs.json",
    "BENCH_async.json",
    "BENCH_wire.json",
)


# ---------------------------------------------------------------------------
# git provenance
# ---------------------------------------------------------------------------


def _git(args: list[str], cwd: str | os.PathLike | None = None) -> str | None:
    try:
        out = subprocess.run(["git", *args], cwd=cwd, capture_output=True,
                             text=True, timeout=10)
    except Exception:
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


def git_sha(repo_root: str | os.PathLike | None = None) -> str:
    """HEAD commit sha (``"unknown"`` outside a git checkout) — the
    provenance stamp every bench writer and record carries."""
    return _git(["rev-parse", "HEAD"], cwd=repo_root) or "unknown"


def _git_file_commit(path: pathlib.Path) -> tuple[str, float]:
    """(sha, commit unix time) of the last commit touching ``path`` —
    backfill provenance for the committed BENCH JSONs."""
    rel = path.name
    sha = _git(["log", "-1", "--format=%H", "--", rel], cwd=path.parent)
    ts = _git(["log", "-1", "--format=%ct", "--", rel], cwd=path.parent)
    return sha or "unknown", float(ts) if ts else time.time()


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MetricGate:
    """One regression gate: where the metric lives and how it may move.

    ``path`` is a ``/``-separated route into the bench payload (segments
    greedily re-join around keys that themselves contain ``/``, e.g.
    ``timing/topk:1/16/dense/us_per_round``). ``direction``:

    * ``lower``  — smaller is better; regression when latest exceeds
      ``baseline * tolerance`` (and ``floor``, for metrics near the f32
      noise floor where tiny absolute wiggles are meaningless).
    * ``higher`` — bigger is better; regression when latest falls below
      ``baseline / tolerance``.
    * ``equal``  — exact accounting (wire bytes); regression when the
      value moves at all beyond ``tolerance`` rounding slack.

    ``timing=True`` marks wall-clock-derived metrics whose tolerance is
    doubled under smoke mode (co-tenant CI runners).
    """

    path: str
    direction: str = "lower"
    tolerance: float = 1.25
    timing: bool = False
    floor: float = 0.0

    def threshold(self, baseline: float, smoke: bool) -> tuple[float, str]:
        tol = self.tolerance * (2.0 if smoke and self.timing else 1.0)
        if self.direction == "lower":
            return max(baseline * tol, self.floor), "<="
        if self.direction == "higher":
            return baseline / tol, ">="
        return baseline, "=="

    def violated(self, latest: float, baseline: float, smoke: bool) -> bool:
        limit, _ = self.threshold(baseline, smoke)
        if self.direction == "lower":
            return latest > limit
        if self.direction == "higher":
            return latest < limit
        tol = self.tolerance
        if baseline == 0.0:
            return abs(latest) > 1e-12
        ratio = latest / baseline
        return ratio > tol or ratio < 1.0 / tol


def extract_path(payload: Any, path: str) -> float:
    """Resolve a gate path against a payload (greedy ``/`` re-joining for
    keys that contain slashes). Raises ``KeyError`` when absent."""
    parts = path.split("/")

    def walk(obj: Any, parts: tuple[str, ...]) -> float:
        if not parts:
            if isinstance(obj, bool):
                return float(obj)
            if not isinstance(obj, (int, float)):
                raise KeyError(f"{path!r} resolves to non-numeric {obj!r}")
            return float(obj)
        if not isinstance(obj, dict):
            raise KeyError(path)
        for i in range(1, len(parts) + 1):
            key = "/".join(parts[:i])
            if key in obj:
                try:
                    return walk(obj[key], parts[i:])
                except KeyError:
                    continue
        raise KeyError(path)

    return walk(payload, tuple(parts))


# Per-bench headline gates. Timing gates get 1.6x (the thin-timing slack
# of the per-bench smoke gates); same-machine ratio metrics sit tighter;
# consensus-error metrics near the f32 floor carry absolute floors so
# float noise can't page anyone.
GATES: dict[str, dict[str, MetricGate]] = {
    "protocol_round_throughput": {
        "packed_us_per_round": MetricGate(
            "drivers/engine_packed/us_per_round", "lower", 1.6, timing=True),
        "packed_vs_loop": MetricGate(
            "speedups/packed_vs_loop", "higher", 1.5),
        "packed_vs_pytree": MetricGate(
            "speedups/packed_vs_pytree_engine", "higher", 1.25),
        "wire_bytes_f32": MetricGate(
            "bytes_per_round_per_node/f32", "equal", 1.0001),
    },
    "sparse_gossip_scaling": {
        "sparse_speedup_n4096": MetricGate(
            "edge_sweep/4096/sparse_speedup", "higher", 1.5),
        "masked_overhead": MetricGate(
            "masked_overhead/overhead_ratio", "lower", 1.25),
        "sparse_us_n4096": MetricGate(
            "edge_sweep/4096/us_per_round_sparse", "lower", 1.6, timing=True),
    },
    "network_resilience": {
        "mix_overhead": MetricGate(
            "mix_overhead/overhead_ratio", "lower", 1.25),
        "consensus_error_drop30": MetricGate(
            "drop_sweep/0.3/consensus_error_final", "lower", 5.0,
            floor=1e-4),
        "mass_dev_drop30": MetricGate(
            "drop_sweep/0.3/a_mean_dev", "lower", 10.0, floor=1e-4),
    },
    "obs_overhead": {
        "full_vs_hookless": MetricGate(
            "full_vs_hookless", "lower", 1.25),
        "hookless_us_per_round": MetricGate(
            "hooks/hookless/us_per_round", "lower", 1.6, timing=True),
    },
    "async_degradation": {
        "async_vs_sync": MetricGate(
            "overhead/async_vs_sync", "lower", 1.25),
        "worst_vs_floor": MetricGate(
            "worst_vs_floor", "lower", 2.0, floor=3.0),
        "async_us_per_round": MetricGate(
            "overhead/async_us_per_round", "lower", 1.6, timing=True),
    },
    "wire_compression": {
        "int8_bytes_ratio": MetricGate(
            "bytes_ratio_vs_f32/int8", "higher", 1.02),
        "topk_bytes_ratio": MetricGate(
            "bytes_ratio_vs_f32/topk:1/16", "higher", 1.02),
        "int8_us_dense": MetricGate(
            "timing/int8/dense/us_per_round", "lower", 1.6, timing=True),
    },
}

# Generic gates for session runs (Session.record appends under
# "session/<name>"): the report's own headline numbers.
SESSION_GATES: dict[str, MetricGate] = {
    "us_per_round": MetricGate("us_per_round", "lower", 1.6, timing=True),
    "wire_bytes": MetricGate("wire_bytes", "equal", 1.0001),
    "epsilon_spent": MetricGate("epsilon_spent", "equal", 1.0001),
}


def gates_for(bench: str) -> dict[str, MetricGate] | None:
    if bench in GATES:
        return GATES[bench]
    if bench.startswith("session/"):
        return SESSION_GATES
    return None


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


def _payload_fingerprint(payload: dict[str, Any]) -> str:
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def scale_key(scale: dict[str, Any]) -> str:
    """The canonical comparability key: records only compare within one
    scale (n_nodes, d_s, rounds, backend, ... — whatever the producer
    stamped)."""
    return json.dumps(scale, sort_keys=True, default=str)


@dataclasses.dataclass
class RunRecord:
    """One durable run record (see module docstring)."""

    bench: str
    ts: float
    git_sha: str
    backend: str
    scale: dict[str, Any]
    metrics: dict[str, float]
    fingerprint: str = ""
    source: str = "bench"           # bench | session | backfill
    payload: dict[str, Any] = dataclasses.field(default_factory=dict)
    schema: int = SCHEMA_VERSION

    @property
    def scale_key(self) -> str:
        return scale_key(self.scale)

    def to_dict(self) -> dict[str, Any]:
        return {"schema": self.schema, "bench": self.bench,
                "ts": round(self.ts, 3), "git_sha": self.git_sha,
                "backend": self.backend, "scale": self.scale,
                "metrics": self.metrics, "fingerprint": self.fingerprint,
                "source": self.source, "payload": self.payload}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RunRecord":
        return cls(bench=d["bench"], ts=float(d.get("ts", 0.0)),
                   git_sha=d.get("git_sha", "unknown"),
                   backend=d.get("backend", "unknown"),
                   scale=d.get("scale", {}), metrics=d.get("metrics", {}),
                   fingerprint=d.get("fingerprint", ""),
                   source=d.get("source", "bench"),
                   payload=d.get("payload", {}),
                   schema=int(d.get("schema", 1)))

    @classmethod
    def from_bench(cls, payload: dict[str, Any], *, sha: str | None = None,
                   ts: float | None = None,
                   source: str = "bench") -> "RunRecord":
        """Build a record from a bench writer's JSON payload (the tracked
        BENCH_*.json shape: ``bench`` + ``scale`` + results). Headline
        metrics are extracted through the bench's gate paths; the full
        payload rides along."""
        bench = payload["bench"]
        scale = dict(payload.get("scale", {}))
        gates = gates_for(bench) or {}
        metrics: dict[str, float] = {}
        for name, gate in gates.items():
            try:
                metrics[name] = extract_path(payload, gate.path)
            except KeyError:
                pass
        return cls(
            bench=bench, ts=time.time() if ts is None else ts,
            git_sha=sha if sha is not None else payload.get(
                "git_sha", git_sha()),
            backend=str(scale.get("backend", payload.get(
                "backend", "unknown"))),
            scale=scale, metrics=metrics,
            fingerprint=_payload_fingerprint(payload), source=source,
            payload=payload)

    @classmethod
    def from_report(cls, name: str, report: Any, *,
                    scale: dict[str, Any], fingerprint: str = "",
                    backend: str = "unknown", steady_rounds: int = 0,
                    extra: dict[str, float] | None = None) -> "RunRecord":
        """Build a ``session/<name>`` record from a
        :class:`repro_torch.api.results.RunReport` (see ``Session.record``)."""
        metrics: dict[str, float] = {
            "rounds": float(report.rounds),
            "compile_s": float(report.compile_s),
            "run_s": float(report.run_s),
            "wire_bytes": float(report.wire_bytes),
        }
        eps = float(report.epsilon_spent)
        if eps == eps and abs(eps) != float("inf"):  # finite
            metrics["epsilon_spent"] = eps
        if steady_rounds > 0 and report.run_s > 0:
            metrics["us_per_round"] = report.run_s / steady_rounds * 1e6
        if extra:
            metrics.update({k: float(v) for k, v in extra.items()})
        payload = dict(report.summary())
        payload.pop("network", None)
        return cls(bench=f"session/{name}", ts=time.time(),
                   git_sha=git_sha(), backend=backend, scale=scale,
                   metrics=metrics, fingerprint=fingerprint,
                   source="session", payload=payload)


# ---------------------------------------------------------------------------
# History I/O
# ---------------------------------------------------------------------------


def append_record(record: RunRecord,
                  history: str | os.PathLike = HISTORY_NAME) -> None:
    """Append one record to the history (append-only JSONL; crash-safe
    one-object-per-line, same discipline as the privacy ledger)."""
    with open(history, "a") as f:
        f.write(json.dumps(record.to_dict(), sort_keys=True) + "\n")


def load_history(history: str | os.PathLike = HISTORY_NAME
                 ) -> list[RunRecord]:
    """All parseable records, in append order. Records from a *newer*
    schema than this reader understands are skipped (forward-compatible
    readers never misinterpret fields they don't know)."""
    path = pathlib.Path(history)
    if not path.exists():
        return []
    out: list[RunRecord] = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            continue
        if int(d.get("schema", 1)) > SCHEMA_VERSION:
            continue
        out.append(RunRecord.from_dict(d))
    return out


def backfill(history: str | os.PathLike = HISTORY_NAME,
             repo_root: str | os.PathLike | None = None) -> int:
    """Seed the history from the committed BENCH_*.json files.

    Idempotent: a payload already recorded (same content fingerprint) is
    skipped, so re-running backfill after a bench refresh appends only
    the changed artifacts. Returns the number of records appended.
    """
    root = pathlib.Path(repo_root) if repo_root is not None else \
        pathlib.Path(history).resolve().parent
    seen = {(r.bench, r.fingerprint) for r in load_history(history)}
    added = 0
    for name in BENCH_FILES:
        path = root / name
        if not path.exists():
            continue
        payload = json.loads(path.read_text())
        fp = _payload_fingerprint(payload)
        if (payload["bench"], fp) in seen:
            continue
        sha = payload.get("git_sha")
        if sha:
            _, ts = _git_file_commit(path)
        else:
            sha, ts = _git_file_commit(path)
        append_record(RunRecord.from_bench(payload, sha=sha, ts=ts,
                                           source="backfill"), history)
        added += 1
    return added


# ---------------------------------------------------------------------------
# Regression check
# ---------------------------------------------------------------------------


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def check(history: str | os.PathLike = HISTORY_NAME, *, window: int = 8,
          smoke: bool = False) -> tuple[list[str], list[str]]:
    """Compare the latest record per (bench, scale-key) against the
    rolling-median baseline of up to ``window`` previous records.

    Returns ``(regressions, report_lines)`` — empty ``regressions`` means
    pass. A group with a single record has no baseline yet and passes
    with a note (the seed path). Unknown benches (no gate table) are
    reported, not failed.
    """
    records = load_history(history)
    lines: list[str] = []
    regressions: list[str] = []
    if not records:
        lines.append(f"{history}: no records — nothing to check")
        return regressions, lines

    groups: dict[tuple[str, str], list[RunRecord]] = {}
    for r in records:
        groups.setdefault((r.bench, r.scale_key), []).append(r)

    for (bench, skey), recs in sorted(groups.items()):
        latest = recs[-1]
        prior = recs[:-1][-window:]
        gates = gates_for(bench)
        head = f"{bench} [{latest.git_sha[:10]} n={len(recs)}]"
        if gates is None:
            lines.append(f"SKIP {head}: no gate table for this bench")
            continue
        if not prior:
            lines.append(f"OK   {head}: first record at this scale — "
                         "baseline seeded, nothing to compare")
            continue
        for name, gate in gates.items():
            cur = latest.metrics.get(name)
            if cur is None:
                try:
                    cur = extract_path(latest.payload, gate.path)
                except KeyError:
                    lines.append(f"SKIP {head} {name}: absent in latest")
                    continue
            base_vals = []
            for p in prior:
                v = p.metrics.get(name)
                if v is None:
                    try:
                        v = extract_path(p.payload, gate.path)
                    except KeyError:
                        continue
                base_vals.append(v)
            if not base_vals:
                lines.append(f"SKIP {head} {name}: no baseline values")
                continue
            base = _median(base_vals)
            limit, op = gate.threshold(base, smoke)
            if gate.violated(cur, base, smoke):
                regressions.append(name)
                lines.append(
                    f"REGRESSION {head} {name}: latest={cur:.6g} vs "
                    f"baseline(median of {len(base_vals)})={base:.6g} — "
                    f"needs {op} {limit:.6g} "
                    f"({gate.direction}, tol {gate.tolerance}"
                    f"{', timing' if gate.timing else ''}"
                    f"{', smoke-relaxed' if smoke and gate.timing else ''})")
            else:
                lines.append(
                    f"OK   {head} {name}: latest={cur:.6g} "
                    f"baseline={base:.6g} ({op} {limit:.6g})")
    return regressions, lines


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.registry",
        description="Cross-run registry: record, seed, and check "
                    "BENCH_history.jsonl")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("check", help="regression check vs rolling median")
    p.add_argument("--history", default=HISTORY_NAME)
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--smoke", action="store_true",
                   help="relax timing gates 2x (co-tenant CI runners)")

    p = sub.add_parser("backfill",
                       help="seed the history from the committed BENCH jsons")
    p.add_argument("--history", default=HISTORY_NAME)
    p.add_argument("--repo-root", default=None)

    p = sub.add_parser("record", help="append one bench JSON as a record")
    p.add_argument("--json", required=True)
    p.add_argument("--history", default=HISTORY_NAME)

    p = sub.add_parser("show", help="one line per record")
    p.add_argument("--history", default=HISTORY_NAME)

    args = ap.parse_args(argv)

    if args.cmd == "check":
        regressions, lines = check(args.history, window=args.window,
                                   smoke=args.smoke)
        print("\n".join(lines))
        if regressions:
            print(f"\n{len(regressions)} regression(s): "
                  f"{', '.join(regressions)}")
            return 1
        print("\nregistry check: no regressions")
        return 0
    if args.cmd == "backfill":
        added = backfill(args.history, repo_root=args.repo_root)
        print(f"backfill: {added} record(s) appended to {args.history}")
        return 0
    if args.cmd == "record":
        payload = json.loads(pathlib.Path(args.json).read_text())
        append_record(RunRecord.from_bench(payload), args.history)
        print(f"recorded {payload['bench']} -> {args.history}")
        return 0
    if args.cmd == "show":
        for r in load_history(args.history):
            print(f"{r.bench:28s} {r.git_sha[:10]} {r.source:8s} "
                  f"backend={r.backend} metrics={len(r.metrics)}")
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
