"""The port's cross-run registry (``repro_torch.obs.registry``) against the
reference's ``repro.obs.registry``.

* ``check`` on copies of the committed ``BENCH_history.jsonl`` (and on a
  history backfilled from the committed ``BENCH_*.json``) gives the
  reference's report lines; so does the CLI (``check``, ``show``,
  ``backfill``, ``record``), output and exit code.
* The gate tables, path extraction and thresholds equal the reference's.
* A record round-trips through the history file; a synthetic 2x
  ``us_per_round`` record is named as a regression.
* ``Session.record`` writes ``session/<name>`` records whose scale and
  metric keys equal the reference's for the same session (the backend is
  ``"torch-cpu"``, so port records never share a scale key with the JAX
  package's; the timings differ).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import load_reference

from repro_torch.api import PrivacySpec, Session
from repro_torch.core import topology as T
from repro_torch.obs import registry as reg

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 8


@pytest.fixture(scope="module")
def RR():
    load_reference()
    return importlib.import_module("repro.obs.registry")


def _copy_history(tmp_path, name="h.jsonl") -> str:
    dst = tmp_path / name
    shutil.copy(REPO_ROOT / "BENCH_history.jsonl", dst)
    return str(dst)


def _cli(main, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("smoke", [False, True])
def test_check_of_the_committed_history_matches_the_reference(RR, tmp_path,
                                                              smoke):
    path = _copy_history(tmp_path)
    got = reg.check(path, smoke=smoke)
    assert got == RR.check(path, smoke=smoke)
    assert got[1]  # the history is not empty
    for cmd in (["check", "--history", path] + (["--smoke"] if smoke
                                                else []),
                ["show", "--history", path]):
        assert _cli(reg.main, cmd) == _cli(RR.main, cmd)


def test_backfill_matches_the_reference(RR, tmp_path):
    """A history seeded from the committed BENCH JSONs: the same records
    (payload, metrics, provenance) and the same check lines; a second
    backfill appends nothing."""
    mine, theirs = str(tmp_path / "p.jsonl"), str(tmp_path / "r.jsonl")
    assert reg.backfill(mine, repo_root=REPO_ROOT) == RR.backfill(
        theirs, repo_root=REPO_ROOT) == len(reg.BENCH_FILES)
    assert reg.backfill(mine, repo_root=REPO_ROOT) == 0

    def records(path, mod):
        return [{k: v for k, v in r.to_dict().items() if k != "ts"}
                for r in mod.load_history(path)]

    assert records(mine, reg) == records(theirs, RR)
    lines = reg.check(mine)[1]
    assert lines == RR.check(mine)[1]
    rc, out = _cli(reg.main, ["record", "--json",
                              str(REPO_ROOT / "BENCH_sparse.json"),
                              "--history", mine])
    assert rc == 0 and out == (f"recorded sparse_gossip_scaling -> {mine}\n")
    assert _cli(reg.main, ["check", "--history", mine]) == _cli(
        RR.main, ["check", "--history", mine])


def test_gates_and_paths_match_the_reference(RR):
    assert reg.BENCH_FILES == RR.BENCH_FILES
    assert reg.SCHEMA_VERSION == RR.SCHEMA_VERSION
    as_dicts = lambda table: {b: {m: dataclasses.asdict(g)
                                  for m, g in gates.items()}
                              for b, gates in table.items()}
    assert as_dicts(reg.GATES) == as_dicts(RR.GATES)
    assert as_dicts({"s": reg.SESSION_GATES}) == as_dicts(
        {"s": RR.SESSION_GATES})
    payload = {"timing": {"topk:1/16": {"dense": {"us_per_round": 7.0}}},
               "drop_sweep": {"0.3": {"e": 1e-5}}, "flag": True}
    for path in ("timing/topk:1/16/dense/us_per_round", "drop_sweep/0.3/e",
                 "flag"):
        assert reg.extract_path(payload, path) == RR.extract_path(payload,
                                                                  path)
    for gate in (reg.MetricGate("p", "lower", 1.6, timing=True),
                 reg.MetricGate("p", "higher", 1.5),
                 reg.MetricGate("p", "equal", 1.0001),
                 reg.MetricGate("p", "lower", 5.0, floor=1e-4)):
        ref_gate = RR.MetricGate(**dataclasses.asdict(gate))
        for latest, base, smoke in ((150.0, 100.0, False), (170.0, 100.0,
                                    True), (1e-5, 1e-6, False),
                                    (0.0, 0.0, False), (99.0, 100.0, True)):
            assert gate.threshold(base, smoke) == ref_gate.threshold(base,
                                                                     smoke)
            assert gate.violated(latest, base, smoke) == ref_gate.violated(
                latest, base, smoke)


def test_a_record_round_trips_and_a_slowdown_is_named(tmp_path):
    path = str(tmp_path / "h.jsonl")
    base = reg.RunRecord(bench="session/x", ts=1.0, git_sha="abc",
                         backend="torch-cpu", scale={"n_nodes": 4},
                         metrics={"us_per_round": 100.0, "wire_bytes": 8.0,
                                  "epsilon_spent": 2.0},
                         fingerprint="f", source="session",
                         payload={"rounds": 3})
    reg.append_record(base, path)
    assert reg.load_history(path)[0].to_dict() == base.to_dict()
    assert reg.RunRecord.from_dict(base.to_dict()) == base
    assert reg.check(path)[0] == []
    slow = dataclasses.replace(base, metrics=dict(base.metrics,
                                                  us_per_round=200.0))
    reg.append_record(slow, path)
    regressions, lines = reg.check(path)
    assert regressions == ["us_per_round"]
    assert any(line.startswith("REGRESSION session/x") and "us_per_round"
               in line for line in lines)
    assert reg.check(path, smoke=True)[0] == []  # 2x within 1.6 x 2
    with open(path, "a") as f:
        f.write('{"schema": 99, "bench": "future"}\nnot json\n\n')
    assert len(reg.load_history(path)) == 2  # newer schemas are skipped


def _values():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(N, 11)).astype(np.float32),
            rng.normal(size=(N, 2, 3)).astype(np.float32)]


def test_session_record_keys_match_the_reference(RR, tmp_path):
    R = load_reference()
    topo = T.DOutGraph(n_nodes=N, d=2)
    cp, lam = T.calibrate_constants(topo)
    session = Session.build(topo, privacy=PrivacySpec(
        b=5.0, gamma_n=0.02, c_prime=cp, lam=lam), sync_interval=3,
        chunk=2, device="cpu")
    r_topo = R.core.topology.DOutGraph(n_nodes=N, d=2)
    ref = R.api.Session.build(r_topo, privacy=R.api.PrivacySpec(
        b=5.0, gamma_n=0.02, c_prime=cp, lam=lam), sync_interval=3,
        chunk=2)
    values = _values()
    mine, theirs = str(tmp_path / "p.jsonl"), str(tmp_path / "r.jsonl")
    report = session.run(6, values=[torch.from_numpy(v) for v in values])
    r_report = ref.run(6, values=[jnp.asarray(v) for v in values])
    rec = session.record(report, name="dout8", history=mine,
                         extra={"final_error": 0.5})
    r_rec = ref.record(r_report, name="dout8", history=theirs,
                       extra={"final_error": 0.5})
    assert rec.bench == r_rec.bench == "session/dout8"
    assert rec.source == r_rec.source == "session"
    assert set(rec.scale) == set(r_rec.scale)
    assert rec.scale["backend"] == rec.backend == "torch-cpu"
    assert ({k: v for k, v in rec.scale.items() if k != "backend"}
            == {k: v for k, v in r_rec.scale.items() if k != "backend"})
    assert rec.scale_key != r_rec.scale_key
    assert set(rec.metrics) == set(r_rec.metrics)
    timings = {"compile_s", "run_s", "us_per_round"}
    assert ({k: v for k, v in rec.metrics.items() if k not in timings}
            == {k: v for k, v in r_rec.metrics.items() if k not in timings})
    assert set(rec.payload) == set(r_rec.payload)
    assert len(rec.fingerprint) == 16
    assert reg.load_history(mine)[0].to_dict() == rec.to_dict()
    session.record(report, name="dout8", history=mine)
    assert reg.check(mine)[0] == []
