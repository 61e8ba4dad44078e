"""The six ``examples_torch/`` scripts on the CPU, each ``main([...,
"--device", "cpu"])`` at a small size.

What no noise draw enters is held against the reference's API at the same
arguments, exactly: the calibrated constants and the schedule, the epsilon
spent, ``privacy_summary``, d_s and d_l; and quickstart's noiseless
consensus (``--gamma-n 0``) against the reference's to 1e-6 (rtol and
atol, f32 sums in another order). Where the noise enters (the port draws
Philox, the reference threefry), the invariants: a finite loss that falls,
mean(a) = 1 to 1e-5, the churned node isolated, decoded tokens in the
vocabulary, no watchdog alert, the battery's empirical epsilon within its
claim. The scripts import neither JAX nor the reference.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import load_reference, to_numpy
from test_torch_session import _imported_roots

from repro_torch.obs import validate_chrome_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
SCRIPTS = ("quickstart", "partpsp_train", "decentralized_serve",
           "fault_tolerance", "observability", "privacy_sweep")
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def R():
    return load_reference()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module, restored after it: under the
    suite's six workers torch's default (a thread a core in every worker)
    oversubscribes the cores, and these runs of many small ops slowed
    about 30x (privacy_sweep 7 s alone, 209 s in the suite)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example(name: str):
    """``examples_torch/<name>.py`` as a module (its directory on
    ``sys.path``, as running the script puts it, for ``paper_setup``)."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_examples_import_no_jax_and_no_reference():
    files = sorted(EXAMPLES.glob("*.py"))
    assert {p.stem for p in files} >= set(SCRIPTS) | {"paper_setup"}
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "benchmarks"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _ref_session(R, topo, **privacy):
    return R.api.Session.build(topo, privacy=R.api.PrivacySpec(**privacy),
                               sync_interval=5)


def test_quickstart_matches_reference(R, capsys):
    out = _example("quickstart").main(["--rounds", "12"] + CPU)
    session, report = out["session"], out["report"]
    ref = R.api.Session.build(R.core.topology.DOutGraph(10, 2),
                              privacy=R.api.PrivacySpec(b=5.0, gamma_n=1e-3))
    assert (session.cfg.c_prime, session.cfg.lam) == (ref.cfg.c_prime,
                                                      ref.cfg.lam)
    assert session.cfg.epsilon_per_round == ref.cfg.epsilon_per_round
    assert session.plan.schedule == ref.plan.schedule == "circulant"
    assert report.epsilon_spent == ref.epsilon_spent(12)
    assert report.rounds == 12 and np.isfinite(out["error"])
    est = np.asarray(report.trajectory["sensitivity_estimate"])
    real = np.asarray(report.trajectory["sensitivity_real"])
    assert (est >= real).all()
    assert "epsilon spent = 60000" in capsys.readouterr().out


def test_quickstart_noiseless_consensus_matches_reference(R):
    out = _example("quickstart").main(["--rounds", "12", "--gamma-n", "0"]
                                      + CPU)
    private = to_numpy(out["private"][0])
    ref = R.api.Session.build(R.core.topology.DOutGraph(10, 2),
                              privacy=R.api.PrivacySpec(b=5.0, gamma_n=0.0))
    rep = ref.run(12, values=[jnp.asarray(private)])
    want = np.asarray(ref.consensus(rep.state)[0])
    np.testing.assert_allclose(to_numpy(out["consensus"]), want, rtol=1e-6,
                               atol=1e-6)
    assert out["report"].epsilon_spent == rep.epsilon_spent == 0.0


def test_partpsp_train_matches_reference_accounting(R):
    steps, nodes = 4, 4
    out = _example("partpsp_train").main(
        ["--steps", str(steps), "--chunk", "2", "--nodes", str(nodes)] + CPU)
    ref_train = importlib.import_module("repro.launch.train")
    _, _, ref = ref_train.build_session(
        "llama3.2-1b", reduced=True, n_nodes=nodes, algorithm="partpsp",
        b=3.0, gamma_n=1e-6, gamma_l=0.05, gamma_s=0.05, clip=100.0,
        topology="dout", degree=2, sync_interval=5, schedule="circulant",
        chunk=2, seed=0)
    assert out["summary"] == R.core.partpsp.privacy_summary(ref.train_cfg,
                                                            steps)
    assert (out["d_shared"], out["d_local"]) == (ref.partition.d_shared(),
                                                 ref.partition.d_local())
    report = out["report"]
    assert report.epsilon_spent == ref.epsilon_spent(steps)
    loss = np.asarray(report.trajectory["loss_mean"])
    assert loss.shape == (steps,) and np.isfinite(loss).all()
    assert loss[-1] < loss[0]


def test_decentralized_serve_decodes_in_the_vocabulary(R):
    out = _example("decentralized_serve").main(["--rounds", "3"] + CPU)
    report, served = out["report"], out["serve"]
    loss = np.asarray(report.trajectory["loss_mean"])
    assert loss.shape == (3,) and np.isfinite(loss).all()
    tokens = to_numpy(served.tokens)
    assert tokens.shape == (2, 12)
    assert ((tokens >= 0) & (tokens < out["vocab_size"])).all()
    ref = _ref_session(R, R.core.topology.DOutGraph(4, 2), b=3.0,
                       gamma_n=1e-6)
    assert report.epsilon_spent == ref.epsilon_spent(3)


def test_fault_tolerance_conserves_mass_and_isolates_the_churned_node(R):
    rounds = 16
    out = _example("fault_tolerance").main(["--rounds", str(rounds)] + CPU)
    session, report = out["session"], out["report"]
    assert abs(out["mass"] - 1.0) < 1e-5
    deg = out["out_degree"]
    assert deg.shape == (rounds, 16)
    assert (deg[rounds // 4:rounds // 2, 3] == 0).all()
    assert (deg[:rounds // 4, 3] > 0).all()
    ref_topo = R.net.graphs.ErdosRenyiGraph(n_nodes=16, p=0.3, seed=7)
    ref = R.api.Session.build(
        ref_topo, privacy=R.api.PrivacySpec(b=5.0, gamma_n=1e-3),
        faults=R.net.FaultModel(drop_rate=0.2,
                                churn=((3, rounds // 4, rounds // 2),)))
    assert session.plan.schedule == ref.plan.schedule == "dynamic"
    assert np.array_equal(session.topology.weight_matrix(0),
                          ref_topo.weight_matrix(0))
    assert report.epsilon_spent == ref.epsilon_spent(rounds)
    assert report.network.windows > 0


def test_observability_streams_events_without_alerts(R, tmp_path):
    events, trace = tmp_path / "events.jsonl", tmp_path / "trace.json"
    out = _example("observability").main(
        ["--rounds", "12", "--events", str(events), "--timeline", str(trace)]
        + CPU)
    report = out["report"]
    assert out["alerts"] == [] and out["events"] > 0
    lines = events.read_text().splitlines()
    assert len(lines) == out["events"]
    assert all(json.loads(line)["kind"] for line in lines)
    for family in ("privacy_epsilon_total", "privacy_rounds",
                   "metrics_sensitivity", "net_realized_edges"):
        assert f"# TYPE {family} " in out["prometheus"], family
    validate_chrome_trace(json.loads(trace.read_text()))
    assert out["profile"].rounds >= 1
    ref = R.api.Session.build(R.core.topology.DOutGraph(10, 2),
                              privacy=R.api.PrivacySpec(b=5.0, gamma_n=1e-3),
                              chunk=3, sync_interval=0,
                              delays=R.net.DelayModel(max_delay=2,
                                                      timeout_rate=0.1,
                                                      seed=7))
    assert report.epsilon_spent == ref.epsilon_spent(12)
    assert report.rounds == 12


def test_privacy_sweep_smoke_rows(R):
    rows = _example("privacy_sweep").main(["--smoke"] + CPU)
    assert [(r["algorithm"], r["b"]) for r in rows] == [
        ("partpsp", 1.0), ("sgpdp", 1.0), ("sgp", None)]
    ref_train = _ref_session(R, R.core.topology.DOutGraph(10, 4), b=1.0,
                             gamma_n=1e-4, sensitivity_mode="real")
    for row in rows:
        r = row["result"]
        assert 0.0 <= r.accuracy <= 1.0 and np.isfinite(r.loss)
        assert r.steps == 40
        if row["b"] is None:
            assert r.eps_total == 0.0
            continue
        assert r.eps_total == ref_train.epsilon_spent(40)
        assert row["eps_claim"] == 1.0
        assert not row["flagged"] and row["eps_emp"] <= row["eps_claim"]
