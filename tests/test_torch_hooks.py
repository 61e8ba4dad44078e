"""The port's RoundHook pipeline against the reference's.

* ``LedgerHook``: the JSONL the port writes for a run against the
  reference's for the same run (the engine and the per-round loop),
  accounting fields exactly equal, float fields to rtol 1e-4 / atol 1e-5
  (the runs' sensitivities, equal to the training tolerance of
  ``tests/test_torch_session.py``: gradients pass last-ulp differences of
  the forward on).
* ``BudgetHook(strict=True)`` aborts at the same round in both packages,
  with ``aborted=True`` and the same reason; the engine enforces at its
  segment boundary, the loop after the round.
* ``MetricsHook.history`` and ``RealSensitivityHook`` (no violation; its
  values to the same tolerance) against the reference's.
* ``hook_trace_spec``'s rules, ``capture_rows`` hiding ``s_half``,
  ``estimate_wire_bytes`` and ``RunReport.summary`` against the
  reference's.
* ``launch.train``'s ``--driver loop``, ``--ledger-out``,
  ``--metrics-out``, ``--privacy-budget`` and ``--strict-budget`` (an abort
  writes no checkpoint and exits through ``SystemExit``).
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import (load_reference, reference_bits,
                                  reference_tree_bits, to_numpy)

from repro_torch.api import (BudgetHook, LedgerHook, MetricsHook,
                             PrivacySpec, RealSensitivityHook, RoundHook,
                             Session, TranscriptHook, capture_rows,
                             estimate_wire_bytes, hook_trace_spec)
from repro_torch.audit import PrivacyLedger
from repro_torch.convert import tree_from_numpy
from repro_torch.core import topology as T
from repro_torch.launch import train as train_cli
from repro_torch.models.mlp import PARTITIONS, mlp_loss
from repro_torch.obs import MetricsBus, default_bus

N, SEED, ROUNDS, SYNC, CHUNK = 5, 2024, 7, 5, 3
D_IN, HIDDEN, N_CLASSES, BATCH = 32, 10, 10, 32
GAMMA_N = 1e-4  # inside the Remark-1 stability region at d_s = 640
RTOL, ATOL = 1e-4, 1e-5
ACCOUNTING = ("round", "mechanism", "algorithm", "wire_dtype", "wire_codec",
              "protected", "synced", "epsilon_round", "epsilon_total",
              "remaining", "exhausted")
FLOATS = ("sensitivity_estimate", "sensitivity_real", "sens_local_max",
          "sens_local_min")


@pytest.fixture(scope="module")
def R():
    ref = load_reference()
    import importlib
    importlib.import_module("repro.api.hooks")
    return ref


def _ref_mlp_loss(p, batch, key):
    x, y = batch
    h = jnp.tanh(x @ p["l1"])
    h = jnp.tanh(h @ p["l2"])
    logp = jax.nn.log_softmax(h @ p["l3"])
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


def _sessions(R, *, noise=True, chunk=CHUNK):
    key = jax.random.PRNGKey(SEED)
    k1, k2, k3 = jax.random.split(key, 3)
    s = lambda k, shape: np.asarray(jax.random.normal(k, shape)
                                    / jnp.sqrt(shape[0]))
    params = {"l1": s(k1, (D_IN, HIDDEN)), "l2": s(k2, (HIDDEN, D_IN)),
              "l3": s(k3, (D_IN, N_CLASSES))}
    task = R.data.SyntheticClassification(d_in=D_IN, n_classes=N_CLASSES,
                                          seed=SEED)
    skew = R.data.dirichlet_partition(N, N_CLASSES, seed=SEED)
    batches = [jax.tree_util.tree_map(np.asarray, task.node_batches(
        jax.random.fold_in(jax.random.PRNGKey(SEED + 1), t), N, BATCH,
        skew)) for t in range(ROUNDS)]
    privacy = dict(b=1.0, gamma_n=GAMMA_N, noise=noise)
    deploy = dict(algorithm="partpsp", gamma_l=0.1, gamma_s=0.1, clip=100.0,
                  schedule="dense", sync_interval=SYNC, chunk=chunk,
                  seed=SEED, partition=PARTITIONS["partpsp-2"])
    ref_session = R.api.Session.build(
        R.core.topology.DOutGraph(N, 2),
        privacy=R.api.PrivacySpec(**privacy), model=_ref_mlp_loss,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        use_kernels=noise, **deploy)
    session = Session.build(T.DOutGraph(N, 2), privacy=PrivacySpec(**privacy),
                            model=mlp_loss,
                            params=tree_from_numpy(params, device="cpu"),
                            device="cpu", **deploy)
    return ref_session, session, batches


def _train_both(R, driver, port_hooks, ref_hooks, *, noise=True,
                chunk=CHUNK):
    ref_session, session, batches = _sessions(R, noise=noise, chunk=chunk)
    ref_rep = ref_session.train(ROUNDS, lambda t: jax.tree_util.tree_map(
        jnp.asarray, batches[t]), hooks=ref_hooks, driver=driver)
    d_s = session.partition.d_shared()
    base = jax.random.PRNGKey(SEED)
    template = ref_session.train_state().dpps.push.s
    if not noise:
        bits_at = None
    elif driver == "loop":  # the reference's tree route: per-leaf keys
        bits_at = lambda t: [torch.from_numpy(b) for b in reference_tree_bits(
            jax.random.split(jax.random.fold_in(base, t), 3)[2], template)]
    else:
        bits_at = lambda t: torch.from_numpy(reference_bits(
            SEED, t, N, d_s, partpsp=True))
    rep = session.train(ROUNDS, lambda t: tree_from_numpy(batches[t],
                                                          device="cpu"),
                        bits_at=bits_at, hooks=port_hooks, driver=driver)
    return rep, ref_rep


def _entries_match(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ACCOUNTING:
            assert g[k] == w[k], (k, g[k], w[k])
        for k in FLOATS:
            if w.get(k) is None:
                assert g.get(k) is None, k
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("driver", ["engine", "loop"])
def test_ledger_metrics_and_real_sensitivity_match_reference(R, tmp_path,
                                                             driver):
    paths = [str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")]
    lines = [[], []]
    port_hooks = [LedgerHook(paths[0], budget=1e9),
                  MetricsHook(print_fn=lines[0].append, log_every=2,
                              total=ROUNDS),
                  RealSensitivityHook()]
    ref_hooks = [R.api.hooks.LedgerHook(paths[1], budget=1e9),
                 R.api.hooks.MetricsHook(print_fn=lines[1].append,
                                         log_every=2, total=ROUNDS),
                 R.api.hooks.RealSensitivityHook()]
    rep, ref_rep = _train_both(R, driver, port_hooks, ref_hooks)
    got, want = (PrivacyLedger.read_jsonl(p) for p in paths)
    assert len(got) == ROUNDS and [e["synced"] for e in got].count(True) == 1
    _entries_match(got, want)
    summary, ref_summary = port_hooks[0].summary(), ref_hooks[0].summary()
    assert set(summary) == set(ref_summary)
    for k, v in ref_summary.items():
        if isinstance(v, float) and k == "sensitivity_estimate_mean":
            np.testing.assert_allclose(summary[k], v, rtol=RTOL)
        else:
            assert summary[k] == v, k
    hist, ref_hist = port_hooks[1].history, ref_hooks[1].history
    assert [r["step"] for r in hist] == [r["step"] for r in ref_hist]
    for r, w in zip(hist, ref_hist):
        for k in ("loss", "sensitivity"):
            np.testing.assert_allclose(r[k], w[k], rtol=RTOL, atol=ATOL)
    assert len(lines[0]) == len(lines[1]) == 4
    real = port_hooks[2]
    assert real.violations == ref_hooks[2].violations == 0
    np.testing.assert_allclose(real.reals, ref_hooks[2].reals, rtol=RTOL,
                               atol=ATOL)
    assert "sensitivity_real" in rep.trajectory
    assert "s_half" not in rep.trajectory
    assert rep.aborted is False and rep.abort_reason is None
    assert rep.wire_bytes == ref_rep.wire_bytes
    assert rep.summary()["rounds"] == ref_rep.summary()["rounds"] == ROUNDS


@pytest.mark.parametrize("driver,rounds", [("engine", CHUNK),
                                           ("loop", 3)])
def test_strict_budget_aborts_at_the_same_round(R, driver, rounds):
    """Epsilon 1e4 a round against a budget of 2.5e4: exceeded at round 2.
    The engine stops at the end of that round's segment, the loop after
    it; neither releases more rounds than the reference."""
    warned = [[], []]
    port = BudgetHook(2.5e4, strict=True, warn=warned[0].append)
    ref = R.api.hooks.BudgetHook(2.5e4, strict=True, warn=warned[1].append)
    rep, ref_rep = _train_both(R, driver, [port], [ref])
    assert rep.aborted is ref_rep.aborted is True
    assert rep.abort_reason == ref_rep.abort_reason
    assert "exhausted at round 2" in rep.abort_reason
    assert rep.rounds == ref_rep.rounds == rounds
    assert port.exceeded_at == ref.exceeded_at == 2
    assert warned[0] == warned[1] and len(warned[0]) == 1
    assert rep.epsilon_spent == ref_rep.epsilon_spent
    assert rep.trajectory["loss_mean"].shape == (rounds,)


def test_a_non_strict_budget_warns_and_runs_on(R):
    warned = []
    hook = BudgetHook(2.5e4, warn=warned.append)
    _, session, batches = _sessions(R)
    rep = session.train(ROUNDS, lambda t: tree_from_numpy(batches[t],
                                                          device="cpu"),
                        hooks=[hook])
    assert rep.rounds == ROUNDS and not rep.aborted
    assert len(warned) == 1 and "exceeded at round 2" in warned[0]


def test_hooks_finish_after_an_abort_and_see_the_report(R):
    events = []

    class Probe(RoundHook):
        def finish(self):
            events.append("finish")

        def finish_run(self, report):
            events.append(("report", report.rounds, report.aborted))

    _, session, batches = _sessions(R)
    session.train(ROUNDS, lambda t: tree_from_numpy(batches[t], device="cpu"),
                  hooks=[BudgetHook(1.0, strict=True, warn=lambda m: None),
                         Probe()], driver="loop")
    assert events == ["finish", ("report", 1, True)]


def test_hook_trace_spec_rules(R):
    class Tap(RoundHook):
        tap = object()

    class Wire(RoundHook):
        needs_wire_stats = True

    with pytest.raises(ValueError, match="at most one tap"):
        hook_trace_spec([Tap(), Tap()])
    spec = hook_trace_spec([Tap(), Wire(), RealSensitivityHook()])
    ref_spec = R.api.hooks.hook_trace_spec([Tap(), Wire(),
                                            R.api.hooks.RealSensitivityHook()])
    assert (spec.needs_s_half, spec.needs_adjacency, spec.needs_wire_stats) \
        == (ref_spec.needs_s_half, ref_spec.needs_adjacency,
            ref_spec.needs_wire_stats) == (True, False, True)
    assert hook_trace_spec([]) == (None, False, False, False)
    # the transcript hook carries the tap (the audit lab, ported since
    # the hook raised naming its ROADMAP item)
    from repro_torch.audit import TranscriptTap
    spec = hook_trace_spec([TranscriptHook(), Wire()])
    ref_spec = R.api.hooks.hook_trace_spec([R.api.TranscriptHook(), Wire()])
    assert spec.tap == TranscriptTap() and ref_spec.tap is not None
    assert spec[1:] == tuple(ref_spec[1:])
    with pytest.raises(ValueError, match="at most one tap"):
        hook_trace_spec([TranscriptHook(), Tap()])


def test_capture_rows_shows_s_half_to_the_hooks_only():
    seen = []

    class Peek(RoundHook):
        def capture(self, diag):
            seen.append(diag["s_half"])
            return {"peek": torch.tensor(1.0)}

    half = torch.ones(3, 4)
    out = capture_rows({"s_half": half, "a_min": torch.tensor(1.0)},
                       [Peek()])
    assert set(out) == {"a_min", "peek"} and seen[0] is half


def test_metrics_hook_publishes_to_the_bus():
    bus = MetricsBus()
    hook = MetricsHook(fields={"loss": "loss_mean"}, print_fn=lambda m: None,
                       bus=bus)
    hook.consume({"loss_mean": np.array([1.5, 2.5])}, t0=3)
    assert bus.snapshot()["gauges"]["metrics.loss"] == 2.5
    assert [r["step"] for r in hook.history] == [3, 4]
    assert default_bus() is default_bus()


@pytest.mark.parametrize("schedule", ["dense", "circulant", "sparse"])
def test_wire_bytes_match_reference(R, schedule):
    port = Session.build(T.DOutGraph(6, 2), schedule=schedule, device="cpu")
    ref = R.api.Session.build(R.core.topology.DOutGraph(6, 2),
                              schedule=schedule)
    for rounds, d_s in ((1, 7), (13, 1000)):
        assert estimate_wire_bytes(port.plan, 6, d_s, rounds) == \
            R.api.results.estimate_wire_bytes(ref.plan, 6, d_s, rounds)
    assert estimate_wire_bytes(None, 4, 10, 2) == \
        R.api.results.estimate_wire_bytes(None, 4, 10, 2)


# -- the launcher ----------------------------------------------------------------

ARGS = ["--reduced", "--device", "cpu", "--nodes", "4", "--steps", "3",
        "--gamma-n", "1e-6", "--log-every", "1"]


@pytest.mark.parametrize("driver", ["engine", "loop"])
def test_train_cli_ledger_and_metrics_out(capsys, tmp_path, driver):
    ledger, metrics = str(tmp_path / "l.jsonl"), str(tmp_path / "m.json")
    train_cli.main(ARGS + ["--driver", driver, "--ledger-out", ledger,
                           "--metrics-out", metrics])
    out = capsys.readouterr().out
    entries = PrivacyLedger.read_jsonl(ledger)
    assert [e["round"] for e in entries] == [0, 1, 2]
    assert all(e["protected"] for e in entries)
    summary = json.loads(out.split("privacy: ")[1].splitlines()[0])
    assert summary["rounds"] == summary["rounds_recorded"] == 3
    assert summary["sensitivity_violations"] == 0
    assert f"privacy ledger written to {ledger}" in out
    history = json.loads(open(metrics).read())
    assert [r["step"] for r in history] == [0, 1, 2]
    assert set(history[0]) == {"step", "loss", "sensitivity", "grad_l1_max"}
    steps = [line for line in out.splitlines() if line.startswith("step")]
    assert len(steps) == 3


def test_train_cli_budget_warns_and_writes_the_checkpoint(capsys, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    train_cli.main(ARGS + ["--driver", "loop", "--privacy-budget", "1e-3",
                           "--checkpoint", ckpt])
    out = capsys.readouterr().out
    assert "WARNING: privacy budget 0.001 exceeded at round 0" in out
    assert os.path.isfile(os.path.join(ckpt, "meta.json"))


@pytest.mark.parametrize("driver", ["engine", "loop"])
def test_train_cli_strict_budget_aborts_without_a_checkpoint(capsys,
                                                             tmp_path,
                                                             driver):
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(SystemExit, match="privacy budget exhausted"):
        train_cli.main(ARGS + ["--driver", driver, "--privacy-budget",
                               "1e-3", "--strict-budget", "--checkpoint",
                               ckpt])
    out = capsys.readouterr().out
    assert f"checkpoint NOT written (over budget): {ckpt}" in out
    assert not os.path.exists(ckpt)
    summary = json.loads(out.split("privacy: ")[1].splitlines()[0])
    assert summary["exhausted"] is True
    assert summary["rounds"] == (3 if driver == "engine" else 1)
