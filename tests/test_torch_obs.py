"""The port's observability layer against the reference's ``repro.obs``.

* Phase tracing: the ``PHASE_*`` strings; ``Session.profile`` of
  ``tests/test_obs.py``'s session (dout(8), sync every 3 rounds, 4 rounds)
  on the CPU, packed and pytree: its phases lie in ``KNOWN_PHASES`` and
  ``"unattributed"``, sum to ``device_total_s``, and name every phase the
  reference's breakdown names on the same session and plan (no exception
  is needed: the port's sync round falls in the profiled segment, as the
  reference's ``lax.cond`` is traced into every round). A run inside an
  active profiler is bit-equal to one outside it; the passed state
  survives ``profile``; ``phase()`` opens no ``record_function`` unless a
  profiler records.
* Exporters: the same bus calls give identical Prometheus text, and JSONL
  lines equal but for their timestamps.
* Watchdog: the same rows give identical ``Alert`` lists, warn lines and
  bus alert events (nonfinite, mass drift, residual trend, sensitivity
  gap, staleness, participation, wire residual), and a strict hook aborts
  at the same round; a NaN session run alerts and aborts as the
  reference's does.
* Timeline: the same ``segment_span`` calls and async rows give identical
  Chrome-trace JSON; ``validate_chrome_trace`` rejects the same malformed
  objects; an async session run records the message lifecycle.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import load_reference

from repro_torch.api import PrivacySpec, Session
from repro_torch.core import topology as T
from repro_torch.net import DelayModel
from repro_torch.obs import (KNOWN_PHASES, JsonlExporter, MetricsBus,
                             ProfileReport, TimelineHook,
                             WatchdogAbort, WatchdogHook, phase,
                             prometheus_text, validate_chrome_trace)
from repro_torch.obs import trace as port_trace
from repro_torch.obs.metrics import HistogramSummary

N, T_ROUNDS = 8, 6


@contextlib.contextmanager
def xplane_bindings():
    """The reference's xplane join imports ``xplane_pb2`` from TensorFlow,
    whose import takes seconds (20 s under the suite's load). The module
    itself is plain protobuf code: where TensorFlow is not imported, it is
    loaded from its file under stub parent packages for the duration of
    the ``with`` (only the reference's calls run inside it), then the stubs
    are removed. Where TensorFlow is imported, the real one serves."""
    import importlib.util
    import sys
    import types

    spec = (None if "tensorflow" in sys.modules
            else importlib.util.find_spec("tensorflow"))
    if spec is None:
        yield
        return
    names = ["tensorflow", "tensorflow.tsl", "tensorflow.tsl.profiler",
             "tensorflow.tsl.profiler.protobuf"]
    leaf = names[-1] + ".xplane_pb2"
    if _XPLANE.get("module") is None:
        file = (f"{spec.submodule_search_locations[0]}"
                "/tsl/profiler/protobuf/xplane_pb2.py")
        mod_spec = importlib.util.spec_from_file_location(leaf, file)
        _XPLANE["module"] = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(_XPLANE["module"])
    try:
        for name in names:
            sys.modules[name] = types.ModuleType(name)
        sys.modules[leaf] = _XPLANE["module"]
        sys.modules[names[-1]].xplane_pb2 = _XPLANE["module"]
        yield
    finally:
        for name in names + [leaf]:
            sys.modules.pop(name, None)


_XPLANE: dict = {}


@pytest.fixture(scope="module")
def R():
    ref = load_reference()
    for name in ("repro.obs", "repro.obs.trace", "repro.obs.watchdog",
                 "repro.obs.timeline", "repro.obs.export", "repro.net"):
        importlib.import_module(name)
    return ref


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(N, 11)).astype(np.float32),
            rng.normal(size=(N, 2, 3)).astype(np.float32)]


def _port_session(**kw):
    topo = T.DOutGraph(n_nodes=N, d=2)
    cp, lam = T.calibrate_constants(topo)
    kw.setdefault("privacy", PrivacySpec(b=5.0, gamma_n=0.02, c_prime=cp,
                                         lam=lam))
    kw.setdefault("sync_interval", 3)
    return Session.build(topo, device="cpu", **kw)


def _ref_session(R, **kw):
    topo = R.core.topology.DOutGraph(n_nodes=N, d=2)
    cp, lam = R.core.topology.calibrate_constants(topo)
    kw.setdefault("privacy", R.api.PrivacySpec(b=5.0, gamma_n=0.02,
                                               c_prime=cp, lam=lam))
    kw.setdefault("sync_interval", 3)
    return R.api.Session.build(topo, **kw)


def _torch(values):
    return [torch.from_numpy(v.copy()) for v in values]


# -- phase tracing -----------------------------------------------------------

def test_phase_vocabulary_matches_the_reference(R):
    ref = R.obs.trace
    names = sorted(k for k in dir(ref) if k.startswith("PHASE_"))
    assert names == sorted(k for k in dir(port_trace)
                           if k.startswith("PHASE_"))
    for k in names:
        assert getattr(port_trace, k) == getattr(ref, k)
    assert set(port_trace.KNOWN_PHASES) <= {getattr(ref, k) for k in names}


def test_phase_breakdown_rule_is_outermost():
    """A nested phase attributes to its outer one, an op outside every
    phase to ``unattributed``, and a phase that ran no op is listed at 0."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        x = torch.ones(64, 64)
        with phase("dpps_gossip"):
            y = x @ x
            with phase("pushsum_mix"):
                y = y + 1
        with phase("engine_unpack"):
            pass
        z = y * 2
    phases, total, note = port_trace.phase_breakdown(prof.events(),
                                                     device="cpu")
    assert note is None and z.shape == (64, 64)
    assert set(phases) == {"dpps_gossip", "engine_unpack", "unattributed"}
    assert phases["engine_unpack"] == 0.0 and phases["dpps_gossip"] > 0
    assert sum(phases.values()) == pytest.approx(total, rel=1e-9)


def test_the_reference_breakdown_has_its_bindings(R, tmp_path):
    """The reference's xplane join finds its protobuf bindings
    (``xplane_bindings``), and an empty trace directory gives no
    durations."""
    with xplane_bindings():
        from tensorflow.tsl.profiler.protobuf import xplane_pb2

        assert xplane_pb2.XSpace().planes is not None
        assert R.obs.trace.xplane_durations(str(tmp_path)) is None


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "pytree"])
def test_profile_names_the_reference_phases(R, packed):
    values = _values()
    report = _port_session(packed=packed).profile(4, values=_torch(values))
    with xplane_bindings():
        ref = _ref_session(R, packed=packed).profile(
            rounds=4, values=[jnp.asarray(v) for v in values])
    assert isinstance(report, ProfileReport)
    assert report.rounds == 4 and report.backend == "torch-cpu"
    assert report.trace_s == 0.0 and report.compile_s > 0
    assert report.execute_s > 0 and report.note is None
    assert report.wall_clock == pytest.approx(report.compile_s
                                              + report.execute_s)
    assert report.device_total_s > 0
    assert set(report.phases) <= set(KNOWN_PHASES) | {"unattributed"}
    assert sum(report.phases.values()) == pytest.approx(
        report.device_total_s, rel=1e-9)
    assert ref.phases, ref.note  # the reference's xplane join is real here
    assert set(ref.phases) <= set(report.phases)
    assert set(report.summary()) == set(ref.summary())


def test_profile_of_a_training_segment_names_the_gradient_phases():
    from repro_torch.models.mlp import PARTITIONS, mlp_loss

    topo = T.DOutGraph(n_nodes=4, d=2)
    rng = np.random.default_rng(1)
    params = {"l1": torch.from_numpy(rng.normal(size=(6, 5)).astype(
                  np.float32) * 0.3),
              "l2": torch.from_numpy(rng.normal(size=(5, 6)).astype(
                  np.float32) * 0.3),
              "l3": torch.from_numpy(rng.normal(size=(6, 3)).astype(
                  np.float32) * 0.3)}
    session = Session.build(topo, privacy=PrivacySpec(b=3.0, gamma_n=1e-4),
                            model=mlp_loss, params=params,
                            partition=PARTITIONS["partpsp-1"], device="cpu",
                            sync_interval=0)
    x = torch.from_numpy(rng.normal(size=(4, 8, 6)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, size=(4, 8)))
    report = session.profile(2, batch_at=lambda t: (x, y))
    for name in ("partpsp_local_grads", "partpsp_shared_grads",
                 "partpsp_clip", "dpps_perturb", "dpps_noise", "dpps_gossip"):
        assert report.phases.get(name, 0.0) > 0.0, name
    assert sum(report.phases.values()) == pytest.approx(
        report.device_total_s, rel=1e-9)


def test_a_run_inside_a_profiler_is_bit_equal():
    session = _port_session()
    plain = session.run(T_ROUNDS, values=_torch(_values()))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = session.run(T_ROUNDS, values=_torch(_values()))
    for a, b in zip(plain.state.push.s, traced.state.push.s):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in plain.trajectory:
        np.testing.assert_array_equal(plain.trajectory[k],
                                      traced.trajectory[k])


def test_profile_leaves_the_passed_state_and_matches_run():
    session = _port_session()
    state = session.consensus_state(_torch(_values()))
    before = [x.clone() for x in state.push.s]
    report = session.profile(4, state=state, hooks=[WatchdogHook(
        bus=MetricsBus(), warn=lambda s: None)])
    assert "dpps_wire_stats" in report.phases  # the hook's capture ran
    for a, b in zip(before, state.push.s):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert state.t == 0


class _Counting:
    opened = 0

    def __init__(self, name):
        type(self).opened += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_phase_opens_no_range_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _Counting.opened = 0
    assert phase("dpps_gossip") is phase("dpps_noise")  # one shared no-op
    _port_session().run(T_ROUNDS, values=_torch(_values()))
    assert _Counting.opened == 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(phase("dpps_gossip"), _Counting)
    assert _Counting.opened == 1


# -- exporters ---------------------------------------------------------------

def _drive_bus(bus):
    bus.count("c")
    bus.count("c", 2.0, labels=[("node", "1")])
    bus.gauge("g", 1.5, round=3)
    bus.gauge("path", 1.0, labels=[("path", 'a"b\\c\nd')])
    bus.gauge("nanval", float("nan"))
    bus.gauge("posinf", float("inf"))
    bus.observe("h", 0.25, round=1)
    bus.observe("h", 0.75, count=2)
    bus.observe("5bad.name", 1.0)
    bus.alert("watchdog.mass_drift", "drift", value=0.1, round=4,
              labels=(("severity", "warn"),))
    bus.log("hello")


def test_exporters_match_the_reference(R):
    ref_export = R.obs.export
    bus, ref_bus = MetricsBus(ring=4), R.obs.MetricsBus(ring=4)
    out, ref_out = io.StringIO(), io.StringIO()
    exp = JsonlExporter(out).attach(bus)
    ref_exp = ref_export.JsonlExporter(ref_out).attach(ref_bus)
    _drive_bus(bus)
    _drive_bus(ref_bus)
    bus._hists[("empty", ())] = HistogramSummary()
    ref_bus._hists[("empty", ())] = R.obs.metrics.HistogramSummary()
    assert prometheus_text(bus) == ref_export.prometheus_text(ref_bus)
    exp.close()
    ref_exp.close()

    def strip(text):
        return [{k: v for k, v in json.loads(line).items() if k != "ts"}
                for line in text.splitlines()]

    assert strip(out.getvalue()) == strip(ref_out.getvalue())
    assert exp.written == ref_exp.written == 12  # 11 events + bus.dropped


# -- watchdog ----------------------------------------------------------------

def _ctx(R, max_delay=2, rates=(1, 2, 1, 1)):
    delays = SimpleNamespace(max_delay=max_delay, rates=rates)
    return SimpleNamespace(plan=SimpleNamespace(delays=delays))


def _rows(t, **extra):
    rows = {"wd_nonfinite": np.zeros(t, np.int32),
            "wd_mass_drift": np.zeros(t),
            "wd_consensus_residual": np.full(t, 0.5)}
    rows.update(extra)
    return rows


def _segments():
    """(segments of rows, whether the plan is async) a scenario."""
    nan = _rows(4, wd_nonfinite=np.array([0, 3, 5, 0], np.int32))
    mass = _rows(4, wd_mass_drift=np.array([0.0, 0.05, 0.2, 0.0]))
    trend = [_rows(4, wd_consensus_residual=np.array(r)) for r in
             ([1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 100.0, 100.0],
              [100.0, 100.0, 1e4, 1e4])]
    gap = _rows(4, sensitivity_estimate=np.full(4, 1.0),
                sensitivity_real=np.array([0.5, 0.9, 1.5, 0.2]))
    part = np.ones((4, 4), bool)
    part[:, 2] = False
    hist = np.tile(np.array([[3, 2, 1]], np.int32), (4, 1))
    stale = _rows(4, async_staleness_max=np.array([1, 2, 3, 0], np.int32),
                  async_participated=np.ones((4, 4), bool),
                  async_delay_hist=hist)
    silent = [_rows(4, async_staleness_max=np.zeros(4, np.int32),
                    async_participated=part, async_delay_hist=hist)
              for _ in range(3)]
    resid = [_rows(4, wd_wire_resid=np.array(r)) for r in
             ([1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 9.0, 9.0])]
    return {"nonfinite": ([nan], False), "mass": ([mass], False),
            "trend": (trend, False), "gap": ([gap], False),
            "staleness": ([stale], True), "participation": (silent, True),
            "wire_residual": (resid, False)}


@pytest.mark.parametrize("scenario", list(_segments()))
@pytest.mark.parametrize("strict", [False, True], ids=["warn", "strict"])
def test_watchdog_alerts_match_the_reference(R, scenario, strict):
    segments, asynchronous = _segments()[scenario]
    results = []
    for mod, bus in ((importlib.import_module("repro_torch.obs.watchdog"),
                      MetricsBus()),
                     (R.obs.watchdog, R.obs.MetricsBus())):
        lines = []
        hook = mod.WatchdogHook(strict=strict, trend_window=4,
                                warn=lines.append, bus=bus)
        if asynchronous:
            hook.prepare(_ctx(R))
        aborted = None
        for i, rows in enumerate(segments):
            try:
                hook.consume(rows, t0=10 + 4 * i)
            except mod.WatchdogAbort as e:
                aborted = (str(e), dataclasses.asdict(e.alert))
                break
        events = [(e.name, e.value, e.round, e.labels, e.message)
                  for e in bus.events("alert")]
        results.append(([dataclasses.asdict(a) for a in hook.alerts], lines,
                        events, aborted))
    assert results[0] == results[1]
    assert results[0][0], scenario  # every scenario finds something


def _nan_values():
    values = _values()
    values[0][2, 4] = np.nan
    return values


def test_watchdog_on_a_nan_run_matches_the_reference(R):
    values = _nan_values()
    session, ref = _port_session(chunk=3), _ref_session(R, chunk=3)
    found = []
    for s, mod, vals in ((session, importlib.import_module(
            "repro_torch.obs.watchdog"), _torch(values)),
            (ref, R.obs.watchdog, [jnp.asarray(v) for v in values])):
        hook = mod.WatchdogHook(warn=lambda m: None, bus=MetricsBus())
        s.run(T_ROUNDS, values=vals, hooks=[hook])
        first = next(a for a in hook.alerts if a.check == "nonfinite_wire")
        strict = mod.WatchdogHook(strict=True, warn=lambda m: None,
                                  bus=MetricsBus())
        report = s.run(T_ROUNDS, values=vals, hooks=[strict])
        found.append((first.round, first.severity, first.value,
                      report.aborted, report.rounds,
                      report.abort_reason.startswith("watchdog critical")))
    assert found[0] == found[1]
    assert found[0][:2] == (0, "critical") and found[0][3:] == (True, 3, True)


def test_watchdog_is_a_run_abort_and_reads_the_port_rows():
    from repro_torch.api import RunAbort

    assert issubclass(WatchdogAbort, RunAbort)
    hook = WatchdogHook(warn=lambda m: None, bus=MetricsBus())
    session = _port_session()
    plain = session.run(T_ROUNDS, values=_torch(_values()))
    watched = session.run(T_ROUNDS, values=_torch(_values()), hooks=[hook])
    for row in ("wd_nonfinite", "wd_mass_drift", "wd_consensus_residual"):
        assert watched.trajectory[row].shape == (T_ROUNDS,)
    for a, b in zip(plain.state.push.s, watched.state.push.s):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert hook.alerts == []


# -- timeline ----------------------------------------------------------------

def _drive_timeline(mod, bus):
    hook = mod.TimelineHook(bus=bus)
    plan = SimpleNamespace(schedule="dense",
                           delays=SimpleNamespace(max_delay=2))
    hook.prepare(SimpleNamespace(algorithm="dpps", n_nodes=4, rounds=8,
                                 d_s=17, plan=plan))
    rng = np.random.default_rng(3)
    start = 100.0
    for t0 in (0, 4):
        rows = {"async_delay_hist": rng.integers(0, 3, size=(4, 3)),
                "async_timeouts": rng.integers(0, 2, size=4),
                "async_staleness_max": rng.integers(0, 3, size=4),
                "async_active": rng.integers(2, 5, size=4),
                "async_inflight_mass": rng.random(4).astype(np.float32)}
        hook.consume(rows, t0=t0)
        hook.segment_span(t0=t0, n=4, start=start, execute_end=start + 0.5,
                          consume_end=start + 0.625, compiled=t0 == 0)
        start += 0.625
    hook.finish()
    hook.finish_run(SimpleNamespace(compile_s=0.5, run_s=0.75, rounds=8,
                                    aborted=False))
    hook.timeline.add_profile(ProfileReport(
        rounds=4, backend="x", trace_s=0.0, compile_s=0.25, execute_s=0.5,
        phases={"dpps_gossip": 0.25, "dpps_noise": 0.125},
        device_total_s=0.375))
    return hook.timeline.to_chrome_trace()


def test_timeline_matches_the_reference(R):
    bus, ref_bus = MetricsBus(), R.obs.MetricsBus()
    got = _drive_timeline(importlib.import_module("repro_torch.obs.timeline"),
                          bus)
    want = _drive_timeline(R.obs.timeline, ref_bus)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    validate_chrome_trace(got)
    assert bus.snapshot() == ref_bus.snapshot()


MALFORMED = [
    {"foo": []},
    {"traceEvents": {}},
    {"traceEvents": [{"name": "x", "ph": "Z", "pid": 1, "tid": 1, "ts": 0}]},
    {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": 0}]},
    {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": -1,
                      "dur": 1}]},
    {"traceEvents": [{"ph": "i", "pid": 1, "tid": 1, "ts": 0}]},
    {"traceEvents": [{"name": "x", "ph": "b", "pid": 1, "tid": 1, "ts": 0,
                      "cat": "m"}]},
    {"traceEvents": [{"name": "x", "ph": "b", "pid": 1, "tid": 1, "ts": 0,
                      "cat": "m", "id": 3}]},
    {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": 0,
                      "dur": 5}]},
]


@pytest.mark.parametrize("obj", MALFORMED, ids=range(len(MALFORMED)))
def test_validate_chrome_trace_matches_the_reference(R, obj):
    def outcome(fn):
        try:
            fn(obj)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(validate_chrome_trace) == outcome(
        R.obs.timeline.validate_chrome_trace)


def test_timeline_hook_records_an_async_run(tmp_path):
    path = tmp_path / "trace.json"
    bus = MetricsBus()
    hook = TimelineHook(str(path), bus=bus)
    session = _port_session(sync_interval=0, chunk=4, delays=DelayModel(
        max_delay=2, timeout_rate=0.3, seed=1))
    report = session.run(12, values=_torch(_values()), hooks=[hook])
    obj = json.loads(path.read_text())
    validate_chrome_trace(obj)
    evs = obj["traceEvents"]
    segs = [e for e in evs if e.get("cat") == "segment" and e["tid"] == 1]
    assert [e["name"] for e in segs] == ["trace/compile+execute", "execute",
                                         "execute"]
    sends = [e for e in evs if e["ph"] == "b"]
    assert sum(e["args"]["count"] for e in sends) == int(
        report.trajectory["async_delay_hist"].sum())
    assert [e for e in evs if e["name"] == "msg send->timeout"]
    assert len([e for e in evs if e["ph"] == "C"]) == 12
    assert obj["otherData"]["rounds"] == 12
    assert bus.snapshot()["histograms"]["timeline.execute_s"]["count"] == 3
