"""Bounded-delay async push-sum of the port (``repro_torch.net.delays``)
against the reference's, on the CPU.

* ``DelayModel.open_round`` fed the reference's timeouts and delays
  (``reference_delay_draws``), dense and sparse, from a mailbox with mass
  in flight: the state, the mailbox and the float ``async_*`` stats to rtol
  1e-5, the integer and boolean stats exactly.
* ``Session.run`` and ``Session.train`` (engine and loop) under delays,
  faults composed, against the reference's: consensus to rtol 1e-5,
  training to rtol 1e-4 (1e-5 of each array's largest magnitude added to
  atol), the ``async_*`` and ``net_*`` rows and the ledger's staleness,
  timeouts and participation exactly.
* The reference's own checks, on the port's Philox streams: an inactive
  ``DelayModel()`` is bit for bit the synchronous run (dense and sparse,
  packed and pytree) and adds no mailbox; mass conserved to 1e-5 for every
  model and schedule; staleness <= B; the participation pattern of the
  node rates; timeouts re-credited the same round; faults compose;
  noiseless consensus still comes; loop equals engine (bit for bit over
  the pytree runtime, rtol 1e-6 against the packed buffer: the CPU matmul
  sums a wider row in another order); packed against pytree (rtol 1e-6);
  every validation error; the staleness on the metrics bus.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_net import (SEED, _close, _draws_at, _trees_close,
                            _trees_equal, _values, ledgers_equal,
                            reports_close, train_both)
from test_torch_reference import (load_reference, reference_bits,
                                  reference_delay_draws,
                                  reference_fault_draws, reference_tree_bits,
                                  to_numpy)

from repro_torch.api import LedgerHook, PrivacySpec, Session
from repro_torch.convert import tree_from_numpy
from repro_torch.core import topology as T
from repro_torch.core.dpps import DPPSConfig, DPPSState, dpps_init
from repro_torch.core.pushsum import PushSumState
from repro_torch.core.tree_utils import tree_leaves
from repro_torch.engine import ProtocolPlan, run_dpps
from repro_torch.net import DelayModel, FaultModel, Mailbox, NetworkStatsHook
from repro_torch.obs import MetricsBus

N, ROUNDS = 8, 12
REF_ROUNDS = 6  # rounds of a comparison with the reference
TOPO = T.DOutGraph(N, 2)
CP, LAM = T.calibrate_constants(TOPO)
DM_KW = dict(max_delay=2, timeout_rate=0.05, rates=(1, 1, 2, 1, 1, 3, 1, 1),
             seed=7)
DM = DelayModel(**DM_KW)
MODELS = [DelayModel(max_delay=1), DelayModel(max_delay=4, seed=3),
          DelayModel(timeout_rate=0.3),
          DelayModel(max_delay=2, timeout_rate=0.5, seed=1),
          DelayModel(rates=(1, 2, 4, 1, 1, 2, 1, 3)), DM]


@pytest.fixture(scope="module")
def R():
    ref = load_reference()
    import importlib
    for name in ("repro.net", "repro.api.hooks"):
        importlib.import_module(name)
    return ref


def _cfg(**kw):
    kw = dict(dict(b=5.0, gamma_n=0.02, c_prime=CP, lam=LAM,
                   sync_interval=0), **kw)
    return DPPSConfig(**kw)


def _run(plan, cfg, *, rounds=ROUNDS, state=None, seed=42):
    if state is None:
        state = dpps_init(tree_from_numpy(_values(np.random.default_rng(0)),
                                          device="cpu"), cfg)
    return run_dpps(state, None, cfg=cfg, plan=plan, rounds=rounds,
                    seed=seed)


def _plan(dm=None, **kw):
    kw = dict(dict(sync_interval=0, device="cpu"), **kw)
    return ProtocolPlan.from_topology(TOPO, delays=dm, **kw)


# -- open_round against the reference's --------------------------------------

@pytest.mark.parametrize("dm_kw", [DM_KW, dict(max_delay=3, timeout_rate=0.3,
                                               seed=2)])
@pytest.mark.parametrize("schedule", ["dense", "sparse"])
def test_open_round_matches_reference(R, schedule, dm_kw):
    """Three rounds of one mailbox with mass in flight, fed the reference's
    draws; the realized weights of a faulted round as the operands."""
    rng = np.random.default_rng(4)
    dm, rdm = DelayModel(**dm_kw), R.net.DelayModel(**dm_kw)
    b = dm.max_delay
    tree = _values(rng)
    old = PushSumState(s=tree_from_numpy(tree, device="cpu"),
                       a=torch.ones(N))
    w = TOPO.weight_matrix(0).astype(np.float32)
    ops = {"w": w} if schedule == "dense" else dict(zip(
        ("sparse_idx", "sparse_vals"), T.padded_csr(w, 2)))
    shape = w.shape if schedule == "dense" else ops["sparse_idx"].shape
    mail = Mailbox(
        cal_s=[rng.normal(size=(b,) + x.shape).astype(np.float32) * 0.1
               for x in tree],
        cal_a=np.full((b, N), 0.05, np.float32),
        inbox_s=[rng.normal(size=x.shape).astype(np.float32) * 0.1
                 for x in tree],
        inbox_a=np.full((N,), 0.02, np.float32))
    r_old = R.core.pushsum.PushSumState(
        s=[jnp.asarray(x) for x in tree], a=jnp.ones(N))
    r_mail = R.net.Mailbox(*jax.tree_util.tree_map(jnp.asarray, tuple(mail)))
    mail = Mailbox(*[tree_from_numpy(x, device="cpu") for x in mail])
    for t in range(3):
        half = [x + 0.01 * rng.normal(size=x.shape).astype(np.float32)
                for x in tree]
        gossip, close = dm.open_round(
            old, mail, t, draws=reference_delay_draws(dm, SEED, t, shape),
            **{k: torch.from_numpy(v) for k, v in ops.items()})
        new = gossip(PushSumState(s=tree_from_numpy(half, device="cpu"),
                                  a=old.a))
        mail, stats = close()
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), t)
        r_gossip, r_close = rdm.open_round(
            r_old, r_mail, key, t,
            **{k: jnp.asarray(v) for k, v in ops.items()})
        r_new = r_gossip(R.core.pushsum.PushSumState(
            s=[jnp.asarray(x) for x in half], a=r_old.a))
        r_mail, r_stats = r_close()
        _trees_close(new, r_new, 1e-5)
        _trees_close(mail, r_mail, 1e-5)
        assert set(stats) == set(r_stats)
        for k, v in r_stats.items():
            v = np.asarray(v)
            if v.dtype.kind in "biu":
                np.testing.assert_array_equal(to_numpy(stats[k]), v, k)
            else:
                _close(stats[k], v, 1e-5)
        old, r_old = new, r_new
        tree = [to_numpy(x) for x in new.s]
    with pytest.raises(ValueError, match="exactly one"):
        dm.open_round(old, mail, 0)
    _, close = dm.open_round(old, mail, 0, w=torch.from_numpy(w))
    with pytest.raises(RuntimeError, match="before the gossip"):
        close()


# -- sessions against the reference -----------------------------------------

@pytest.mark.parametrize("schedule,packed,noise", [
    ("dense", True, True), ("sparse", False, False)])
def test_session_run_matches_reference_under_delays(R, schedule, packed,
                                                    noise):
    """Consensus under delays and faults with a LedgerHook: states,
    mailboxes and trajectories to rtol 1e-5, integer rows and the ledger's
    async fields exactly."""
    vals = _values(np.random.default_rng(5))
    jvals = [jnp.asarray(v) for v in vals]
    fm_kw = dict(drop_rate=0.2, seed=4)
    deploy = dict(schedule=schedule, sync_interval=0, chunk=4, seed=SEED,
                  packed=packed)
    privacy = dict(b=5.0, gamma_n=0.02, noise=noise, c_prime=CP, lam=LAM)
    ref = R.api.Session.build(
        R.core.topology.DOutGraph(N, 2), privacy=R.api.PrivacySpec(**privacy),
        use_kernels=noise, faults=R.net.FaultModel(**fm_kw),
        delays=R.net.DelayModel(**DM_KW), **deploy)
    ref_ledger = R.api.LedgerHook()
    ref_rep = ref.run(REF_ROUNDS, values=jvals, hooks=[ref_ledger])
    session = Session.build(TOPO, privacy=PrivacySpec(**privacy),
                            device="cpu", faults=FaultModel(**fm_kw),
                            delays=DM, **deploy)
    base = jax.random.PRNGKey(SEED)
    if not noise:
        bits_at = None
    elif packed:
        bits_at = lambda t: torch.from_numpy(reference_bits(SEED, t, N, 17))
    else:
        bits_at = lambda t: [torch.from_numpy(b) for b in reference_tree_bits(
            jax.random.fold_in(base, t), jvals)]
    plan = session.plan
    ledger = LedgerHook()
    rep = session.run(
        REF_ROUNDS, values=tree_from_numpy(vals, device="cpu"), bits_at=bits_at,
        hooks=[ledger],
        fault_draws_at=_draws_at(plan.faults, plan, reference_fault_draws),
        delay_draws_at=_draws_at(plan.delays, plan, reference_delay_draws))
    assert set(rep.trajectory) == set(ref_rep.trajectory)
    for k, v in ref_rep.trajectory.items():
        v = np.asarray(v)
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(rep.trajectory[k], v, k)
        else:
            _close(rep.trajectory[k], v, 1e-5)
    _trees_close(rep.state.push, ref_rep.state.push, 1e-5)
    _trees_close(rep.state.mail, ref_rep.state.mail, 1e-5)
    ledgers_equal(ledger.ledger.entries, ref_ledger.ledger.entries)
    assert {"staleness_max", "timeouts", "participating"} <= set(
        ledger.ledger.entries[0])
    np.testing.assert_allclose(rep.trajectory["async_mass_mean"], 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("driver,noise", [("engine", False), ("loop", True)])
def test_train_matches_reference_under_delays(R, driver, noise):
    rep, ref_rep = train_both(R, dict(delays=DM_KW, sync_interval=0,
                                      faults=dict(drop_rate=0.2),
                                      noise=noise), driver=driver)
    reports_close(rep, ref_rep)
    _trees_close(rep.state.dpps.mail, ref_rep.state.dpps.mail, 1e-4, 1e-5)


# -- the reference's checks on the port's own streams ------------------------

@pytest.mark.parametrize("schedule", ["dense", "sparse"])
@pytest.mark.parametrize("packed", [False, True])
def test_inactive_delay_model_bit_identical_to_sync(schedule, packed):
    cfg = _cfg()
    plan_sync = _plan(schedule=schedule, packed=packed)
    plan_null = _plan(DelayModel(), schedule=schedule, packed=packed)
    assert plan_null.delays is None
    out_s, traj_s = _run(plan_sync, cfg)
    out_n, traj_n = _run(plan_null, cfg)
    _trees_equal(out_s, out_n)
    assert sorted(traj_s) == sorted(traj_n)
    for k, v in traj_s.items():
        assert torch.equal(v, traj_n[k])
    assert out_n.mail == ()


@pytest.mark.parametrize("schedule", ["dense", "sparse"])
def test_packed_matches_pytree_under_delays(schedule):
    outs = {packed: _run(_plan(DM, schedule=schedule, packed=packed), _cfg())
            for packed in (False, True)}
    for x, y in zip(tree_leaves(outs[False][0]), tree_leaves(outs[True][0])):
        if isinstance(x, torch.Tensor):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    for k, v in outs[False][1].items():
        torch.testing.assert_close(v, outs[True][1][k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dm", MODELS, ids=range(len(MODELS)))
@pytest.mark.parametrize("schedule", ["dense", "sparse"])
def test_mass_conserved_and_staleness_bounded(dm, schedule):
    """state + inbox + calendar mass averages 1 a node every round (1e-5);
    no delivered message is older than B; the histogram has B + 1 bins."""
    out, traj = _run(_plan(dm, schedule=schedule), _cfg())
    np.testing.assert_allclose(to_numpy(traj["async_mass_mean"]), 1.0,
                               atol=1e-5)
    assert all(bool(torch.isfinite(x).all()) for x in out.push.s)
    assert int(traj["async_staleness_max"].max()) <= dm.max_delay
    assert traj["async_delay_hist"].shape[-1] == dm.max_delay + 1


def test_heterogeneous_rates_participation_pattern():
    dm = DelayModel(rates=(1, 2, 3, 4, 1, 2, 3, 4))
    _, traj = _run(_plan(dm), _cfg())
    part = to_numpy(traj["async_participated"])
    expect = (np.arange(ROUNDS)[:, None] % np.asarray(dm.rates)[None]) == 0
    np.testing.assert_array_equal(part, expect)
    assert to_numpy(traj["async_active"]).tolist() == \
        expect.sum(axis=1).tolist()


def test_timeouts_recredit_mass_same_round():
    _, traj = _run(_plan(DelayModel(max_delay=3, timeout_rate=0.6, seed=2)),
                   _cfg())
    assert int(traj["async_timeouts"].sum()) > 0
    np.testing.assert_allclose(to_numpy(traj["async_mass_mean"]), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("schedule", ["dense", "sparse"])
def test_faults_compose_with_delays(schedule):
    plan = _plan(DM, schedule=schedule,
                 faults=FaultModel(drop_rate=0.2, seed=4))
    assert plan.dynamic and plan.delays is DM
    _, traj = _run(plan, _cfg())
    assert int(traj["net_dropped_edges"].sum()) > 0
    np.testing.assert_allclose(to_numpy(traj["async_mass_mean"]), 1.0,
                               atol=1e-5)


def test_noiseless_async_consensus_converges():
    """Delays slow the mixing but do not bias it."""
    cfg = _cfg(noise=False)
    s0 = tree_from_numpy(_values(np.random.default_rng(0)), device="cpu")
    out, _ = _run(_plan(DM), cfg, rounds=300, state=dpps_init(s0, cfg))
    y = out.push.s[0] / out.push.a[:, None]
    torch.testing.assert_close(y, s0[0].mean(0).expand_as(y), rtol=0,
                               atol=2e-3)


@pytest.mark.parametrize("packed", [False, True])
def test_loop_matches_engine_under_delays(packed):
    from test_torch_net import D_IN, HIDDEN, N_CLASSES
    from repro_torch.models.mlp import PARTITIONS, mlp_loss

    session = Session.build(
        TOPO, privacy=PrivacySpec(b=5.0, gamma_n=1e-4, c_prime=CP, lam=LAM),
        model=mlp_loss, params=tree_from_numpy(
            {"l1": np.full((D_IN, HIDDEN), 0.1, np.float32),
             "l2": np.full((HIDDEN, D_IN), 0.1, np.float32),
             "l3": np.full((D_IN, N_CLASSES), 0.1, np.float32)},
            device="cpu"), partition=PARTITIONS["partpsp-2"], device="cpu",
        sync_interval=0, chunk=4, packed=packed, seed=SEED, delays=DM)
    gen = torch.Generator().manual_seed(0)
    batches = [(torch.randn((N, 8, D_IN), generator=gen),
                torch.randint(0, N_CLASSES, (N, 8), generator=gen))
               for _ in range(ROUNDS)]
    engine = session.train(ROUNDS, lambda t: batches[t])
    loop = session.train(ROUNDS, lambda t: batches[t], driver="loop")
    if packed:
        for x, y in zip(tree_leaves(engine.state), tree_leaves(loop.state)):
            if isinstance(x, torch.Tensor):
                torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    else:
        _trees_equal(engine.state, loop.state)
        for k, v in engine.trajectory.items():
            np.testing.assert_array_equal(v, loop.trajectory[k])
    assert isinstance(loop.state.dpps.mail, Mailbox)


def test_delay_model_validation():
    with pytest.raises(ValueError, match="max_delay"):
        DelayModel(max_delay=-1)
    with pytest.raises(ValueError, match="max_delay"):
        DelayModel(max_delay=1.5)
    with pytest.raises(ValueError, match="timeout_rate"):
        DelayModel(timeout_rate=1.0)
    with pytest.raises(ValueError, match="rates"):
        DelayModel(rates=(1, 0, 2))
    with pytest.raises(ValueError, match="rates"):
        DelayModel(rates=(1, 2.0))
    with pytest.raises(ValueError, match="one rate per node"):
        DelayModel(rates=(1, 2)).validate_nodes(8)
    assert not DelayModel().active and not DelayModel(rates=(1, 1, 1)).active
    assert DelayModel(max_delay=1).active


def test_plan_and_session_validation():
    with pytest.raises(ValueError, match="sync_interval"):
        _plan(DM, sync_interval=3)
    with pytest.raises(ValueError, match="circulant"):
        _plan(DM, schedule="circulant")
    with pytest.raises(ValueError, match="one rate per node"):
        _plan(DelayModel(rates=(1, 2)))
    plan = _plan(DM)
    assert plan.schedule == "dense" and plan.delays is DM
    with pytest.raises(ValueError, match="sync_interval"):  # the config's
        _run(_plan(DM, sync_interval=None), _cfg(sync_interval=3))
    with pytest.raises(ValueError, match="delays"):
        Session.build(TOPO, privacy=PrivacySpec(b=5.0, gamma_n=0.02),
                      plan=_plan(), device="cpu", delays=DM)
    cfg = _cfg()
    state = dpps_init(tree_from_numpy(_values(np.random.default_rng(0)),
                                      device="cpu"), cfg)
    state = DPPSState(push=state.push, sens=state.sens, t=state.t,
                      mail=DM.init_mailbox(state.push.s))
    with pytest.raises(ValueError, match="Mailbox"):
        _run(_plan(), cfg, state=state)


def test_network_stats_hook_publishes_staleness():
    bus = MetricsBus()
    session = Session.build(TOPO, privacy=PrivacySpec(b=5.0, gamma_n=0.02),
                            sync_interval=0, chunk=4, delays=DM,
                            device="cpu")
    assert isinstance(session.consensus_state(
        _values(np.random.default_rng(0))).mail, Mailbox)
    report = session.run(ROUNDS, values=_values(np.random.default_rng(0)),
                         hooks=[NetworkStatsHook(bus=bus)])
    snap = bus.snapshot()
    hist = snap["histograms"]["net.staleness"]
    assert hist["count"] > 0 and 0.0 <= hist["max"] <= DM.max_delay
    assert "net.timeouts" in snap["counters"]
    assert 0.0 < snap["gauges"]["net.participation"] <= 1.0
    assert report.network is not None
