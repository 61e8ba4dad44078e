"""Network faults of the port (``repro_torch.net.faults``, the "dynamic"
schedule, ``NetworkStatsHook``) against the reference's, on the CPU; the
launcher's flags; ``start=``.

* ``FaultModel.realize`` / ``realize_sparse`` fed the reference's masks
  (``reference_fault_draws``): the realized weights to rtol 1e-6 (one
  column sum or segment sum, in another order), the out-degrees, dropped
  edges and ``net_adj`` exactly; column-stochastic at drop 0.1 / 0.3 / 0.7
  with stragglers; churn isolates a node for its window; every validation
  error.
* An inactive ``FaultModel()`` leaves a run bit for bit the fault-free one
  (packed and pytree); under 30 % drops mean(a) = 1 to 1e-5 and consensus
  still comes; the port's own fault stream is independent of the noise
  bits and differs across ``FaultModel.seed``.
* ``Session.run`` (dense and sparse, packed and pytree) and ``train``
  (engine and loop) under faults against the reference's, fed its masks
  and its noise bits: states and trajectories to rtol 1e-5 (consensus) and
  1e-4 (training), the ``net_*`` rows exactly; the ledger's accounting and
  realized degrees equal, ``NetworkStatsHook``'s summary equal; the port's
  loop against its engine.
* The launcher takes every reference flag, item 8's ``--wire`` and
  ``--wire-dtype`` among them (the ledger records the codec); ``--churn`` parse
  errors as the reference's; ``--use-kernels`` raises off the card.
* ``start=``: ``None`` or the state's counter; anything else raises.
"""
from __future__ import annotations

import argparse
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hooks import _ref_mlp_loss
from test_torch_reference import (load_reference, reference_bits,
                                  reference_delay_draws,
                                  reference_fault_draws, reference_tree_bits,
                                  to_numpy)

from repro_torch.api import LedgerHook, PrivacySpec, Session
from repro_torch.convert import tree_from_numpy
from repro_torch.core import topology as T
from repro_torch.core.dpps import DPPSConfig, dpps_init
from repro_torch.core.tree_utils import tree_leaves
from repro_torch.engine import ProtocolPlan, run_dpps
from repro_torch.kernels import ref as kref
from repro_torch.launch import train as train_cli
from repro_torch.models.mlp import PARTITIONS, mlp_loss
from repro_torch.net import (DELAY_SALT, FAULT_SALT, DelayModel,
                             ErdosRenyiGraph, FaultModel, NetworkStatsHook,
                             RandomSequenceTopology, SmallWorldGraph)
from repro_torch.net.faults import salted_bits
from repro_torch.obs import MetricsBus

# comparisons with the reference at N <= 8, d_s <= 64, <= 6 rounds
N, SEED, ROUNDS, SYNC = 8, 2024, 6, 3
D_IN, HIDDEN, N_CLASSES, BATCH = 6, 4, 3, 8   # partpsp-2 shares d_s = 48
GAMMA_N = 1e-4  # inside the Remark-1 stability region at d_s = 48
FM = dict(drop_rate=0.3, straggler_rate=0.1, churn=((2, 1, 4),), seed=3)


@pytest.fixture(scope="module")
def R():
    ref = load_reference()
    import importlib
    for name in ("repro.net", "repro.api.hooks"):
        importlib.import_module(name)
    return ref


def _close(got, want, rtol, atol=0.0):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(to_numpy(got), want, rtol=rtol,
                               atol=atol + 1e-6 * scale)


def _trees_close(got, want, rtol, atol=0.0):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        if isinstance(x, int):
            assert x == int(y)
        else:
            _close(x, y, rtol, atol)


def _trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


def _shape(plan) -> tuple[int, int]:
    n = plan.ws.shape[1] if plan.ws is not None else plan.sparse_idx.shape[1]
    return (n, n) if plan.sparse_idx is None else tuple(
        plan.sparse_idx.shape[1:])


def _draws_at(model, plan, kind):
    """``fault_draws_at`` / ``delay_draws_at`` giving the reference's draws
    of each round (``kind``: the helper of test_torch_reference)."""
    if model is None:
        return None
    return lambda t: kind(model, SEED, t, _shape(plan))


def _values(rng, n=N):
    return [rng.normal(size=(n, 11)).astype(np.float32),
            rng.normal(size=(n, 2, 3)).astype(np.float32)]


# -- FaultModel against the reference's ------------------------------------

GRAPHS = [ErdosRenyiGraph(n_nodes=N, p=0.4, seed=3),
          SmallWorldGraph(n_nodes=N, k=2, beta=0.4, seed=5)]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("rate", [0.1, 0.3, 0.7])
def test_realized_weights_match_reference_and_stay_column_stochastic(
        R, rate, sparse):
    """Fed the reference's masks: the realized weights to rtol 1e-6, the
    out-degrees, dropped edges and adjacency exactly; every column sums to
    1 (atol 1e-6) with its self loop kept."""
    kw = dict(drop_rate=rate, straggler_rate=0.1, churn=((4, 1, 3),))
    assert all(topo.n_nodes == N for topo in GRAPHS)
    fm, rfm = FaultModel(**kw), R.net.FaultModel(**kw)
    for topo in GRAPHS:
        w = topo.weight_matrix(0).astype(np.float32)
        idx, vals = T.padded_csr(w, int((w > 0).sum(axis=1).max()))
        for t in range(4):
            key = rfm.fault_key(jax.random.fold_in(
                jax.random.PRNGKey(SEED), t))
            if sparse:
                draws = reference_fault_draws(fm, SEED, t, idx.shape)
                got, g = fm.realize_sparse(
                    torch.from_numpy(idx), torch.from_numpy(vals), t,
                    draws=draws, with_adjacency=True)
                want, d = rfm.realize_sparse(
                    jnp.asarray(idx), jnp.asarray(vals), key, t,
                    with_adjacency=True)
                dense = np.zeros_like(w)
                np.add.at(dense, (np.arange(N)[:, None].repeat(
                    idx.shape[1], 1), idx), to_numpy(got))
            else:
                draws = reference_fault_draws(fm, SEED, t, w.shape)
                got, g = fm.realize(torch.from_numpy(w), t, draws=draws,
                                    with_adjacency=True)
                want, d = rfm.realize(jnp.asarray(w), key, t,
                                      with_adjacency=True)
                dense = to_numpy(got)
            _close(got, want, 1e-6)
            for k in ("net_out_degree", "net_dropped_edges", "net_adj"):
                np.testing.assert_array_equal(to_numpy(g[k]),
                                              np.asarray(d[k]))
            np.testing.assert_allclose(dense.sum(axis=0), 1.0, atol=1e-6)
            assert (np.diag(dense) > 0).all()


def test_churn_isolates_node_for_interval(R):
    fm = FaultModel(churn=((2, 3, 6),))
    w = torch.from_numpy(T.DOutGraph(6, 3).weight_matrix(0).astype(
        np.float32))
    for t, down in [(2, False), (3, True), (5, True), (6, False)]:
        w_real, diag = fm.realize(w, t)
        w_real = to_numpy(w_real)
        want, _ = R.net.FaultModel(churn=((2, 3, 6),)).realize(
            jnp.asarray(w), jax.random.PRNGKey(0), t)
        _close(w_real, want, 1e-6)
        if down:
            assert int(diag["net_out_degree"][2]) == 0
            assert w_real[2, 2] == 1.0 and w_real[:, 2].sum() == 1.0
            assert (w_real[2, [j for j in range(6) if j != 2]] == 0).all()
        else:
            assert int(diag["net_out_degree"][2]) > 0


@pytest.mark.parametrize("kw,match", [
    (dict(drop_rate=1.5), "drop_rate"),
    (dict(straggler_rate=1.0), "straggler_rate"),
    (dict(churn=((0, 5, 5),)), "churn interval"),
    (dict(churn=((1, 0),)), "churn entries"),
    (dict(churn=((1.0, 0, 4),)), "must be an int"),
    (dict(churn=((1, 0, "4"),)), "must be an int"),
    (dict(churn=((True, 0, 4),)), "must be an int"),
    (dict(churn=((-1, 0, 4),)), ">= 0"),
    (dict(churn=((1, 0, 5), (1, 3, 8))), "overlap")])
def test_fault_validation_as_the_reference(R, kw, match):
    with pytest.raises(ValueError, match=match):
        FaultModel(**kw)
    with pytest.raises(ValueError, match=match):
        R.net.FaultModel(**kw)


def test_fault_activity_and_churn_range():
    assert not FaultModel().active and FaultModel(drop_rate=0.1).active
    assert FaultModel(churn=((1, 0, 2),)).active
    FaultModel(churn=((1, 0, 5), (1, 5, 8)))   # back to back: fine
    FaultModel(churn=((1, 0, 5), (2, 3, 8)))   # other nodes may overlap
    fm = FaultModel(churn=((6, 0, 10),))
    w = torch.from_numpy(T.DOutGraph(6, 2).weight_matrix(0).astype(
        np.float32))
    with pytest.raises(ValueError, match=r"churn nodes \[6\].*N=6"):
        fm.realize(w, 0)


# -- the plan and the engine --------------------------------------------------

def test_plan_selects_dynamic_and_validates(R):
    topo = T.DOutGraph(N, 2)
    plan = ProtocolPlan.from_topology(topo, device="cpu",
                                      faults=FaultModel(drop_rate=0.1))
    assert plan.schedule == "dynamic" and plan.dynamic
    assert plan.resolve_dpps(DPPSConfig()).schedule == "dense"
    sparse = ProtocolPlan.from_topology(topo, device="cpu", schedule="sparse",
                                        faults=FaultModel(drop_rate=0.1))
    assert sparse.schedule == "sparse" and sparse.dynamic
    plain = ProtocolPlan.from_topology(topo, device="cpu", schedule="dense",
                                       faults=FaultModel())
    assert plain.schedule == "dense" and plain.faults is None
    assert not plain.dynamic
    with pytest.raises(ValueError, match="circulant"):
        ProtocolPlan.from_topology(topo, device="cpu", schedule="circulant",
                                   faults=FaultModel(drop_rate=0.1))
    with pytest.raises(ValueError, match="dynamic"):
        ProtocolPlan.from_topology(topo, device="cpu", schedule="dynamic")
    with pytest.raises(ValueError, match="dynamic"):
        ProtocolPlan(schedule="dynamic", period=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="faults"):
        Session.build(topo, plan=plan, device="cpu",
                      faults=FaultModel(drop_rate=0.1))
    with pytest.raises(ValueError, match="faults"):
        R.api.Session.build(R.core.topology.DOutGraph(N, 2),
                            plan=R.engine.plan.ProtocolPlan.from_topology(
                                R.core.topology.DOutGraph(N, 2)),
                            faults=R.net.FaultModel(drop_rate=0.1))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "pytree"])
def test_inactive_fault_model_bit_identical(packed):
    """``FaultModel(drop_rate=0.0)`` is dropped at plan build: state and
    every trajectory row bit for bit the fault-free run's."""
    vals = _values(np.random.default_rng(0))
    reps = []
    for fm in (None, FaultModel(drop_rate=0.0)):
        session = Session.build(T.DOutGraph(N, 2), privacy=PrivacySpec(
            b=5.0, gamma_n=0.02), schedule="dense", sync_interval=SYNC,
            packed=packed, seed=SEED, device="cpu", faults=fm)
        assert session.plan.schedule == "dense"
        reps.append(session.run(ROUNDS, values=tree_from_numpy(
            vals, device="cpu")))
    _trees_equal(reps[0].state, reps[1].state)
    assert set(reps[0].trajectory) == set(reps[1].trajectory)
    for k, v in reps[0].trajectory.items():
        np.testing.assert_array_equal(v, reps[1].trajectory[k])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "pytree"])
def test_faulty_consensus_conserves_mass_and_converges(packed):
    """Noiseless push-sum under 30 % drops: mean(a) = 1 to 1e-5 and the
    consensus error falls a hundredfold; no ``net_adj`` rows without a
    hook that asks for them."""
    topo = ErdosRenyiGraph(n_nodes=16, p=0.35, seed=2024)
    plan = ProtocolPlan.from_topology(topo, device="cpu", packed=packed,
                                      faults=FaultModel(drop_rate=0.3))
    cfg = DPPSConfig(noise=False, gamma_n=0.0, c_prime=0.8, lam=0.6)
    values = [torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, 64)).astype(np.float32))]
    err0 = float(torch.max((values[0] - values[0].mean(0)).abs().sum(1)))
    st, traj = run_dpps(dpps_init(values, plan.resolve_dpps(cfg)), None,
                        cfg=cfg, plan=plan, rounds=60, seed=5)
    a = st.push.a
    assert abs(float(a.mean()) - 1.0) < 1e-5 and bool((a > 0).all())
    y = st.push.s[0] / a[:, None]
    assert float(torch.max((y - y.mean(0)).abs().sum(1))) < err0 * 1e-2
    assert tuple(traj["net_out_degree"].shape) == (60, 16)
    assert int(traj["net_dropped_edges"].sum()) > 0
    assert "net_adj" not in traj


def test_fault_and_delay_streams_are_independent_of_the_noise():
    """The salted streams share no word with round t's noise bits, differ
    across the model's seed and between faults and delays, and turning
    faults on leaves round 0's noise (its L1 norm) bit for bit."""
    noise = kref.philox_bits(SEED, 3, 4, 0, 64).reshape(-1)
    streams = [salted_bits(SEED, salt, seed, 3, sub, 256)
               for salt in (FAULT_SALT, DELAY_SALT) for seed in (0, 1)
               for sub in (0, 1)]
    words = [set(noise.tolist())] + [set(s.tolist()) for s in streams]
    for i, a in enumerate(words):
        for b in words[i + 1:]:
            assert not a & b
    fm0, fm1 = FaultModel(drop_rate=0.5), FaultModel(drop_rate=0.5, seed=1)
    assert not torch.equal(fm0.draw(SEED, 3, (8, 8)).drop,
                           fm1.draw(SEED, 3, (8, 8)).drop)
    assert torch.equal(fm0.draw(SEED, 3, (8, 8)).drop,
                       fm0.draw(SEED, 3, (8, 8)).drop)
    keep = torch.stack([fm0.draw(SEED, t, (16, 16)).drop for t in range(8)])
    assert 0.4 < float(keep.float().mean()) < 0.6
    vals = tree_from_numpy(_values(np.random.default_rng(1)), device="cpu")
    rows = []
    for fm in (None, FaultModel(drop_rate=0.5)):
        session = Session.build(T.DOutGraph(N, 2), privacy=PrivacySpec(
            b=5.0, gamma_n=0.02), schedule="dense", seed=SEED, device="cpu",
            faults=fm)
        rows.append(session.run(2, values=vals).trajectory)
    assert rows[0]["noise_l1_mean"][0] == rows[1]["noise_l1_mean"][0]
    assert rows[0]["a_min"][1] != rows[1]["a_min"][1]


# -- sessions against the reference -----------------------------------------

@pytest.mark.parametrize("schedule,packed,noise", [
    ("dense", True, True), ("dense", False, False), ("sparse", True, False)])
def test_session_run_matches_reference_under_faults(R, schedule, packed,
                                                    noise):
    """Noise on (the reference's kernel path, its bits fed in) or off:
    states and trajectories to rtol 1e-5 plus 1e-6 of each array's largest
    magnitude, the ``net_*`` rows exactly."""
    vals = _values(np.random.default_rng(2))
    jvals = [jnp.asarray(v) for v in vals]
    deploy = dict(schedule=schedule, sync_interval=SYNC, chunk=4, seed=SEED,
                  packed=packed)
    privacy = dict(b=5.0, gamma_n=0.02, noise=noise)
    ref = R.api.Session.build(
        R.core.topology.DOutGraph(N, 2), privacy=R.api.PrivacySpec(**privacy),
        use_kernels=noise, faults=R.net.FaultModel(**FM), **deploy)
    ref_rep = ref.run(ROUNDS, values=jvals)
    fm = FaultModel(**FM)
    session = Session.build(T.DOutGraph(N, 2), privacy=PrivacySpec(**privacy),
                            device="cpu", faults=fm, **deploy)
    base = jax.random.PRNGKey(SEED)
    if not noise:
        bits_at = None
    elif packed:
        bits_at = lambda t: torch.from_numpy(reference_bits(SEED, t, N, 17))
    else:
        bits_at = lambda t: [torch.from_numpy(b) for b in reference_tree_bits(
            jax.random.fold_in(base, t), jvals)]
    rep = session.run(ROUNDS, values=tree_from_numpy(vals, device="cpu"),
                      bits_at=bits_at, fault_draws_at=_draws_at(
                          fm, session.plan, reference_fault_draws))
    assert set(rep.trajectory) == set(ref_rep.trajectory)
    for k, v in ref_rep.trajectory.items():
        if k.startswith("net_"):
            np.testing.assert_array_equal(rep.trajectory[k], np.asarray(v))
        else:
            _close(rep.trajectory[k], v, 1e-5)
    _trees_close(rep.state.push, ref_rep.state.push, 1e-5)
    assert int(rep.trajectory["net_dropped_edges"].sum()) > 0


def mlp_sessions(R, *, faults=None, delays=None, schedule="dense",
                 sync_interval=SYNC, packed=True, noise=True, chunk=4,
                 n=N, rounds=ROUNDS):
    """The reference's and the port's sessions of the paper MLP (partpsp-2)
    on 2-out(n), with the same fault and delay models (kwargs dicts), and
    ``rounds`` node-stacked batches."""
    key = jax.random.PRNGKey(SEED)
    k1, k2, k3 = jax.random.split(key, 3)
    s = lambda k, shape: np.asarray(jax.random.normal(k, shape)
                                    / jnp.sqrt(shape[0]))
    params = {"l1": s(k1, (D_IN, HIDDEN)), "l2": s(k2, (HIDDEN, D_IN)),
              "l3": s(k3, (D_IN, N_CLASSES))}
    task = R.data.SyntheticClassification(d_in=D_IN, n_classes=N_CLASSES,
                                          seed=SEED)
    skew = R.data.dirichlet_partition(n, N_CLASSES, seed=SEED)
    batches = [jax.tree_util.tree_map(np.asarray, task.node_batches(
        jax.random.fold_in(jax.random.PRNGKey(SEED + 1), t), n, BATCH,
        skew)) for t in range(rounds)]
    privacy = dict(b=1.0, gamma_n=GAMMA_N, noise=noise)
    deploy = dict(algorithm="partpsp", gamma_l=0.1, gamma_s=0.1, clip=100.0,
                  schedule=schedule, sync_interval=sync_interval, chunk=chunk,
                  seed=SEED, partition=PARTITIONS["partpsp-2"], packed=packed)
    ref_session = R.api.Session.build(
        R.core.topology.DOutGraph(n, 2),
        privacy=R.api.PrivacySpec(**privacy), model=_ref_mlp_loss,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        use_kernels=noise,
        faults=R.net.FaultModel(**faults) if faults else None,
        delays=R.net.DelayModel(**delays) if delays else None, **deploy)
    session = Session.build(
        T.DOutGraph(n, 2), privacy=PrivacySpec(**privacy), model=mlp_loss,
        params=tree_from_numpy(params, device="cpu"), device="cpu",
        faults=FaultModel(**faults) if faults else None,
        delays=DelayModel(**delays) if delays else None, **deploy)
    return ref_session, session, batches


def train_both(R, session_kw, *, driver="engine", hooks=(), ref_hooks=(),
               rounds=ROUNDS):
    """Train both packages ``rounds`` rounds on the same batches, the port
    fed the reference's noise bits, fault masks and delays."""
    ref_session, session, batches = mlp_sessions(R, rounds=rounds,
                                                 **session_kw)
    ref_rep = ref_session.train(rounds, lambda t: jax.tree_util.tree_map(
        jnp.asarray, batches[t]), hooks=ref_hooks, driver=driver)
    n = session.n_nodes
    base = jax.random.PRNGKey(SEED)
    template = ref_session.train_state().dpps.push.s
    if not session_kw.get("noise", True):
        bits_at = None
    elif driver == "loop" or not session_kw.get("packed", True):
        bits_at = lambda t: [torch.from_numpy(b) for b in reference_tree_bits(
            jax.random.split(jax.random.fold_in(base, t), 3)[2], template)]
    else:
        bits_at = lambda t: torch.from_numpy(reference_bits(
            SEED, t, n, session.partition.d_shared(), partpsp=True))
    plan = session.plan
    rep = session.train(
        rounds, lambda t: tree_from_numpy(batches[t], device="cpu"),
        bits_at=bits_at, hooks=hooks, driver=driver,
        fault_draws_at=_draws_at(plan.faults, plan, reference_fault_draws),
        delay_draws_at=_draws_at(plan.delays, plan, reference_delay_draws))
    return rep, ref_rep


def reports_close(rep, ref_rep, rtol=1e-4, atol=1e-5):
    """Training tolerance; integer and boolean rows exactly."""
    assert rep.rounds == ref_rep.rounds
    assert set(rep.trajectory) == set(ref_rep.trajectory)
    for k, v in ref_rep.trajectory.items():
        v = np.asarray(v)
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(rep.trajectory[k], v, err_msg=k)
        else:
            _close(rep.trajectory[k], v, rtol, atol)
    _trees_close(rep.state.dpps.push, ref_rep.state.dpps.push, rtol, atol)
    _trees_close(rep.state.local, ref_rep.state.local, rtol, atol)
    assert rep.epsilon_spent == ref_rep.epsilon_spent


ACCOUNTING = ("round", "mechanism", "algorithm", "wire_dtype", "wire_codec",
              "protected", "synced", "epsilon_round", "epsilon_total",
              "remaining", "exhausted", "out_degree_min", "out_degree_mean",
              "dropped_edges", "staleness_max", "timeouts", "participating")


def ledgers_equal(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ACCOUNTING:
            if k in w:
                assert g[k] == w[k], (k, g[k], w[k])


@pytest.mark.parametrize("schedule,driver,noise", [
    ("dense", "engine", False), ("sparse", "loop", True)])
def test_train_matches_reference_under_faults(R, schedule, driver, noise):
    """PartPSP under faults with a LedgerHook and a NetworkStatsHook: the
    reports within the training tolerance, the ``net_*`` rows, the ledger's
    accounting and realized degrees, and the network summary equal."""
    port_hooks = [LedgerHook(), NetworkStatsHook(bus=MetricsBus())]
    ref_hooks = [R.api.LedgerHook(), R.net.NetworkStatsHook(
        bus=R.obs.MetricsBus())]
    rep, ref_rep = train_both(R, dict(faults=FM, schedule=schedule,
                                      noise=noise),
                              driver=driver, hooks=port_hooks,
                              ref_hooks=ref_hooks)
    reports_close(rep, ref_rep)
    ledgers_equal(port_hooks[0].ledger.entries, ref_hooks[0].ledger.entries)
    assert any(e["dropped_edges"] > 0 for e in port_hooks[0].ledger.entries)
    got, want = rep.network.summary(), ref_rep.network.summary()
    assert got == want
    assert rep.network.effective_bytes < rep.network.nominal_bytes


def test_loop_matches_engine_under_faults():
    """The port's loop (pytree, one round a segment) against its engine
    over the pytree runtime: the same Philox masks, bit for bit."""
    session = Session.build(
        T.DOutGraph(N, 2), privacy=PrivacySpec(b=1.0, gamma_n=GAMMA_N),
        model=mlp_loss, params=tree_from_numpy(
            {"l1": np.full((D_IN, HIDDEN), 0.1, np.float32),
             "l2": np.full((HIDDEN, D_IN), 0.1, np.float32),
             "l3": np.full((D_IN, N_CLASSES), 0.1, np.float32)},
            device="cpu"), partition=PARTITIONS["partpsp-2"], device="cpu",
        packed=False, chunk=4, sync_interval=SYNC, seed=SEED,
        faults=FaultModel(drop_rate=0.25, straggler_rate=0.1))
    gen = torch.Generator().manual_seed(0)
    batches = [(torch.randn((N, 8, D_IN), generator=gen),
                torch.randint(0, N_CLASSES, (N, 8), generator=gen))
               for _ in range(ROUNDS)]
    engine = session.train(ROUNDS, lambda t: batches[t])
    loop = session.train(ROUNDS, lambda t: batches[t], driver="loop")
    _trees_equal(engine.state, loop.state)
    for k, v in engine.trajectory.items():
        np.testing.assert_array_equal(v, loop.trajectory[k])


def test_network_stats_hook_rebuilds_the_nominal_graph(R):
    """Without faults the hook rebuilds each round's nominal graph from the
    plan (circulant and sparse), as the reference's does, and publishes
    its counters."""
    vals = _values(np.random.default_rng(3))
    for schedule in ("circulant", "sparse"):
        bus = MetricsBus()
        session = Session.build(T.DOutGraph(N, 2), privacy=PrivacySpec(
            b=5.0, gamma_n=0.02), schedule=schedule, device="cpu", chunk=4)
        rep = session.run(ROUNDS, values=tree_from_numpy(vals, device="cpu"),
                          hooks=[NetworkStatsHook(bus=bus)])
        ref = R.api.Session.build(
            R.core.topology.DOutGraph(N, 2),
            privacy=R.api.PrivacySpec(b=5.0, gamma_n=0.02),
            schedule=schedule, chunk=4)
        ref_rep = ref.run(ROUNDS, values=[jnp.asarray(v) for v in vals],
                          hooks=[R.net.NetworkStatsHook(
                              bus=R.obs.MetricsBus())])
        assert rep.network.summary() == ref_rep.network.summary()
        snap = bus.snapshot()
        assert snap["counters"]["net.realized_edges"] == N * ROUNDS
        assert snap["counters"]["net.dropped_edges"] == 0


# -- the launcher and start= --------------------------------------------------

ARGS = ["--reduced", "--device", "cpu", "--nodes", "4", "--steps", "3",
        "--gamma-n", "1e-6", "--log-every", "1"]


class _Built(Exception):
    pass


def _build_kwargs(monkeypatch, argv) -> dict:
    """The keyword arguments ``main`` hands to ``build_session``."""
    seen = {}

    def build(arch, **kw):
        seen.update(kw, arch=arch)
        raise _Built

    monkeypatch.setattr(train_cli, "build_session", build)
    with pytest.raises(_Built):
        train_cli.main(ARGS + argv)
    return seen


def test_train_cli_takes_the_reference_flags(monkeypatch):
    kw = _build_kwargs(monkeypatch, [
        "--chunk", "2", "--no-packed", "--topology", "er",
        "--resample-period", "3", "--graph-seed", "9", "--drop-rate", "0.2",
        "--straggler-rate", "0.1", "--churn", "1:0:2", "--churn", "3:1:4",
        "--fault-seed", "5", "--max-delay", "2", "--timeout-rate", "0.1",
        "--node-rates", "1,2,1,3", "--delay-seed", "7", "--sync-interval",
        "0", "--schedule", "sparse"])
    assert kw["chunk"] == 2 and kw["packed"] is False
    assert kw["use_kernels"] is None
    topo = kw["topology"]
    assert isinstance(topo, RandomSequenceTopology) and topo.period == 3
    assert isinstance(topo.base, ErdosRenyiGraph) and topo.base.seed == 9
    assert kw["faults"] == FaultModel(drop_rate=0.2, straggler_rate=0.1,
                                      churn=((1, 0, 2), (3, 1, 4)), seed=5)
    assert kw["delays"] == DelayModel(max_delay=2, timeout_rate=0.1,
                                      rates=(1, 2, 1, 3), seed=7)
    kw = _build_kwargs(monkeypatch, ["--packed", "--use-kernels"])
    assert kw["packed"] is True and kw["use_kernels"] is True
    assert kw["faults"] is None and kw["delays"] is None
    assert kw["chunk"] == 50


def test_train_cli_runs_under_faults_and_delays(capsys, tmp_path):
    ledger = str(tmp_path / "l.jsonl")
    train_cli.main(ARGS + ["--drop-rate", "0.3", "--churn", "1:0:2",
                           "--max-delay", "1", "--node-rates", "1,2,1,1",
                           "--sync-interval", "0", "--chunk", "2",
                           "--seq-len", "16", "--per-node-batch", "1",
                           "--ledger-out", ledger])
    out = capsys.readouterr().out
    assert "schedule=dynamic" in out and "privacy:" in out
    from repro_torch.audit import PrivacyLedger
    entries = PrivacyLedger.read_jsonl(ledger)
    assert [e["round"] for e in entries] == [0, 1, 2]
    assert entries[0]["out_degree_min"] == 0       # node 1 down in round 0
    assert [e["participating"] for e in entries] == [4, 3, 4]


def test_train_cli_use_kernels_raises_off_the_card():
    with pytest.raises(ValueError, match="use_kernels=True needs a CUDA"):
        train_cli.main(ARGS + ["--use-kernels"])


@pytest.mark.parametrize("flag", [["--wire", "int8"], ["--wire", "f32"],
                                  ["--wire-dtype", "bf16"]])
def test_train_cli_wire_flags_name_item_8(flag, capsys):
    """The wire flags of ROADMAP item 8 (ported since they raised naming
    it) select the codec the run's ledger records."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        train_cli.main(ARGS + flag)
    out = capsys.readouterr().out
    want = {"int8": "int8", "f32": "f32", "bf16": "bf16"}[flag[1]]
    assert f"wire={want} " in out
    assert f'"wire_codec": "{want}"' in out


def _cli_error(argv) -> str:
    err = io.StringIO()
    with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
        train_cli.main(ARGS + argv)
    return err.getvalue()


@pytest.mark.parametrize("argv,match", [
    (["--churn", "9:0:4"], "out of range"),
    (["--churn", "1:4"], "NODE:T_DOWN:T_UP"),
    (["--churn", "a:0:4"], "NODE:T_DOWN:T_UP"),
    (["--churn", "1:0:5", "--churn", "1:3:8"], "overlap"),
    (["--drop-rate", "1.5"], "drop_rate"),
    (["--node-rates", "1,2"], "one rate per node"),
    (["--node-rates", "1,x,1,1"], "comma-separated ints"),
    (["--timeout-rate", "1.5"], "timeout_rate"),
    (["--max-delay", "1"], "--sync-interval 0"),
    (["--max-delay", "1", "--sync-interval", "0", "--schedule", "circulant"],
     "dense or sparse"),
    (["--drop-rate", "0.1", "--schedule", "circulant"], "dense or sparse"),
    (["--chunk", "0"], "--chunk"),
    (["--topology", "torus", "--resample-period", "2"], "seed")])
def test_train_cli_errors_as_the_reference(R, argv, match):
    assert match in _cli_error(argv)


def test_churn_parse_errors_match_the_reference_cli(R):
    """The reference's ``faults_from_args`` fails on the same specs."""
    ap = argparse.ArgumentParser()
    R.api.add_fault_arguments(ap)
    for spec, match in (("9:0:4", "churn"), ("1:4", "NODE:T_DOWN:T_UP"),
                        ("a:0:4", "NODE:T_DOWN:T_UP")):
        err = io.StringIO()
        with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
            R.api.faults_from_args(ap, ap.parse_args(["--churn", spec]),
                                   n_nodes=4)
        assert match in err.getvalue()
        assert match in _cli_error(["--churn", spec])


def test_start_must_be_the_state_counter():
    session = Session.build(T.DOutGraph(4, 2), privacy=PrivacySpec(
        b=5.0, gamma_n=0.02), device="cpu")
    vals = [torch.zeros((4, 3))]
    rep = session.run(2, values=vals, start=0)
    again = session.run(1, state=rep.state, start=2)
    assert again.state.t == 3
    with pytest.raises(ValueError, match="start=0 .* t=2"):
        session.run(1, state=rep.state, start=0)
    with pytest.raises(ValueError, match="start=5 .* t=0"):
        session.run(1, values=vals, start=5)
