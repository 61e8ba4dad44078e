"""The pytree (unpacked) runtime of the port against the reference's.

* ``kernels.ref.philox_bits`` at any first column: a leaf's bits are the
  packed row's columns, ``col0 % 4 != 0`` included; the tree perturbation
  (``ops.dpps_perturb_tree``, its plain route here) draws exactly the
  packed launch's bits at each leaf's ``col0``.
* ``ops.l1_norm_tree``, ``ops.dpps_perturb_tree`` and
  ``ops.laplace_noise_like`` against ``repro.kernels.ops`` (interpret-mode
  Pallas), fed the bits the reference drew.
* ``dpps_step(layout=None)`` and ``partpsp_step(layout=None)`` against the
  reference's pytree runtime on the dense, circulant and sparse schedules,
  noise off (the reference's plain path) and on (its kernel path, the port
  fed the reference's per-leaf bits), across a sync round; the port's plain
  and kernel routes both. ``return_s_half`` and the ``wd_*`` stats against
  the reference's ``return_wire_stats=True``.
* ``Session.build(packed=False).run`` against the reference's
  ``packed=False`` engine; the port's ``train(driver="loop")`` against the
  reference's, and against the port's own engine.
* ``privacy.l2_clip_per_node``, ``sensitivity.reset_sensitivity`` and
  ``real_sensitivity(chunk=)``.

Tolerances: bits and integer outputs exactly; the tree perturbation
against the packed launch bit for bit (the same elementwise arithmetic);
consensus states and diagnostics to rtol 1e-5 / atol 1e-6, plus 1e-6 of
the array's largest magnitude (f32 sums in another order; an element
near zero carries the rounding of terms hundreds of times larger);
training to rtol 1e-4 / atol 1e-5 (gradients pass last-ulp differences of
the forward on, and the rounds compound them); the loop against the engine
inside the port to rtol 1e-6 / atol 1e-7 (the same arithmetic, the mix
once over the buffer against once a leaf).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import (load_reference, reference_bits,
                                  reference_tree_bits, to_numpy)

from repro_torch.api import PrivacySpec, RoundHook, Session
from repro_torch.convert import tree_from_numpy
from repro_torch.core import topology as T
from repro_torch.core.dpps import DPPSConfig, dpps_init, dpps_step
from repro_torch.core.packing import PackedLayout
from repro_torch.core.partition import Partition
from repro_torch.core.partpsp import (PartPSPConfig, partpsp_init,
                                      partpsp_step)
from repro_torch.core.privacy import l1_clip_per_node, l2_clip_per_node
from repro_torch.core.sensitivity import (init_sensitivity,
                                          real_sensitivity,
                                          reset_sensitivity)
from repro_torch.core.tree_utils import tree_leaves
from repro_torch.engine import ProtocolPlan
from repro_torch.kernels import ops, ref
from repro_torch.models.mlp import PARTITIONS, mlp_loss

N, SEED, ROUNDS, SYNC = 5, 2024, 6, 5
D_IN, HIDDEN, N_CLASSES, BATCH = 32, 10, 10, 32
# Noise rates below the Remark-1 stability limit (1/lam - 1) b / (2 C' d_s)
# (about 6e-3 for the consensus tree, d_s = 127, and 5e-4 for the MLP's two
# shared layers, d_s = 640): above it the noise grows every round and the
# runs amplify last-ulp differences until they part.
GAMMA_N = 1e-4


@pytest.fixture(scope="module")
def R():
    return load_reference()


def _close(got, want, rtol, atol):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(to_numpy(got), want, rtol=rtol,
                               atol=atol + 1e-6 * scale)


def _trees_close(got, want, rtol, atol):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        assert tuple(x.shape) == tuple(y.shape)
        _close(x, y, rtol, atol)


def _values(rng):
    """A tree whose second leaf starts at wire column 7 (col0 % 4 == 3):
    dict keys sort "b" (7 columns) before "w" (40 x 3)."""
    return {"w": rng.normal(size=(N, 40, 3)).astype(np.float32),
            "b": rng.normal(size=(N, 7)).astype(np.float32)}


# -- bits and the tree kernels' plain routes -----------------------------------

@pytest.mark.parametrize("col0,size", [(0, 9), (1, 8), (2, 5), (3, 13),
                                       (7840, 10), (7850, 7), (7851, 301)])
def test_philox_bits_at_col0_are_the_packed_rows_columns(col0, size):
    whole = ref.philox_bits(SEED, 3, 4, 0, col0 + size)
    leaf = ref.philox_bits(SEED, 3, 4, col0, col0 + size)
    assert leaf.shape == (4, size)
    torch.testing.assert_close(leaf, whole[:, col0:], rtol=0, atol=0)


@pytest.mark.parametrize("shapes", [
    [(7,), (40, 3)],                     # col0 7: a straddling quad
    [(784, 10), (10,), (10, 10), (10,)],  # the paper MLP's leaves
    [(3,), (1,), (2, 2), (5,), (129,)]])
def test_tree_perturbation_draws_the_packed_launchs_bits(shapes):
    """Leaf by leaf at each leaf's col0 against one launch over the packed
    row: s_noise bit for bit, the norms to f32 rounding (rtol 1e-6: per-leaf
    sums added against one row sum)."""
    gen = torch.Generator().manual_seed(0)
    s = [torch.randn((N,) + sh, generator=gen) for sh in shapes]
    eps = [torch.randn((N,) + sh, generator=gen) for sh in shapes]
    got, g_eps, g_noise = ops.dpps_perturb_tree(s, eps, 0.7, 0.3, seed=SEED,
                                               t=4)
    layout = PackedLayout.from_tree(s, lane=128)
    want, w_eps, w_noise = ref.dpps_perturb_rows(
        layout.pack(s), layout.pack(eps), 0.7, 0.3, layout.d_s, seed=SEED,
        t=4)
    torch.testing.assert_close(layout.pack(got), want, rtol=0, atol=0)
    torch.testing.assert_close(g_eps, w_eps, rtol=1e-6, atol=0)
    torch.testing.assert_close(g_noise, w_noise, rtol=1e-6, atol=0)
    cols = ref.leaf_columns(s)
    for x, c0 in zip(s, cols):
        noise = ops.laplace_noise_like(x, 0.7, seed=SEED, t=4, col0=c0)
        bits = ref.philox_bits(SEED, 4, N, c0, c0 + x[0].numel())
        torch.testing.assert_close(
            noise, ref.laplace_from_bits(bits, 0.7).reshape(x.shape),
            rtol=0, atol=0)


def test_tree_ops_match_reference(R):
    """l1_norm_tree to rtol 1e-5 (tile partials against one sum a leaf);
    dpps_perturb_tree's s_noise to rtol 1e-6 and its norms to 1e-5, fed the
    reference's per-leaf bits; laplace_noise_like to rtol 1e-6."""
    rng = np.random.default_rng(1)
    s, eps = _values(rng), _values(rng)
    key = jax.random.PRNGKey(9)
    js = jax.tree_util.tree_map(jnp.asarray, s)
    je = jax.tree_util.tree_map(jnp.asarray, eps)
    ts, te = tree_from_numpy(s, device="cpu"), tree_from_numpy(eps,
                                                               device="cpu")
    _close(ops.l1_norm_tree(tree_leaves(ts)),
           R.kernels.ops.l1_norm_tree(js), 1e-5, 0)
    want, _, want_noise = R.kernels.ops.dpps_perturb_tree(js, je, key, 0.5,
                                                         0.25)
    bits = [torch.from_numpy(b) for b in reference_tree_bits(key, js)]
    got, _, got_noise = ops.dpps_perturb_tree(tree_leaves(ts),
                                              tree_leaves(te), 0.5, 0.25,
                                              bits=bits)
    _trees_close(got, want, 1e-6, 1e-6)
    _close(got_noise, want_noise, 1e-5, 0)
    x = s["w"][0]
    want = R.kernels.ops.laplace_noise_like(key, jnp.asarray(x), 0.5)
    node_bits = np.array(jax.random.bits(key, (x.size,), jnp.uint32))
    got = ops.laplace_noise_like(torch.from_numpy(x)[None], 0.5,
                                 bits=torch.from_numpy(node_bits)[None])
    _close(got[0], want, 1e-6, 1e-6)


# -- dpps_step and partpsp_step over the pytree -------------------------------

def _mix(schedule: str, t: int):
    """Round t's mixing operands for the port and for the reference."""
    plan = ProtocolPlan.from_topology(T.DOutGraph(N, 2), schedule=schedule,
                                      device="cpu")
    mix = plan.mix_at(t)
    ref_mix = {k: v if k == "offsets" else jnp.asarray(v.numpy())
               for k, v in mix.items()}
    return mix, ref_mix


def _run_steps(R, schedule: str, noise: bool, kernels: bool, *,
               wire: bool = False):
    rng = np.random.default_rng(0)
    vals = _values(rng)
    eps = [_values(rng) for _ in range(ROUNDS)]
    for e in eps:
        e["w"] *= 0.05
        e["b"] *= 0.0
    common = dict(b=2.0, gamma_n=2e-3, noise=noise, c_prime=0.9, lam=0.6,
                  sync_interval=SYNC, schedule=schedule)
    ref_cfg = R.core.dpps.DPPSConfig(use_kernels=noise, **common)
    cfg = DPPSConfig(use_kernels=kernels, **common)
    rst = R.core.dpps.dpps_init(jax.tree_util.tree_map(jnp.asarray, vals),
                                ref_cfg)
    st = dpps_init(tree_from_numpy(vals, device="cpu"), cfg)
    base = jax.random.PRNGKey(SEED)
    diags, ref_diags = [], []
    for t in range(ROUNDS):
        mix, ref_mix = _mix(schedule, t)
        key = jax.random.fold_in(base, t)
        jeps = jax.tree_util.tree_map(jnp.asarray, eps[t])
        bits = ([torch.from_numpy(b)
                 for b in reference_tree_bits(key, rst.push.s)]
                if noise else None)
        rst, rd = R.core.dpps.dpps_step(
            rst, jeps, key, ref_cfg, return_s_half=wire,
            return_wire_stats=wire, **ref_mix)
        st, d = dpps_step(st, tree_from_numpy(eps[t], device="cpu"), cfg,
                          None, bits=bits, return_s_half=wire,
                          return_wire_stats=wire, **mix)
        diags.append(d)
        ref_diags.append(rd)
    return st, rst, diags, ref_diags


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("schedule", ["dense", "circulant", "sparse"])
def test_dpps_step_pytree_matches_reference(R, schedule, noise, kernels):
    """Six rounds with a sync round (t = 4) crossed."""
    st, rst, diags, ref_diags = _run_steps(R, schedule, noise, kernels)
    assert st.t == int(rst.t) == ROUNDS
    assert isinstance(st.push.s, dict)
    _trees_close(st.push.s, rst.push.s, 1e-5, 1e-6)
    _close(st.push.a, rst.push.a, 1e-5, 1e-6)
    _close(st.sens.s_local, rst.sens.s_local, 1e-5, 1e-6)
    _close(st.sens.prev_noise_l1, rst.sens.prev_noise_l1, 1e-5, 1e-6)
    for d, rd in zip(diags, ref_diags):
        assert set(d) == set(rd)
        for k in rd:
            _close(d[k], rd[k], 1e-5, 1e-6)


@pytest.mark.parametrize("noise", [False, True])
def test_s_half_and_wire_stats_match_reference(R, noise):
    st, rst, diags, ref_diags = _run_steps(R, "dense", noise, noise,
                                           wire=True)
    for d, rd in zip(diags, ref_diags):
        _trees_close(d["s_half"], rd["s_half"], 1e-5, 1e-6)
        assert int(d["wd_nonfinite"]) == int(rd["wd_nonfinite"]) == 0
        assert d["wd_nonfinite"].dtype == torch.int32
        _close(d["wd_mass_drift"], rd["wd_mass_drift"], 0, 1e-6)
        _close(d["wd_consensus_residual"], rd["wd_consensus_residual"],
               1e-5, 1e-6)


def test_packed_s_half_and_wire_stats_equal_the_pytree_runtimes():
    """The packed runtime's s_half (the buffer) and wd_* stats equal the
    pytree runtime's on the same inputs and bits (rtol 1e-6)."""
    gen = torch.Generator().manual_seed(2)
    s0 = [torch.randn((N, 7), generator=gen), torch.randn((N, 11, 3),
                                                          generator=gen)]
    eps = [0.1 * torch.randn(x.shape, generator=gen) for x in s0]
    w = T.DOutGraph(N, 2).weight_matrix_torch(0, device="cpu")
    cfg = DPPSConfig(b=1.0, gamma_n=0.05, c_prime=0.9, lam=0.6)
    layout = PackedLayout.from_tree(s0, lane=1)
    tree_st, tree_d = dpps_step(dpps_init(s0, cfg), eps, cfg, None, w=w,
                                seed=3, return_s_half=True,
                                return_wire_stats=True)
    pst = dpps_init(s0, cfg)
    pst = pst._replace(push=pst.push._replace(s=layout.pack(s0)))
    buf_st, buf_d = dpps_step(pst, eps, cfg, layout, w=w, seed=3,
                              return_s_half=True, return_wire_stats=True)
    torch.testing.assert_close(buf_d["s_half"], layout.pack(tree_d["s_half"]),
                               rtol=0, atol=0)
    for k in ("wd_nonfinite", "wd_mass_drift", "wd_consensus_residual"):
        torch.testing.assert_close(buf_d[k], tree_d[k], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(buf_st.push.s, layout.pack(tree_st.push.s),
                               rtol=1e-6, atol=1e-7)


def test_mechanism_and_tap_name_the_audit_item():
    """The audit lab's seams on the pytree runtime (ported since they
    raised naming ROADMAP item 9): ``LaplaceMechanism()`` is bit for bit
    the built-in draw, and the tap adds the round's ``tap_*`` rows (the
    flat wire row, the weights sent, the sensitivities)."""
    from repro_torch.audit import LaplaceMechanism, TranscriptTap

    cfg = DPPSConfig(gamma_n=0.1)
    vals = [torch.arange(6.0).reshape(2, 3), torch.ones((2, 1, 2))]
    eps = [torch.full((2, 3), 0.5), torch.zeros((2, 1, 2))]
    st = dpps_init(vals, cfg)
    base, d0 = dpps_step(st, eps, cfg, None, w=torch.eye(2), seed=4)
    new, d1 = dpps_step(st, eps, cfg, None, w=torch.eye(2), seed=4,
                        mechanism=LaplaceMechanism(), tap=TranscriptTap())
    for x, y in zip(base.push.s, new.push.s):
        assert torch.equal(x, y)
    assert torch.equal(d1["tap_messages"],
                       torch.cat([x.reshape(2, -1) for x in new.push.s], 1))
    assert torch.equal(d1["tap_weights"], st.push.a)
    assert torch.equal(d1["tap_sens_local"], d0["sensitivity_local"])
    assert torch.equal(d1["tap_sensitivity"], d0["sensitivity_used"])


def _mlp_setup(R):
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
    return params, batches


def _ref_mlp_loss(p, batch, key):
    x, y = batch
    h = jnp.tanh(x @ p["l1"])
    h = jnp.tanh(h @ p["l2"])
    logp = jax.nn.log_softmax(h @ p["l3"])
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


@pytest.mark.parametrize("noise", [False, True])
def test_partpsp_step_pytree_matches_reference(R, noise):
    params, batches = _mlp_setup(R)
    stacked = {k: np.broadcast_to(v[None], (N,) + v.shape).copy()
               for k, v in params.items()}
    rules = PARTITIONS["partpsp-2"]
    dcfg = dict(b=1.0, gamma_n=GAMMA_N, noise=noise, c_prime=0.9, lam=0.6,
                sync_interval=SYNC, schedule="dense")
    ref_cfg = R.core.partpsp.PartPSPConfig(
        0.1, 0.1, 100.0, R.core.dpps.DPPSConfig(use_kernels=noise, **dcfg))
    cfg = PartPSPConfig(0.1, 0.1, 100.0, DPPSConfig(**dcfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, stacked)
    rpart = R.core.partition.Partition.from_rules(jparams, rules,
                                                  default="local")
    tparams = tree_from_numpy(stacked, device="cpu")
    part = Partition.from_rules(tparams, rules, default="local")
    rst = R.core.partpsp.partpsp_init(jparams, rpart, ref_cfg)
    st = partpsp_init(tparams, part, cfg)
    base = jax.random.PRNGKey(SEED)
    for t in range(ROUNDS):
        mix, ref_mix = _mix("dense", t)
        key = jax.random.fold_in(base, t)
        bits = None
        if noise:
            key_noise = jax.random.split(key, 3)[2]
            bits = [torch.from_numpy(b) for b in
                    reference_tree_bits(key_noise, rst.dpps.push.s)]
        rst, rm = R.core.partpsp.partpsp_step(
            rst, jax.tree_util.tree_map(jnp.asarray, batches[t]), key,
            cfg=ref_cfg, partition=rpart, loss_fn=_ref_mlp_loss,
            return_s_half=True, **ref_mix)
        st, m = partpsp_step(st, tree_from_numpy(batches[t], device="cpu"),
                             cfg=cfg, partition=part, loss_fn=mlp_loss,
                             bits=bits, return_s_half=True, **mix)
        assert set(m) == set(rm)
        for k in rm:
            if k == "s_half":
                _trees_close(m[k], rm[k], 1e-4, 1e-5)
            else:
                _close(m[k], rm[k], 1e-4, 1e-5)
    assert st.dpps.t == int(rst.dpps.t)
    _trees_close(st.dpps.push.s, rst.dpps.push.s, 1e-4, 1e-5)
    _trees_close(st.local, rst.local, 1e-4, 1e-5)


# -- the engine's pytree runtime and the loop driver --------------------------

@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("schedule", ["dense", "circulant", "sparse"])
def test_session_run_unpacked_matches_reference(R, schedule, noise):
    rng = np.random.default_rng(3)
    vals = _values(rng)
    privacy = dict(b=2.0, gamma_n=2e-3, noise=noise)
    deploy = dict(schedule=schedule, sync_interval=SYNC, chunk=4, seed=SEED,
                  packed=False)
    ref_session = R.api.Session.build(
        R.core.topology.DOutGraph(N, 2), privacy=R.api.PrivacySpec(**privacy),
        use_kernels=noise, **deploy)
    jvals = jax.tree_util.tree_map(jnp.asarray, vals)
    ref_rep = ref_session.run(ROUNDS, values=jvals)
    session = Session.build(T.DOutGraph(N, 2), privacy=PrivacySpec(**privacy),
                            device="cpu", **deploy)
    assert session.plan.packed is False
    base = jax.random.PRNGKey(SEED)
    bits_at = ((lambda t: [torch.from_numpy(b) for b in reference_tree_bits(
        jax.random.fold_in(base, t), jvals)]) if noise else None)
    rep = session.run(ROUNDS, values=tree_from_numpy(vals, device="cpu"),
                      bits_at=bits_at)
    assert isinstance(rep.state.push.s, dict)
    _trees_close(rep.state.push.s, ref_rep.state.push.s, 1e-5, 1e-6)
    for k, v in ref_rep.trajectory.items():
        _close(rep.trajectory[k], v, 1e-5, 1e-6)
    assert rep.wire_bytes == ref_rep.wire_bytes


def _train_sessions(R, noise, schedule="dense", packed=True):
    params, batches = _mlp_setup(R)
    privacy = dict(b=1.0, gamma_n=GAMMA_N, noise=noise)
    deploy = dict(algorithm="partpsp", gamma_l=0.1, gamma_s=0.1, clip=100.0,
                  schedule=schedule, sync_interval=SYNC, chunk=4, seed=SEED,
                  partition=PARTITIONS["partpsp-2"])
    ref_session = R.api.Session.build(
        R.core.topology.DOutGraph(N, 2),
        privacy=R.api.PrivacySpec(**privacy), model=_ref_mlp_loss,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        use_kernels=noise, **deploy)
    session = Session.build(T.DOutGraph(N, 2),
                            privacy=PrivacySpec(**privacy), model=mlp_loss,
                            params=tree_from_numpy(params, device="cpu"),
                            device="cpu", packed=packed, **deploy)
    return ref_session, session, batches


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("schedule", ["dense", "circulant", "sparse"])
def test_loop_driver_matches_reference(R, schedule, noise):
    ref_session, session, batches = _train_sessions(R, noise, schedule)
    ref_rep = ref_session.train(ROUNDS, lambda t: jax.tree_util.tree_map(
        jnp.asarray, batches[t]), driver="loop")
    template = ref_session.train_state().dpps.push.s
    base = jax.random.PRNGKey(SEED)
    bits_at = ((lambda t: [torch.from_numpy(b) for b in reference_tree_bits(
        jax.random.split(jax.random.fold_in(base, t), 3)[2], template)])
        if noise else None)
    rep = session.train(ROUNDS,
                        lambda t: tree_from_numpy(batches[t], device="cpu"),
                        bits_at=bits_at, driver="loop")
    assert rep.rounds == ref_rep.rounds == ROUNDS
    assert set(rep.trajectory) == set(ref_rep.trajectory)
    for k, v in ref_rep.trajectory.items():
        assert rep.trajectory[k].shape == v.shape, k
        _close(rep.trajectory[k], v, 1e-4, 1e-5)
    _trees_close(rep.state.dpps.push.s, ref_rep.state.dpps.push.s, 1e-4,
                 1e-5)
    _trees_close(rep.state.local, ref_rep.state.local, 1e-4, 1e-5)
    assert rep.epsilon_spent == ref_rep.epsilon_spent


@pytest.mark.parametrize("schedule", ["dense", "sparse"])
def test_loop_driver_agrees_with_the_engine(R, schedule):
    """The seeded Philox stream: the loop (pytree, plain route) against the
    engine (packed) and against the engine over the pytree runtime."""
    _, session, batches = _train_sessions(R, True, schedule)
    _, unpacked, _ = _train_sessions(R, True, schedule, packed=False)
    batch_at = lambda t: tree_from_numpy(batches[t], device="cpu")
    loop = session.train(ROUNDS, batch_at, driver="loop")
    reps = [session.train(ROUNDS, batch_at),
            unpacked.train(ROUNDS, batch_at)]
    for rep in reps:
        assert set(rep.trajectory) == set(loop.trajectory)
        for k, v in rep.trajectory.items():
            torch.testing.assert_close(loop.trajectory[k], v, rtol=1e-6,
                                       atol=1e-7)
        for x, y in zip(tree_leaves(loop.state), tree_leaves(rep.state)):
            if isinstance(x, torch.Tensor):
                torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
            else:
                assert x == y


def test_loop_driver_takes_one_round_segments():
    session = Session.build(T.DOutGraph(4, 2), privacy=PrivacySpec(
        b=1.0, gamma_n=1e-3), model=mlp_loss, params=tree_from_numpy(
        {"l1": np.ones((D_IN, HIDDEN), np.float32) * 0.1,
         "l2": np.ones((HIDDEN, D_IN), np.float32) * 0.1,
         "l3": np.ones((D_IN, N_CLASSES), np.float32) * 0.1},
        device="cpu"), partition=PARTITIONS["partpsp-1"], device="cpu",
        chunk=4)
    gen = torch.Generator().manual_seed(0)
    batch = (torch.randn((4, 8, D_IN), generator=gen),
             torch.randint(0, N_CLASSES, (4, 8), generator=gen))
    seen = []

    class Spy(RoundHook):
        def consume(self, rows, *, t0):
            seen.append((t0, rows["loss_mean"].shape))

    session.train(3, lambda t: batch, driver="loop", hooks=[Spy()])
    assert seen == [(0, (1,)), (1, (1,)), (2, (1,))]
    with pytest.raises(ValueError, match="driver"):
        session.train(1, lambda t: batch, driver="scan")


# -- clips and the sensitivity helpers ---------------------------------------

def test_l2_clip_and_reset_sensitivity_match_reference(R):
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(N, 6, 4)).astype(np.float32) * 3,
            "b": rng.normal(size=(N, 5)).astype(np.float32)}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = tree_from_numpy(tree, device="cpu")
    for clip in (1.0, 1e3):
        got, gn = l2_clip_per_node(tt, clip)
        want, wn = R.core.privacy.l2_clip_per_node(jt, clip)
        _trees_close(got, want, 1e-6, 1e-7)
        _close(gn, wn, 1e-6, 0)
    got_l1, _ = l1_clip_per_node(tt, 2.0)
    want_l1, _ = R.core.privacy.l1_clip_per_node(jt, 2.0)
    _trees_close(got_l1, want_l1, 1e-6, 1e-7)
    eps_l1 = rng.random(N).astype(np.float32)
    state = init_sensitivity(tt, torch.from_numpy(eps_l1), c_prime=0.8,
                             lam=0.5)
    rstate = R.core.sensitivity.init_sensitivity(jt, jnp.asarray(eps_l1),
                                                 c_prime=0.8, lam=0.5)
    synced = {k: np.broadcast_to(v.mean(0), v.shape).copy()
              for k, v in tree.items()}
    got = reset_sensitivity(state, tree_from_numpy(synced, device="cpu"),
                            torch.from_numpy(eps_l1))
    want = R.core.sensitivity.reset_sensitivity(
        rstate, jax.tree_util.tree_map(jnp.asarray, synced),
        jnp.asarray(eps_l1))
    _close(got.s_local, want.s_local, 1e-6, 0)
    np.testing.assert_array_equal(to_numpy(got.prev_noise_l1),
                                  np.zeros(N, np.float32))


@pytest.mark.parametrize("chunk", [None, 1, 2, 3, 16])
def test_real_sensitivity_in_row_blocks_is_exact(R, chunk):
    """Every block size gives the single-shot value bit for bit, and the
    reference's to rtol 1e-6."""
    rng = np.random.default_rng(6)
    tree = [rng.normal(size=(N, 33)).astype(np.float32),
            rng.normal(size=(N, 4, 5)).astype(np.float32)]
    tt = tree_from_numpy(tree, device="cpu")
    got = real_sensitivity(tt, chunk=chunk)
    torch.testing.assert_close(got, real_sensitivity(tt), rtol=0, atol=0)
    want = R.core.sensitivity.real_sensitivity(
        [jnp.asarray(x) for x in tree], chunk=chunk)
    _close(got, want, 1e-6, 0)


def test_unpacked_plan_and_the_replaced_dataclass():
    plan = ProtocolPlan.from_topology(T.DOutGraph(4, 2), device="cpu",
                                      packed=False)
    assert plan.packed is False
    assert dataclasses.replace(plan, packed=True).packed is True
