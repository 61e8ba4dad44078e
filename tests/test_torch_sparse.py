"""The sparse gossip schedule and the clip / Laplace tree ops of the port,
against the reference.

* Topology: ``padded_csr``, ``sparse_weights``, ``max_in_degree`` and the
  W of every ported graph family are computed by the same numpy code on
  both sides and must match exactly.
* The plain ``spmm`` against ``repro.kernels.ref.spmm`` and the Pallas SpMM
  in interpret mode (``repro.kernels.ops.pushsum_mix_sparse``), to rtol
  1e-6 / atol 1e-6: both sum at most K <= 40 f32 products of O(1) values,
  in another order (slot-order adds here, a dot there).
* ``Session.run`` / ``Session.train`` with ``schedule="sparse"`` against
  the reference ``Session``: 7 rounds, sync 5, chunk 3; noise off against
  its plain path, noise on against its Pallas path fed the same bits. The
  tolerances are those of ``tests/test_torch_session.py``.
* ``ops.l1_clip_tree`` and ``ops.laplace_noise_tree`` (their plain route,
  on the CPU) against the reference ops of the same names.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import (
    load_reference,
    reference_bits,
    reference_tree_bits,
    to_numpy,
)
from test_torch_session import (
    BATCH,
    CHUNK,
    D_IN,
    N_CLASSES,
    ROUNDS,
    SEED,
    SYNC,
    _check_dpps_state,
    _check_report,
    _ref_init_mlp,
    _ref_mlp_loss,
    _trees_close,
)

from repro_torch import net
from repro_torch.api import PrivacySpec, Session
from repro_torch.convert import tree_from_numpy
from repro_torch.core import topology as T
from repro_torch.core.dpps import DPPSConfig, dpps_init, dpps_step
from repro_torch.core.packing import PackedLayout
from repro_torch.core.pushsum import (PushSumState, gossip_packed,
                                     gossip_sparse, sparse_mix)
from repro_torch.engine import ProtocolPlan
from repro_torch.kernels import ops
from repro_torch.models.mlp import PARTITIONS, mlp_loss

N_SPARSE = 16


@pytest.fixture(scope="module")
def R():
    return load_reference()


# -- topology ----------------------------------------------------------------

def _families(core, graphs):
    """(topology, rounds to check) pairs, built from either package."""
    return [
        (core.DOutGraph(10, 3), 1),
        (core.ExpGraph(9), 4),
        (core.RingGraph(7), 1),
        (graphs.ErdosRenyiGraph(17, p=0.3, seed=3), 1),
        (graphs.RandomMatchingGraph(12, k=2, seed=1), 1),
        (graphs.SmallWorldGraph(12, k=3, beta=0.4, seed=2), 1),
        (graphs.TorusGraph(12), 1),
        (graphs.RandomSequenceTopology(
            10, base=graphs.ErdosRenyiGraph(10, p=0.3, seed=4), period=3), 3),
    ]


@pytest.mark.parametrize("i", range(8))
def test_padded_csr_and_graph_weights_match_reference_exactly(R, i):
    mine, rounds = _families(T, net)[i]
    theirs, _ = _families(R.core.topology, R.net.graphs)[i]
    for t in range(rounds):
        w = mine.weight_matrix(t)
        np.testing.assert_array_equal(w, theirs.weight_matrix(t))
        need = mine.max_in_degree(t)
        assert need == theirs.max_in_degree(t)
        for k in (None, need + 3):  # own K, and a forced larger one
            idx, vals = mine.sparse_weights(t, k)
            r_idx, r_vals = theirs.sparse_weights(t, k)
            assert idx.dtype == r_idx.dtype == np.int32
            assert vals.dtype == r_vals.dtype == np.float64
            np.testing.assert_array_equal(idx, r_idx)
            np.testing.assert_array_equal(vals, r_vals)
            assert (np.diff(idx, axis=1) >= 0).all()  # ascending senders
        with pytest.raises(ValueError, match="max in-degree"):
            T.padded_csr(w, need - 1)
    assert net.fold_seed(7, 3) == R.net.graphs.fold_seed(7, 3)


def test_sparse_plan_stacks_the_reference_edge_lists(R):
    """K is the largest in-degree over the period; no dense W is stacked;
    mix_at(t) hands round t's pair on."""
    mine = net.RandomSequenceTopology(
        12, base=net.ErdosRenyiGraph(12, p=0.4, seed=5), period=3)
    theirs = R.net.graphs.RandomSequenceTopology(
        12, base=R.net.graphs.ErdosRenyiGraph(12, p=0.4, seed=5), period=3)
    plan = ProtocolPlan.from_topology(mine, schedule="sparse", device="cpu")
    r_plan = R.engine.plan.ProtocolPlan.from_topology(theirs,
                                                      schedule="sparse")
    assert plan.schedule == "sparse" and plan.ws is None
    assert plan.sparse_idx.dtype == torch.int32
    assert plan.sparse_vals.dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(plan.sparse_idx),
                                  np.asarray(r_plan.sparse_idx))
    np.testing.assert_array_equal(to_numpy(plan.sparse_vals),
                                  np.asarray(r_plan.sparse_vals))
    assert plan.sparse_idx.shape[2] == max(mine.max_in_degree(t)
                                           for t in range(3))
    got = plan.mix_at(4)
    assert set(got) == {"sparse_idx", "sparse_vals"}
    assert torch.equal(got["sparse_idx"], plan.sparse_idx[1])
    # never chosen by itself
    assert ProtocolPlan.from_topology(mine, device="cpu").schedule == "dense"


# -- the plain sparse mix ----------------------------------------------------

@pytest.mark.parametrize("n,d", [(n, d) for n in (4, 16, 40)
                                 for d in (3, 7840, 8192)])
def test_spmm_matches_reference(R, n, d):
    topo = net.ErdosRenyiGraph(n, p=0.3, seed=n)
    idx, vals = topo.sparse_weights(0, topo.max_in_degree(0) + 2)
    vals = vals.astype(np.float32)
    x = np.random.default_rng(n * d).normal(size=(n, d)).astype(np.float32)
    got = to_numpy(ops.spmm(torch.from_numpy(idx), torch.from_numpy(vals),
                            torch.from_numpy(x)))
    oracle = np.asarray(R.kernels.ref.spmm(jnp.asarray(idx),
                                           jnp.asarray(vals), jnp.asarray(x)))
    pallas = np.asarray(R.kernels.ops.pushsum_mix_sparse(
        jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(x)))
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
    # the port's sparse mix against its dense mix on the same W
    w = topo.weight_matrix_torch(0)
    dense = to_numpy(ops.pushsum_mix(w, torch.from_numpy(x)))
    np.testing.assert_allclose(got, dense, rtol=1e-6, atol=1e-6)


def test_sparse_mix_keeps_trailing_shape_and_gossip_mixes_a(R):
    topo = net.RandomMatchingGraph(6, k=2, seed=0)
    idx, vals = (torch.from_numpy(v) for v in topo.sparse_weights(0))
    vals = vals.float()
    x = torch.randn((6, 4, 5), generator=torch.Generator().manual_seed(0))
    want = R.core.pushsum.sparse_mix(jnp.asarray(idx.numpy()),
                                     jnp.asarray(vals.numpy()),
                                     jnp.asarray(x.numpy()))
    np.testing.assert_allclose(to_numpy(sparse_mix(idx, vals, x)),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    state = PushSumState(s=x.reshape(6, 20), a=torch.ones(6))
    out = gossip_packed(state, sparse_idx=idx, sparse_vals=vals)
    torch.testing.assert_close(out.a, torch.ones(6), rtol=0, atol=1e-6)
    # the tree-state gossip against the reference's, leaf by leaf
    a = torch.rand(6, generator=torch.Generator().manual_seed(1)) + 0.5
    tree = {"x": x, "y": x[:, 0]}
    got = gossip_sparse(PushSumState(s=tree, a=a), idx, vals)
    ref_state = R.core.pushsum.PushSumState(
        s={k: jnp.asarray(v.numpy()) for k, v in tree.items()},
        a=jnp.asarray(a.numpy()))
    want = R.core.pushsum.gossip_sparse(ref_state, jnp.asarray(idx.numpy()),
                                        jnp.asarray(vals.numpy()))
    for key in tree:  # rtol/atol 1e-6: the same slot-order sums in f32
        np.testing.assert_allclose(to_numpy(got.s[key]),
                                   np.asarray(want.s[key]), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(to_numpy(got.a), np.asarray(want.a),
                               rtol=1e-6, atol=1e-6)


def test_dpps_step_sparse_needs_the_edge_list():
    vals = {"x": torch.ones((4, 8))}
    cfg = DPPSConfig(schedule="sparse", noise=False)
    layout = PackedLayout.from_tree(vals, lane=1)
    st = dpps_init(vals, cfg)
    st = st._replace(push=st.push._replace(s=layout.pack(vals)))
    with pytest.raises(ValueError, match="sparse_idx"):
        dpps_step(st, torch.zeros((4, 8)), cfg, layout)
    with pytest.raises(ValueError, match="unknown"):
        DPPSConfig(schedule="dynamic")


# -- the sparse schedule end to end ------------------------------------------

def _graph(mod, which):
    if which == "er":
        return mod.ErdosRenyiGraph(N_SPARSE, p=0.5, seed=0)
    return mod.RandomMatchingGraph(N_SPARSE, k=2, seed=0)


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("graph", ["er", "matching"])
def test_sparse_session_run_matches_reference(R, graph, noise):
    rng = np.random.default_rng(1)
    vals = {"w": rng.normal(size=(N_SPARSE, 40, 3)).astype(np.float32),
            "b": rng.normal(size=(N_SPARSE, 7)).astype(np.float32)}
    d_s = 127
    eps = [{"w": 0.05 * rng.normal(size=(N_SPARSE, 40, 3)).astype(np.float32),
            "b": np.zeros((N_SPARSE, 7), np.float32)} for _ in range(ROUNDS)]
    privacy = dict(b=2.0, gamma_n=0.02, noise=noise)
    deploy = dict(schedule="sparse", sync_interval=SYNC, chunk=CHUNK,
                  seed=SEED)
    ref_session = R.api.Session.build(
        _graph(R.net.graphs, graph), privacy=R.api.PrivacySpec(**privacy),
        use_kernels=noise, **deploy)
    ref_rep = ref_session.run(
        ROUNDS, values=jax.tree_util.tree_map(jnp.asarray, vals),
        eps_at=lambda t: jax.tree_util.tree_map(jnp.asarray, eps[t]))

    session = Session.build(_graph(net, graph),
                            privacy=PrivacySpec(**privacy), device="cpu",
                            **deploy)
    assert (session.cfg.c_prime, session.cfg.lam) == (
        ref_session.cfg.c_prime, ref_session.cfg.lam)
    assert session.plan.schedule == ref_session.plan.schedule == "sparse"
    bits_at = ((lambda t: torch.from_numpy(
        reference_bits(SEED, t, N_SPARSE, d_s))) if noise else None)
    rep = session.run(ROUNDS, values=tree_from_numpy(vals, device="cpu"),
                      eps_at=lambda t: tree_from_numpy(eps[t], device="cpu"),
                      bits_at=bits_at)
    _check_report(rep, ref_rep, 1e-5, 1e-6)
    _check_dpps_state(rep.state, ref_rep.state, 1e-5, 1e-6)
    _trees_close(session.consensus(rep.state),
                 ref_session.consensus(ref_rep.state), 1e-5, 1e-6)


@pytest.mark.parametrize("noise", [False, True])
def test_sparse_session_train_matches_reference(R, noise):
    key = jax.random.PRNGKey(SEED)
    params = jax.tree_util.tree_map(np.asarray, _ref_init_mlp(key))
    task = R.data.SyntheticClassification(d_in=D_IN, n_classes=N_CLASSES,
                                          seed=SEED)
    skew = R.data.dirichlet_partition(N_SPARSE, N_CLASSES, seed=SEED)
    batches = [jax.tree_util.tree_map(np.asarray, task.node_batches(
        jax.random.fold_in(jax.random.PRNGKey(SEED + 1), t), N_SPARSE, BATCH,
        skew)) for t in range(ROUNDS)]
    privacy = dict(b=1.0, gamma_n=0.005, noise=noise)
    deploy = dict(algorithm="partpsp", gamma_l=0.1, gamma_s=0.1, clip=100.0,
                  schedule="sparse", sync_interval=SYNC, chunk=CHUNK,
                  seed=SEED, partition=PARTITIONS["partpsp-1"])
    ref_session = R.api.Session.build(
        _graph(R.net.graphs, "er"), privacy=R.api.PrivacySpec(**privacy),
        model=_ref_mlp_loss,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        use_kernels=noise, **deploy)
    ref_rep = ref_session.train(ROUNDS, lambda t: jax.tree_util.tree_map(
        jnp.asarray, batches[t]))

    session = Session.build(_graph(net, "er"),
                            privacy=PrivacySpec(**privacy), model=mlp_loss,
                            params=tree_from_numpy(params, device="cpu"),
                            device="cpu", **deploy)
    assert session.plan.schedule == "sparse"
    d_s = session.partition.d_shared()
    bits_at = ((lambda t: torch.from_numpy(reference_bits(
        SEED, t, N_SPARSE, d_s, partpsp=True))) if noise else None)
    rep = session.train(ROUNDS,
                        lambda t: tree_from_numpy(batches[t], device="cpu"),
                        bits_at=bits_at)
    _check_report(rep, ref_rep, 1e-4, 1e-5)
    _check_dpps_state(rep.state.dpps, ref_rep.state.dpps, 1e-4, 1e-5)
    _trees_close(rep.state.local, ref_rep.state.local, 1e-4, 1e-5)
    assert np.all(np.isfinite(rep.trajectory["loss_mean"]))


# -- the clip and Laplace tree ops -------------------------------------------

def _two_leaf_tree(rng):
    return {"w": rng.normal(size=(2, 5, 7)).astype(np.float32),
            "b": rng.normal(size=(2, 3)).astype(np.float32)}


def test_l1_clip_tree_matches_reference(R):
    """Row 0 lies above the clip and is scaled; row 1 below and is kept.
    rtol 1e-6 on the leaves (one division each, by denominators from norms
    summed in another order); 1e-5 on the norms (f32 sums in another
    order)."""
    tree = _two_leaf_tree(np.random.default_rng(0))
    tree["w"][0] *= 10.0
    tree["w"][1] *= 0.1
    tree["b"][1] *= 0.1
    clip = 20.0
    got, norms = ops.l1_clip_tree(tree_from_numpy(tree, device="cpu"), clip)
    want, r_norms = R.kernels.ops.l1_clip_tree(
        jax.tree_util.tree_map(jnp.asarray, tree), clip)
    r_norms = np.asarray(r_norms)
    assert r_norms[0] > clip > r_norms[1]
    np.testing.assert_allclose(to_numpy(norms), r_norms, rtol=1e-5)
    _trees_close(got, want, 1e-6, 0.0)
    np.testing.assert_array_equal(to_numpy(got["w"][1]), tree["w"][1])
    assert ops.launch_counts()["clip_scale_rows"] == 0  # CPU: plain route


def test_laplace_noise_tree_matches_reference(R):
    """The same bits on both sides; rtol 1e-6, the ulp of log between XLA
    and PyTorch."""
    tree = _two_leaf_tree(np.random.default_rng(1))
    key, scale = jax.random.PRNGKey(11), 0.3
    want = R.kernels.ops.laplace_noise_tree(
        key, jax.tree_util.tree_map(jnp.asarray, tree), scale)
    bits = reference_tree_bits(key, jax.tree_util.tree_map(jnp.asarray,
                                                           tree))
    got = ops.laplace_noise_tree(
        {"b": torch.from_numpy(bits[0]), "w": torch.from_numpy(bits[1])},
        scale)
    _trees_close(got, want, 1e-6, 0.0)
    pad = ops.laplace_from_bits(torch.full((5,), 1 << 31, dtype=torch.uint32),
                                torch.tensor(2.0))
    assert torch.equal(pad, torch.zeros(5))  # the padding bits give 0
