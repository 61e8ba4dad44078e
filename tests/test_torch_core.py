"""The port's protocol core against the reference's, module by module.

Topology (W, offsets, the calibrated ``(C', lambda)``) and the packed
layout's offsets are computed from the same numbers on both sides and must
match exactly. Float state agrees to rtol 1e-5 / atol 1e-6: the two
frameworks sum f32 values in other orders. The DPPS round is compared with
the noise off against the reference's plain path, and with the noise on
against its Pallas path (interpret mode) fed the reference's exact bits.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import load_reference, reference_bits, to_numpy

from repro_torch.convert import (
    dpps_state_from_reference,
    partpsp_state_from_reference,
    tree_from_numpy,
)
from repro_torch.core import topology as T
from repro_torch.core.dpps import DPPSConfig, dpps_init, dpps_step
from repro_torch.core.packing import PackedLayout
from repro_torch.core.partition import Partition
from repro_torch.core.privacy import PrivacyAccountant, l1_clip_per_node
from repro_torch.core.pushsum import (
    PushSumState,
    consensus_error,
    correct,
    gossip_dense,
    gossip_packed,
)
from repro_torch.core.sensitivity import init_sensitivity, real_sensitivity
from repro_torch.core.tree_utils import tree_leaves
from repro_torch.data import SyntheticClassification, dirichlet_partition

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def R():
    return load_reference()


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _trees_close(got, want, rtol=RTOL, atol=ATOL):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        assert tuple(x.shape) == tuple(y.shape)
        _close(x, y, rtol, atol)


def _values(n, seed=0):
    """A two-leaf node-stacked tree (dict keys sorted: "b" before "w")."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 5, 7)).astype(np.float32),
            "b": rng.normal(size=(n, 3)).astype(np.float32)}


# -- topology ----------------------------------------------------------------

def _topologies(mod):
    return [mod.DOutGraph(10, 2), mod.DOutGraph(6, 4), mod.ExpGraph(9),
            mod.ExpGraph(2), mod.RingGraph(7), mod.RingGraph(2),
            mod.FullyConnectedGraph(4),
            mod.TimeVaryingTopology(6, schedule=(mod.DOutGraph(6, 2),
                                                 mod.ExpGraph(6)))]


@pytest.mark.parametrize("i", range(8))
def test_topology_weights_and_offsets_match_exactly(R, i):
    mine, theirs = _topologies(T)[i], _topologies(R.core.topology)[i]
    period = int(getattr(theirs, "period", 1))
    assert int(getattr(mine, "period", 1)) == period
    for t in range(period + 1):
        np.testing.assert_array_equal(mine.weight_matrix(t),
                                      theirs.weight_matrix(t))
        assert tuple(mine.offsets(t)) == tuple(theirs.offsets(t))
        o1, w1 = mine.mixing_weights(t)
        o2, w2 = theirs.mixing_weights(t)
        assert o1 == o2
        np.testing.assert_array_equal(w1, w2)
    assert T.spectral_gap(mine) == R.core.topology.spectral_gap(theirs)
    assert T.contraction_rate(mine) == R.core.topology.contraction_rate(theirs)


@pytest.mark.parametrize("i", [0, 2, 4])
def test_calibrated_constants_match_exactly(R, i):
    mine, theirs = _topologies(T)[i], _topologies(R.core.topology)[i]
    assert T.calibrate_constants(mine) == \
        R.core.topology.calibrate_constants(theirs)


def test_topology_rejects_bad_degree():
    with pytest.raises(ValueError):
        T.DOutGraph(3, 4)
    with pytest.raises(ValueError):
        T.ExpGraph(1)


# -- packing -----------------------------------------------------------------

@pytest.mark.parametrize("lane", [1, 128])
def test_layout_offsets_and_pack_match_exactly(R, lane):
    vals = _values(4)
    vals["z"] = np.arange(4, dtype=np.float32)  # a scalar-per-node leaf
    mine = PackedLayout.from_tree(tree_from_numpy(vals, device="cpu"),
                                  lane=lane)
    theirs = R.core.packing.PackedLayout.from_tree(
        jax.tree_util.tree_map(jnp.asarray, vals), lane=lane)
    assert (mine.d_s, mine.d_pad) == (theirs.d_s, theirs.d_pad)
    assert [(s.shape, s.offset, s.size) for s in mine.segments] == \
        [(s.shape, s.offset, s.size) for s in theirs.segments]
    buf = mine.pack(tree_from_numpy(vals, device="cpu"))
    want = theirs.pack(jax.tree_util.tree_map(jnp.asarray, vals))
    np.testing.assert_array_equal(to_numpy(buf), np.asarray(want))
    back = mine.unpack(buf)
    for k in vals:
        np.testing.assert_array_equal(to_numpy(back[k]), vals[k])
    np.testing.assert_array_equal(to_numpy(mine.wire_slice(buf)),
                                  np.asarray(theirs.wire_slice(want)))
    _close(mine.l1_norm_per_node(buf), theirs.l1_norm_per_node(want))
    delta = tree_from_numpy(_values(4, seed=1) | {"z": np.ones(4, np.float32)},
                            device="cpu")
    _close(mine.add_wire(buf, delta),
           theirs.add_wire(want, jax.tree_util.tree_map(
               lambda x: jnp.asarray(to_numpy(x)), delta)))


# -- push-sum ----------------------------------------------------------------

def _push_pair(n, d, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(n, d)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, size=(n,)).astype(np.float32)
    return s, a


@pytest.mark.parametrize("topo_i", [0, 2, 4])
def test_dense_and_circulant_mixes_match_reference(R, topo_i):
    mine, theirs = _topologies(T)[topo_i], _topologies(R.core.topology)[topo_i]
    n = mine.n_nodes
    s, a = _push_pair(n, 300)
    ps = PushSumState(torch.from_numpy(s), torch.from_numpy(a))
    rs = R.core.pushsum.PushSumState(jnp.asarray(s), jnp.asarray(a))
    for t in range(2):
        w = mine.weight_matrix(t).astype(np.float32)
        got = gossip_packed(ps, w=torch.from_numpy(w))
        want = R.core.pushsum.gossip_packed(rs, w=jnp.asarray(w))
        _close(got.s, want.s)
        _close(got.a, want.a)
        tree = tree_from_numpy(_values(n, seed=t), device="cpu")
        got_t = gossip_dense(PushSumState(tree, ps.a), torch.from_numpy(w))
        want_t = R.core.pushsum.gossip_dense(R.core.pushsum.PushSumState(
            jax.tree_util.tree_map(jnp.asarray, _values(n, seed=t)), rs.a),
            jnp.asarray(w))
        _trees_close(got_t.s, want_t.s)
        _close(got_t.a, want_t.a)
        offs, wts = mine.mixing_weights(t)
        got = gossip_packed(ps, offsets=offs,
                            weights=torch.tensor(wts, dtype=torch.float32))
        want = R.core.pushsum.gossip_packed(
            rs, offsets=offs, weights=jnp.asarray(wts, jnp.float32))
        _close(got.s, want.s)
        _close(got.a, want.a)


def test_correct_and_consensus_error_match_reference(R):
    vals = _values(5)
    _, a = _push_pair(5, 1)
    tree_t, a_t = tree_from_numpy(vals, device="cpu"), torch.from_numpy(a)
    tree_j = jax.tree_util.tree_map(jnp.asarray, vals)
    y_t = correct(tree_t, a_t)
    y_j = R.core.pushsum.correct(tree_j, jnp.asarray(a))
    _trees_close(y_t, y_j)
    want = R.core.pushsum.consensus_error(y_j)
    _close(consensus_error(y_t), want)
    # the chunked buffer form: y = s / a computed block by block
    layout = PackedLayout.from_tree(tree_t, lane=128)
    _close(consensus_error(layout.wire_slice(layout.pack(tree_t)), a=a_t,
                           chunk=7), want)


# -- sensitivity, clipping, accounting ---------------------------------------

def test_sensitivity_init_and_real_sensitivity_match_reference(R):
    """The t = 0 branch of Remark 1 and the exact sensitivity. The t > 0
    recursion lives in dpps_step and is held below, round by round."""
    vals = _values(4)
    eps0 = np.random.default_rng(3).uniform(0, 3, size=4).astype(np.float32)
    vals_j = jax.tree_util.tree_map(jnp.asarray, vals)
    mine = init_sensitivity(tree_from_numpy(vals, device="cpu"),
                            torch.from_numpy(eps0),
                            c_prime=0.78, lam=0.55)
    theirs = R.core.sensitivity.init_sensitivity(
        vals_j, jnp.asarray(eps0), c_prime=0.78, lam=0.55)
    for f in mine._fields:
        _close(getattr(mine, f), getattr(theirs, f))
    _close(real_sensitivity(tree_from_numpy(vals, device="cpu")),
           R.core.sensitivity.real_sensitivity(vals_j))


def test_l1_clip_and_accountant_match_reference(R):
    vals = _values(6)
    vals["w"][2] *= 100.0  # one node above the clip
    got, norms = l1_clip_per_node(tree_from_numpy(vals, device="cpu"), 10.0)
    want, want_norms = R.core.privacy.l1_clip_per_node(
        jax.tree_util.tree_map(jnp.asarray, vals), 10.0)
    _trees_close(got, want)
    _close(norms, want_norms)
    mine = PrivacyAccountant(b=1.0, gamma_n=0.05, budget=50.0)
    theirs = R.core.privacy.PrivacyAccountant(b=1.0, gamma_n=0.05, budget=50.0)
    for protected in (True, True, False, True):
        mine, theirs = mine.step(protected=protected), theirs.step(
            protected=protected)
    assert mine.summary() == theirs.summary()


# -- partition ---------------------------------------------------------------

@pytest.mark.parametrize("rules", [
    (("l1", "shared"),),
    (("l1|l2", "shared"),),
    ((".*", "shared"),),
    (("l1", "shared"), ("blocks", ("split_layers", 2))),
])
def test_partition_matches_reference(R, rules):
    rng = np.random.default_rng(4)
    params = {"l1": rng.normal(size=(3, 8, 4)).astype(np.float32),
              "l2": rng.normal(size=(3, 4, 8)).astype(np.float32),
              "blocks": {"w": rng.normal(size=(3, 5, 2, 2)).astype(np.float32)},
              "l3": rng.normal(size=(3, 8)).astype(np.float32)}
    mine = Partition.from_rules(tree_from_numpy(params, device="cpu"), rules,
                                default="local")
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    theirs = R.core.partition.Partition.from_rules(pj, rules, default="local")
    assert mine.d_shared() == theirs.d_shared()
    assert mine.d_shared(per_node=False) == theirs.d_shared(per_node=False)
    sh, lo = mine.split(tree_from_numpy(params, device="cpu"))
    sh_j, lo_j = theirs.split(pj)
    _trees_close(sh, sh_j, 0, 0)
    _trees_close(lo, lo_j, 0, 0)
    merged = mine.merge(sh, lo)
    _trees_close(merged, pj, 0, 0)


# -- the DPPS round ----------------------------------------------------------

def _run_rounds(R, *, noise, lane, mode="estimated", rounds=4, sync=3, n=5,
                seed=11):
    """``rounds`` dpps_step calls on both sides from the same values and
    perturbations; returns the per-round (port, reference) pairs."""
    vals = _values(n)
    rng = np.random.default_rng(7)
    eps_seq = [_values(n, seed=100 + t) for t in range(rounds)]
    for e in eps_seq:
        e["w"] *= 0.1
    topo = T.DOutGraph(n, 2)
    w = topo.weight_matrix(0).astype(np.float32)
    kw = dict(b=2.0, gamma_n=0.05 if noise else 0.0, noise=noise,
              c_prime=0.9, lam=0.6, sync_interval=sync,
              sensitivity_mode=mode, fixed_sensitivity=3.0)
    # The reference's noise-on path is its Pallas kernel path (interpret
    # mode), whose bits reference_bits rebuilds; noise off is its plain path.
    r_cfg = R.core.dpps.DPPSConfig(use_kernels=noise, **kw)
    r_layout = R.core.packing.PackedLayout.from_tree(
        jax.tree_util.tree_map(jnp.asarray, vals), lane=128 if noise else 1)
    r_state = R.core.dpps.dpps_init(jax.tree_util.tree_map(jnp.asarray, vals),
                                    r_cfg)
    r_state = r_state._replace(push=r_state.push._replace(
        s=r_layout.pack(r_state.push.s)))
    cfg = DPPSConfig(**kw)
    layout = PackedLayout.from_tree(tree_from_numpy(vals, device="cpu"),
                                    lane=lane)
    state = dpps_init(tree_from_numpy(vals, device="cpu"), cfg)
    state = state._replace(push=state.push._replace(
        s=layout.pack(state.push.s)))
    base = jax.random.PRNGKey(seed)
    out = []
    for t in range(rounds):
        r_eps = [jnp.asarray(eps_seq[t][k]) for k in ("b", "w")]
        r_state, r_diag = R.core.dpps.dpps_step(
            r_state, {"b": r_eps[0], "w": r_eps[1]},
            jax.random.fold_in(base, t), r_cfg, w=jnp.asarray(w),
            layout=r_layout)
        bits = (torch.from_numpy(reference_bits(seed, t, n, layout.d_s))
                if noise else None)
        state, diag = dpps_step(state,
                                tree_from_numpy(eps_seq[t], device="cpu"), cfg,
                                layout, w=torch.from_numpy(w), bits=bits)
        out.append(((state, diag, layout), (r_state, r_diag, r_layout)))
    return out


@pytest.mark.parametrize("noise,lane,mode", [
    (False, 1, "estimated"), (False, 128, "estimated"),
    (True, 1, "estimated"), (True, 128, "estimated"),
    (True, 128, "real"), (True, 1, "fixed")])
def test_dpps_step_matches_reference(R, noise, lane, mode):
    """Four rounds: the t == 0 init, the recursion, a sync round (t = 2
    with sync_interval 3) and the restart after it; with the estimated
    (Remark 1), exact and fixed sensitivity calibrating the noise."""
    for t, ((st, diag, lay), (rst, rdiag, rlay)) in enumerate(
            _run_rounds(R, noise=noise, lane=lane, mode=mode)):
        assert st.t == int(rst.t) == t + 1
        _trees_close(lay.unpack(st.push.s), rlay.unpack(rst.push.s))
        np.testing.assert_array_equal(to_numpy(st.push.s)[:, lay.d_s:], 0.0)
        _close(st.push.a, rst.push.a)
        for f in ("s_local", "prev_noise_l1"):
            _close(getattr(st.sens, f), getattr(rst.sens, f))
        assert set(diag) == set(rdiag)
        for k in diag:
            _close(diag[k], rdiag[k])
        if noise and t != 2:
            assert float(diag["noise_l1_mean"]) > 0


def test_states_convert_from_reference(R):
    vals = _values(3)
    cfg = R.core.partpsp.make_baseline_config("partpsp")
    part = R.core.partition.Partition.from_rules(
        jax.tree_util.tree_map(jnp.asarray, vals), (("w", "shared"),),
        default="local")
    rs = R.core.partpsp.partpsp_init(
        jax.tree_util.tree_map(jnp.asarray, vals), part, cfg)
    st = partpsp_state_from_reference(jax.tree_util.tree_map(np.asarray, rs),
                                      device="cpu")
    assert st.dpps.t == 0
    _trees_close(st.dpps.push.s, rs.dpps.push.s, 0, 0)
    _trees_close(st.local, rs.local, 0, 0)
    _close(st.dpps.push.a, rs.dpps.push.a, 0, 0)
    _close(st.dpps.sens.s_local, rs.dpps.sens.s_local, 0, 0)
    _close(st.dpps.sens.c_prime, rs.dpps.sens.c_prime, 0, 0)
    alone = dpps_state_from_reference(
        jax.tree_util.tree_map(np.asarray, rs.dpps), device="cpu")
    _trees_close(alone.push.s, rs.dpps.push.s, 0, 0)


def test_convert_defaults_to_the_card(R, monkeypatch):
    """Without a CUDA card the default device raises; "cpu" works."""
    vals = _values(3)
    cfg = R.core.partpsp.make_baseline_config("partpsp")
    part = R.core.partition.Partition.from_rules(
        jax.tree_util.tree_map(jnp.asarray, vals), (("w", "shared"),),
        default="local")
    rs = jax.tree_util.tree_map(np.asarray, R.core.partpsp.partpsp_init(
        jax.tree_util.tree_map(jnp.asarray, vals), part, cfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, arg in ((tree_from_numpy, vals), (dpps_state_from_reference,
                                              rs.dpps),
                    (partpsp_state_from_reference, rs)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(arg)
    assert tree_from_numpy(vals, device="cpu")["w"].device.type == "cpu"
    st = partpsp_state_from_reference(rs, device="cpu")
    assert st.dpps.push.a.device.type == "cpu"
    assert dpps_state_from_reference(rs.dpps, device="cpu").t == 0


# -- data --------------------------------------------------------------------

def test_synthetic_data_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticClassification(d_in=4)
    task = SyntheticClassification(d_in=4, device="cpu")
    assert task.w1.device.type == "cpu" and task.device.type == "cpu"


def test_synthetic_teacher_and_dirichlet_match_exactly(R):
    mine = SyntheticClassification(d_in=12, seed=5, device="cpu")
    theirs = R.data.SyntheticClassification(d_in=12, seed=5)
    np.testing.assert_array_equal(to_numpy(mine.w1), np.asarray(theirs._w1))
    np.testing.assert_array_equal(to_numpy(mine.w2), np.asarray(theirs._w2))
    np.testing.assert_array_equal(dirichlet_partition(6, 10, seed=3),
                                  R.data.dirichlet_partition(6, 10, seed=3))
    # labels of the same inputs agree
    x = np.random.default_rng(0).normal(size=(50, 12)).astype(np.float32)
    want = np.argmax(np.tanh(x @ np.asarray(theirs._w1)) @ np.asarray(
        theirs._w2), axis=-1)
    np.testing.assert_array_equal(to_numpy(mine.label(torch.from_numpy(x))),
                                  want)
    gen = torch.Generator().manual_seed(0)
    xb, yb = mine.node_batches(gen, 4, 8, dirichlet_partition(4, 10))
    assert tuple(xb.shape) == (4, 8, 12) and tuple(yb.shape) == (4, 8)
