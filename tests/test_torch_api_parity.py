"""The reference's public API in the port: each name the port adds for it,
against the reference on the same numpy-seeded inputs, and a walk of both
packages that keeps the two name sets in step.

* Exact: integers, strings, booleans and host numpy results
  (``privacy_summary``, ``PackedLayout.n_segments``,
  ``Partition.describe``, the topology checks and ``effective_contraction``,
  ``tree_count_params`` / ``tree_any_nan``, ``all_configs``).
* rtol 1e-6: the sensitivity recursion, gossip and the tree helpers (f32
  arithmetic in the reference's order; a sum may round otherwise).
* The noise draws: bit for bit where the port is fed the reference's unit
  draws (``draws=``, the reference's ``jax.random`` samples times the same
  scale); on the reference's uint32 bits (``bits=``), the transform to
  rtol 1e-6, as ``test_torch_kernels.py`` holds the two transforms, the
  bits themselves bit for bit. The port's own Philox draws hold each
  other bit for bit (``noise_wire``, ``laplace_noise_flat``,
  ``noise_tree`` take the same columns).
* The runners, trainers and attention functions: 1e-5 for modules
  (attention), 1e-4 / atol 1e-5 for models and training rounds, the
  tolerances of ``test_torch_models.py`` and ``test_torch_session.py``.
* ``test_every_reference_name_is_ported_or_mapped``: every public
  function, class and method of ``src/repro/`` (an AST walk: nothing of
  the reference is imported for it) is importable from the port under the
  same module path, or listed in the README's map, whose port names must
  import and whose rows must not name something the port has.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import (load_reference, reference_bits,
                                  reference_tree_bits, to_numpy)
from test_torch_session import _close, _trees_close

from repro_torch import convert
from repro_torch.api import PrivacySpec, Session
from repro_torch.configs import ARCH_NAMES, all_configs, get_config
from repro_torch.core import privacy as P
from repro_torch.core import pushsum as PS
from repro_torch.core import sensitivity as SN
from repro_torch.core import topology as T
from repro_torch.core import tree_utils as TU
from repro_torch.core.packing import PackedLayout
from repro_torch.core.partition import Partition
from repro_torch.core.partpsp import PartPSPConfig, privacy_summary
from repro_torch.core.dpps import DPPSConfig
from repro_torch.engine import run_segments, stack_rounds
from repro_torch.launch.train import (build_engine_trainer, build_session,
                                      build_trainer)
from repro_torch.models import attention as A
from repro_torch.models.mlp import PARTITIONS, mlp_loss
from repro_torch.net import graphs as G

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 2024


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


def _np_tree(rng, n):
    return {"w": rng.normal(size=(n, 6, 5)).astype(np.float32),
            "b": rng.normal(size=(n, 7)).astype(np.float32),
            "s": rng.normal(size=(n,)).astype(np.float32)}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port(tree):
    return convert.tree_from_numpy(tree, device="cpu")


def _same_bits(got, want):
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


# -- 1. the sensitivity recursion --------------------------------------------

def test_update_and_network_sensitivity_match_reference(R):
    rng = np.random.default_rng(0)
    n = 7
    s_local, prev, eps_l1, noise_l1 = (
        rng.uniform(0.5, 3.0, size=n).astype(np.float32) for _ in range(4))
    ref_sens = R.core.sensitivity
    want = ref_sens.update_sensitivity(
        ref_sens.SensitivityState(jnp.asarray(s_local), jnp.asarray(prev),
                                  jnp.float32(0.9), jnp.float32(0.7)),
        jnp.asarray(eps_l1), jnp.asarray(noise_l1))
    state = SN.SensitivityState(torch.from_numpy(s_local),
                                torch.from_numpy(prev), torch.tensor(0.9),
                                torch.tensor(0.7))
    got = SN.update_sensitivity(state, torch.from_numpy(eps_l1),
                                torch.from_numpy(noise_l1))
    np.testing.assert_allclose(to_numpy(got.s_local), np.asarray(want.s_local),
                               rtol=1e-6)
    _same_bits(got.prev_noise_l1, want.prev_noise_l1)
    assert float(SN.network_sensitivity(got)) == float(
        ref_sens.network_sensitivity(want))
    # gamma_n scales the previous noise term, as dpps_step's recursion does
    half = SN.update_sensitivity(state, torch.from_numpy(eps_l1),
                                 torch.from_numpy(noise_l1), gamma_n=0.5)
    expect = 0.7 * s_local + 2 * 0.9 * (eps_l1 + 0.7 * 0.5 * prev)
    np.testing.assert_allclose(to_numpy(half.s_local), expect, rtol=1e-6)


# -- 2. privacy_summary -------------------------------------------------------

@pytest.mark.parametrize("noise,gamma_n,rounds", [
    (True, 1e-3, 7), (True, 0.0, 3), (False, 0.5, 4), (True, 0.25, 0)])
def test_privacy_summary_equals_reference(R, noise, gamma_n, rounds):
    ref_cfg = R.core.partpsp.PartPSPConfig(
        dpps=R.core.dpps.DPPSConfig(b=3.0, gamma_n=gamma_n, noise=noise))
    cfg = PartPSPConfig(dpps=DPPSConfig(b=3.0, gamma_n=gamma_n, noise=noise))
    assert privacy_summary(cfg, rounds) == R.core.partpsp.privacy_summary(
        ref_cfg, rounds)


# -- 3. gossip and PushSumState.y ---------------------------------------------

@pytest.mark.parametrize("schedule", ["dense", "circulant", "circulant_w"])
def test_gossip_matches_reference(R, schedule):
    rng = np.random.default_rng(1)
    n = 6
    vals = _np_tree(rng, n)
    a = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    topo = T.ExpGraph(n)
    ref_topo = R.core.topology.ExpGraph(n)
    ref_state = R.core.pushsum.PushSumState(_jnp(vals), jnp.asarray(a))
    state = PS.PushSumState(_port(vals), torch.from_numpy(a))
    if schedule == "dense":
        w = topo.weight_matrix(1)
        want = R.core.pushsum.gossip(ref_state, w=jnp.asarray(w, jnp.float32))
        got = PS.gossip(state, w=torch.tensor(w, dtype=torch.float32))
    else:
        offs = tuple(topo.offsets(1))
        weights = (None if schedule == "circulant"
                   else np.array([0.25, 0.75], np.float32))
        want = R.core.pushsum.gossip(
            ref_state, offsets=offs,
            weights=None if weights is None else jnp.asarray(weights))
        got = PS.gossip(state, offsets=offs,
                        weights=None if weights is None
                        else torch.from_numpy(weights))
    _trees_close(got.s, want.s, 1e-6, 0)
    _close(got.a, want.a, 1e-6, 0)
    _trees_close(got.y, want.y, 1e-6, 0)
    with pytest.raises(ValueError, match="w= or offsets="):
        PS.gossip(state)


# -- 4. the noise draws -------------------------------------------------------

@pytest.mark.parametrize("sampler", ["laplace", "normal"])
def test_flat_wire_draw_and_noise_like_on_the_reference_draws(R, sampler):
    """Fed the reference's unit samples, the port's draws are its draws bit
    for bit: the flat row, a leaf (with a per-node scale) and a tree."""
    ref_p = R.core.privacy
    jsampler = {"laplace": jax.random.laplace, "normal": jax.random.normal}[
        sampler]
    key = jax.random.PRNGKey(5)
    n, d_s, scale = 4, 300, np.float32(0.37)
    want = ref_p.flat_wire_draw(key, n, d_s, scale, sampler=jsampler)
    unit = np.array(jsampler(key, (n, d_s), jnp.float32))
    got = P.flat_wire_draw(n, d_s, scale, draws=torch.from_numpy(unit),
                           sampler=sampler, device="cpu")
    _same_bits(got, want)

    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, 5, 3)).astype(np.float32)
    per_node = rng.uniform(0.1, 2.0, size=n).astype(np.float32)
    want = ref_p.noise_like(key, jnp.asarray(x), jnp.asarray(per_node),
                            sampler=jsampler)
    unit = np.array(jsampler(key, x.shape, jnp.float32))
    got = P.noise_like(torch.from_numpy(x), torch.from_numpy(per_node),
                       draws=torch.from_numpy(unit), sampler=sampler)
    _same_bits(got, want)

    tree = _np_tree(rng, n)
    leaves = jax.tree_util.tree_leaves(tree)
    want = ref_p.noise_tree(key, _jnp(tree), scale, sampler=jsampler)
    draws = [torch.from_numpy(np.array(jsampler(k, leaf.shape, jnp.float32)))
             for k, leaf in zip(jax.random.split(key, len(leaves)), leaves)]
    got = P.noise_tree(_port(tree), scale, draws=draws, sampler=sampler)
    for g, w in zip(TU.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        _same_bits(g, w)
    if sampler == "laplace":  # the Laplace names are the same draws
        got_l = P.laplace_noise_tree(_port(tree), scale, draws=draws)
        for g, w in zip(TU.tree_leaves(got_l),
                        jax.tree_util.tree_leaves(want)):
            _same_bits(g, w)


def test_laplace_draws_on_the_reference_bits(R):
    """The reference's kernel path's bits through the port's plain draws:
    the flat row, and a tree on the bits its ``kernels.ops.
    laplace_noise_tree`` draws (a split key a leaf, then a node), each
    against the reference's transform of the same bits (its Pallas
    kernel's plain version, which its own tests hold the kernel to)."""
    n, d_s, t, scale = 3, 257, 4, np.float32(0.8)
    bits = reference_bits(SEED, t, n, d_s)
    want = R.kernels.ref.laplace_from_bits(jnp.asarray(bits), scale)
    got = P.flat_wire_draw(n, d_s, scale, bits=torch.from_numpy(bits),
                           device="cpu")
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-6,
                               atol=0)
    rng = np.random.default_rng(3)
    tree = _np_tree(rng, n)
    key = jax.random.PRNGKey(11)
    nbits = reference_tree_bits(key, tree)
    tbits = [torch.from_numpy(b) for b in nbits]
    got = P.laplace_noise_tree(_port(tree), scale, bits=tbits)
    for g, b in zip(TU.tree_leaves(got), nbits):
        want = R.kernels.ref.laplace_from_bits(jnp.asarray(b), scale)
        np.testing.assert_allclose(to_numpy(g), np.asarray(want), rtol=1e-6,
                                   atol=0)
    x = torch.from_numpy(tree["w"])
    got_x = P.laplace_noise_like(x, scale, bits=tbits[2])
    _same_bits(got_x, to_numpy(TU.tree_leaves(got)[2]))


def test_the_ports_philox_draws_share_their_columns():
    """``noise_wire`` slices ``flat_wire_draw``; ``laplace_noise_flat`` is
    the same call; ``noise_tree`` draws each leaf at its wire columns, so
    it is ``noise_wire``'s leaves; ``node0`` draws a block of the rows."""
    rng = np.random.default_rng(4)
    n, t = 5, 3
    tree = _port(_np_tree(rng, n))
    layout = PackedLayout.from_tree(tree)
    assert layout.n_segments == 3
    scale = torch.tensor(0.6)
    flat = P.flat_wire_draw(n, layout.d_s, scale, seed=SEED, t=t,
                            device="cpu")
    _same_bits(layout.laplace_noise_flat(n, scale, seed=SEED, t=t,
                                         device="cpu"), to_numpy(flat))
    wire = P.noise_wire(tree, scale, seed=SEED, t=t)
    _same_bits(layout.flat_row(wire), to_numpy(flat))
    per_leaf = P.noise_tree(tree, scale, seed=SEED, t=t)
    for g, w in zip(TU.tree_leaves(per_leaf), TU.tree_leaves(wire)):
        _same_bits(g, to_numpy(w))
    block = P.flat_wire_draw(2, layout.d_s, scale, seed=SEED, t=t,
                             device="cpu", node0=3)
    _same_bits(block, to_numpy(flat[3:]))
    normal = P.flat_wire_draw(n, 10, 1.0, seed=SEED, t=t, sampler="normal",
                              device="cpu", col0=4)
    _same_bits(normal, to_numpy(P.normal_row(n, 14, 1.0, seed=SEED, t=t,
                                             device="cpu")[:, 4:]))
    with pytest.raises(ValueError, match="unknown sampler"):
        P.flat_wire_draw(n, 4, 1.0, seed=SEED, t=t, sampler="cauchy")


# -- 5-6. the packed layout and the partition ---------------------------------

@pytest.mark.parametrize("rules", [
    (("w", "shared"), ("b", "local")),
    (("w", ("split_layers", 2)), ("s", "local"))])
def test_n_segments_and_describe_equal_reference(R, rules):
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=(3, 4, 6)).astype(np.float32),
              "b": rng.normal(size=(3, 9)).astype(np.float32),
              "s": rng.normal(size=(3,)).astype(np.float32)}
    want = R.core.partition.Partition.from_rules(_jnp(params), rules)
    got = Partition.from_rules(_port(params), rules)
    assert got.describe() == want.describe()
    shared_ref, _ = want.split(_jnp(params))
    shared, _ = got.split(_port(params))
    assert PackedLayout.from_tree(shared).n_segments == \
        R.core.packing.PackedLayout.from_tree(shared_ref).n_segments


# -- 7. the topology checks ---------------------------------------------------

def _topologies(R):
    rt, rg = R.core.topology, R.net.graphs
    return [
        (T.DOutGraph(8, 3), rt.DOutGraph(8, 3)),
        (T.ExpGraph(8), rt.ExpGraph(8)),
        (T.RingGraph(5), rt.RingGraph(5)),
        (G.RandomMatchingGraph(9, k=2, seed=3),
         rg.RandomMatchingGraph(9, k=2, seed=3)),
        (G.ErdosRenyiGraph(10, p=0.3, seed=7), rg.ErdosRenyiGraph(10, p=0.3,
                                                                  seed=7)),
        (G.TorusGraph(12), rg.TorusGraph(12)),
    ]


def test_topology_checks_equal_reference(R):
    for topo, ref in _topologies(R):
        for t in range(3):
            try:
                want = ref.out_degree(t)
            except NotImplementedError as e:
                with pytest.raises(NotImplementedError) as got:
                    topo.out_degree(t)
                assert str(got.value) == str(e)
            else:
                assert topo.out_degree(t) == want
            w = topo.weight_matrix(t)
            assert T.is_doubly_stochastic(w) is \
                R.core.topology.is_doubly_stochastic(w)
        for t0, window in ((0, 1), (1, 3)):
            assert T.is_strongly_connected_over_window(topo, t0, window) is \
                R.core.topology.is_strongly_connected_over_window(
                    ref, t0, window)
        for period in (None, 2):
            assert T.effective_contraction(topo, period=period) == \
                R.core.topology.effective_contraction(ref, period=period)
    rng = np.random.default_rng(6)
    for mat in (rng.uniform(size=(4, 4)), np.eye(3)[:2], -np.eye(3),
                np.full((5, 5), 0.2)):
        assert T.is_doubly_stochastic(mat) is \
            R.core.topology.is_doubly_stochastic(mat)


# -- 8. the tree helpers ------------------------------------------------------

def test_tree_helpers_match_reference(R):
    tu = R.core.tree_utils
    rng = np.random.default_rng(7)
    a, b = _np_tree(rng, 4), _np_tree(rng, 4)
    scale = rng.uniform(0.5, 2.0, size=4).astype(np.float32)
    ja, jb, pa, pb = _jnp(a), _jnp(b), _port(a), _port(b)
    assert TU.tree_l1_norm_per_node is TU.l1_norm_per_node
    assert TU.tree_node_mean is TU.node_mean
    for got, want in (
            (TU.tree_l1_norm_per_node(pa), tu.tree_l1_norm_per_node(ja)),
            (TU.tree_l2_norm_sq_per_node(pa), tu.tree_l2_norm_sq_per_node(ja))):
        _close(got, want, 1e-6, 0)
    for got, want in (
            (TU.tree_scale_per_node(pa, torch.from_numpy(scale)),
             tu.tree_scale_per_node(ja, jnp.asarray(scale))),
            (TU.tree_add(pa, pb), tu.tree_add(ja, jb)),
            (TU.tree_sub(pa, pb), tu.tree_sub(ja, jb)),
            (TU.tree_scale(pa, 0.3), tu.tree_scale(ja, 0.3)),
            (TU.tree_zeros_like(pa), tu.tree_zeros_like(ja)),
            (TU.tree_node_mean(pa), tu.tree_node_mean(ja))):
        _trees_close(got, want, 1e-6, 0)
    for per_node in (True, False):
        assert TU.tree_count_params(pa, per_node=per_node) == \
            tu.tree_count_params(ja, per_node=per_node)
    bad = dict(a, b=a["b"].copy())
    bad["b"][2, 3] = np.inf
    for tree in (a, bad):
        assert bool(TU.tree_any_nan(_port(tree))) is bool(
            tu.tree_any_nan(_jnp(tree)))


# -- 9-10. the segment drivers and the session's runners ----------------------

N_MLP, D_IN, ROUNDS, CHUNK, SYNC = 5, 24, 7, 3, 5


def _mlp_setup(rng):
    params = {"l1": (rng.normal(size=(D_IN, 10)) / np.sqrt(D_IN)).astype(
        np.float32),
        "l2": (rng.normal(size=(10, D_IN)) / np.sqrt(10)).astype(np.float32),
        "l3": (rng.normal(size=(D_IN, 10)) / np.sqrt(D_IN)).astype(np.float32)}
    batches = [(rng.normal(size=(N_MLP, 8, D_IN)).astype(np.float32),
                rng.integers(0, 10, size=(N_MLP, 8)).astype(np.int32))
               for _ in range(ROUNDS)]
    return params, batches


def _mlp_sessions(R, params, noise):
    privacy = dict(b=1.0, gamma_n=1e-4, noise=noise)
    deploy = dict(partition=PARTITIONS["partpsp-1"], algorithm="partpsp",
                  gamma_l=0.1, gamma_s=0.1, clip=100.0, schedule="dense",
                  sync_interval=SYNC, chunk=CHUNK, seed=SEED)

    def ref_loss(p, batch, key):
        x, y = batch
        h = jnp.tanh(jnp.tanh(x @ p["l1"]) @ p["l2"]) @ p["l3"]
        logp = jax.nn.log_softmax(h)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))

    ref = R.api.Session.build(
        R.core.topology.DOutGraph(N_MLP, 2),
        privacy=R.api.PrivacySpec(**privacy), model=ref_loss,
        params=_jnp(params), use_kernels=noise, **deploy)
    port = Session.build(T.DOutGraph(N_MLP, 2), privacy=PrivacySpec(**privacy),
                         model=mlp_loss, params=_port(params), device="cpu",
                         **deploy)
    return ref, port


def test_stack_rounds_matches_reference(R):
    rng = np.random.default_rng(8)
    _, batches = _mlp_setup(rng)
    want = R.engine.rounds.stack_rounds(lambda t: _jnp(batches[t]), 2, 4)
    got = stack_rounds(lambda t: _port(batches[t]), 2, 4)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _same_bits(g, w)


@pytest.mark.parametrize("noise", [False, True])
def test_run_segments_over_the_segment_runner_matches_reference(R, noise):
    """The reference's ``run_segments`` over its jitted runner and the
    port's over its plain one: the same segments, states and rows."""
    rng = np.random.default_rng(9)
    params, batches = _mlp_setup(rng)
    ref, port = _mlp_sessions(R, params, noise)
    key = jax.random.PRNGKey(SEED)
    # the reference's runner donates its state: compare each segment
    # before the next one is run
    want = R.engine.rounds.run_segments(
        ref.segment_runner(()), ref.train_state(),
        lambda t: _jnp(batches[t]), key, steps=ROUNDS, chunk=CHUNK)
    d_s = port.partition.d_shared()
    bits_at = ((lambda t: torch.from_numpy(reference_bits(
        SEED, t, N_MLP, d_s, partpsp=True))) if noise else None)
    runner = port.segment_runner(())
    assert port.segment_runner(()) is runner
    got = list(run_segments(runner, port.train_state(),
                            lambda t: _port(batches[t]), SEED, steps=ROUNDS,
                            chunk=CHUNK, bits_at=bits_at))
    assert [(t0, n) for t0, n, _, _ in got] == [(0, 3), (3, 3), (6, 1)]
    for (t0, n, st, traj), (ref_t0, ref_n, ref_st, ref_traj) in zip(got,
                                                                    want):
        assert (t0, n) == (ref_t0, ref_n)
        assert set(traj) == set(ref_traj)
        for k, v in ref_traj.items():
            _close(traj[k], v, 1e-4, 1e-5)
        _trees_close(st.dpps.push.s, ref_st.dpps.push.s, 1e-4, 1e-5)
        _trees_close(st.local, ref_st.local, 1e-4, 1e-5)
    # train() drives the same runner: the same rounds, bit for bit
    rep = port.train(ROUNDS, lambda t: _port(batches[t]), bits_at=bits_at)
    for k, v in got[-1][3].items():
        assert torch.equal(torch.as_tensor(rep.trajectory[k][-1:]),
                           v.detach().cpu()), k


def test_consensus_runner_and_step_fn_match_reference(R):
    rng = np.random.default_rng(10)
    params, batches = _mlp_setup(rng)
    ref, port = _mlp_sessions(R, params, noise=False)
    hooks = (object(),)
    assert port.consensus_runner(()) is port.consensus_runner(())
    assert port.consensus_runner(()) is not port.consensus_runner(hooks)
    vals = _np_tree(rng, N_MLP)
    ref_state, ref_traj = ref.consensus_runner(())(
        ref.consensus_state(_jnp(vals)), None, jax.random.PRNGKey(1),
        rounds=4)
    state, traj = port.consensus_runner(())(
        port.consensus_state(_port(vals)), None, rounds=4, seed=1)
    _trees_close(state.push.s, ref_state.push.s, 1e-5, 1e-6)
    for k, v in ref_traj.items():
        _close(traj[k], v, 1e-5, 1e-6)
    # one round of the per-round step, round 1's mixing operands bound
    want, ref_m = ref.step_fn(1)(ref.train_state(), _jnp(batches[0]),
                                 jax.random.PRNGKey(3))
    got, m = port.step_fn(1)(port.train_state(), _port(batches[0]), seed=3)
    for k in ("loss_mean", "grad_l1_max", "sensitivity_estimate"):
        _close(m[k], ref_m[k], 1e-4, 1e-5)
    _trees_close(got.dpps.push.s, want.dpps.push.s, 1e-4, 1e-5)
    _trees_close(got.local, want.local, 1e-4, 1e-5)


# -- 11-12. the configs and the trainers --------------------------------------

def test_all_configs_equal_reference(R):
    got, want = all_configs(), R.configs.all_configs()
    assert tuple(got) == tuple(want) == ARCH_NAMES
    for name, spec in got.items():
        assert spec is get_config(name)
        ref = want[name]
        assert dataclasses.asdict(spec.model) == dataclasses.asdict(ref.model)
        assert dataclasses.asdict(spec.smoke) == dataclasses.asdict(ref.smoke)
        assert tuple(spec.shared_rules) == tuple(ref.shared_rules)


TRAINER = dict(reduced=True, n_nodes=4, algorithm="partpsp", b=3.0,
               gamma_n=0.0, gamma_l=0.05, gamma_s=0.05, clip=100.0,
               topology="dout", degree=2, sync_interval=4, schedule="dense",
               seed=0)


def test_build_trainer_matches_reference(R):
    """The reference's trainer tuple on the reduced llama3.2-1b: the same
    topology, config and partition; the port's ``step`` from the
    reference's state (noise rate 0) one round to 1e-4 of its step."""
    (_, ref_cfg_model, ref_topo, ref_cfg, ref_part, ref_state,
     ref_step) = importlib.import_module(
        "repro.launch.train").build_trainer("llama3.2-1b", **TRAINER)
    model, cfg_model, topo, cfg, part, _, step = build_trainer(
        "llama3.2-1b", device="cpu", **TRAINER)
    assert dataclasses.asdict(cfg_model) == dataclasses.asdict(ref_cfg_model)
    assert np.array_equal(topo.weight_matrix(0), ref_topo.weight_matrix(0))
    assert (cfg.dpps.c_prime, cfg.dpps.lam, cfg.dpps.gamma_n) == (
        ref_cfg.dpps.c_prime, ref_cfg.dpps.lam, ref_cfg.dpps.gamma_n)
    assert part.describe() == ref_part.describe()
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, cfg_model.vocab_size, size=(4, 2, 16),
                          dtype=np.int32)
    want, ref_m = ref_step(ref_state, {"tokens": jnp.asarray(tokens)},
                           jax.random.PRNGKey(1))
    state = convert.partpsp_state_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_state), device="cpu")
    got, m = step(state, {"tokens": torch.from_numpy(tokens)}, seed=1)
    _close(m["loss_mean"], ref_m["loss_mean"], 1e-4, 1e-5)
    _trees_close(got.dpps.push.s, want.dpps.push.s, 1e-4, 1e-5)
    _trees_close(got.local, want.local, 1e-4, 1e-5)


def test_build_engine_trainer_drives_the_sessions_segments():
    """The engine tuple's ``run_chunk`` is the session's segment runner:
    two rounds of it equal ``Session.train(2)`` of the same build."""
    kw = dict(TRAINER, gamma_n=1e-7, device="cpu", chunk=2)
    (_, cfg_model, _, _, part, state, run_chunk,
     plan) = build_engine_trainer("llama3.2-1b", **kw)
    assert plan.chunk == 2 and part.d_shared() > 0
    rng = np.random.default_rng(13)
    tokens = [torch.from_numpy(rng.integers(
        0, cfg_model.vocab_size, size=(4, 2, 16), dtype=np.int32))
        for _ in range(2)]
    st, traj = run_chunk(state, lambda t: {"tokens": tokens[t]}, rounds=2,
                         seed=0)
    _, _, session = build_session("llama3.2-1b", **kw)
    rep = session.train(2, lambda t: {"tokens": tokens[t]})
    for k, v in traj.items():
        assert torch.equal(torch.as_tensor(rep.trajectory[k]), v), k
    for g, w in zip(TU.tree_leaves(st.local), TU.tree_leaves(rep.state.local)):
        assert torch.equal(g, w)


# -- 13. the attention functions ----------------------------------------------

H, K, D, DM = 4, 2, 64, 48


def _attn_inputs(R, seed):
    rng = np.random.default_rng(seed)
    params = {k: (rng.normal(size=shape) / np.sqrt(shape[0])).astype(
        np.float32) for k, shape in (("wq", (DM, H * D)), ("wk", (DM, K * D)),
                                     ("wv", (DM, K * D)),
                                     ("wo", (H * D, DM)))}
    x = rng.normal(size=(2, 9, DM)).astype(np.float32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    return params, x, pos


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("use_flash", [False, True])
def test_attention_train_matches_reference(R, window, use_flash):
    params, x, pos = _attn_inputs(R, 14)
    heads = dict(n_heads=H, n_kv_heads=K, head_dim=D, theta=10000.0,
                 window=window)
    want = R.models.attention.attention_train(
        _jnp(params), jnp.asarray(x), jnp.asarray(pos), **heads)
    got = A.attention_train(_port(params), torch.from_numpy(x),
                            torch.from_numpy(pos).long(), use_flash=use_flash,
                            **heads)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window", [None, 2])
def test_attention_decode_matches_reference(R, window):
    params, x, _ = _attn_inputs(R, 15)
    heads = dict(n_heads=H, n_kv_heads=K, head_dim=D, theta=500.0,
                 window=window)
    ref_cache = R.models.attention.init_kv_cache(2, 6, K, D, 1)
    cache = A.init_kv_cache(2, 6, K, D, 1, device="cpu")
    assert tuple(cache["k"].shape) == tuple(ref_cache["k"].shape)
    rk, rv = ref_cache["k"][0], ref_cache["v"][0]
    k, v = cache["k"][0], cache["v"][0]
    for p in range(4):
        want, rk, rv = R.models.attention.attention_decode(
            _jnp(params), jnp.asarray(x[:, p:p + 1]), jnp.int32(p), rk, rv,
            **heads)
        got, k2, v2 = A.attention_decode(_port(params),
                                         torch.from_numpy(x[:, p:p + 1]), p,
                                         k, v, **heads)
        assert k2 is k and v2 is v  # written in place
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(to_numpy(k), np.asarray(rk), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(to_numpy(v), np.asarray(rv), rtol=1e-5,
                                   atol=1e-5)


# -- the name walk -------------------------------------------------------------

def _reference_names():
    """(module, name) of every public function and class of src/repro and
    of every public method of such a class, by an AST walk."""
    src = ROOT / "src" / "repro"
    for path in sorted(src.rglob("*.py")):
        parts = path.relative_to(src).with_suffix("").parts
        mod = ".".join(p for p in parts if p != "__init__")
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or \
                    node.name.startswith("_"):
                continue
            yield mod, node.name
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, ast.FunctionDef) and \
                            not m.name.startswith("_"):
                        yield mod, f"{node.name}.{m.name}"


def _resolve(dotted: str):
    """The port's object at ``repro_torch.<dotted>``, or None."""
    parts = dotted.split(".") if dotted else []
    for cut in range(len(parts), -1, -1):
        try:
            obj = importlib.import_module(
                ".".join(["repro_torch"] + parts[:cut]))
        except ImportError:
            continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr, None)
            if obj is None:
                return None
        return obj
    return None


def _readme_map() -> dict[str, list[str]]:
    """The README's map: reference name -> the port names of its row."""
    text = (ROOT / "README.md").read_text()
    section = text.split("### The reference's names in the port", 1)[1]
    section = section.split("\n### ", 1)[0]
    rows = {}
    for line in section.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) != 3 or not cells[0].startswith("`"):
            continue
        port = re.findall(r"`([\w.]+)`", cells[1])
        for name in re.findall(r"`([\w.]+)`", cells[0]):
            rows[name] = port
    return rows


def test_every_reference_name_is_ported_or_mapped():
    mapped = _readme_map()
    assert mapped, "the README's name map is missing"
    missing = []
    for mod, name in _reference_names():
        dotted = f"{mod}.{name}" if mod else name
        if _resolve(dotted) is not None:
            continue
        prefixes = [".".join(dotted.split(".")[:i])
                    for i in range(len(dotted.split(".")), 0, -1)]
        if not any(p in mapped for p in prefixes):
            missing.append(dotted)
    assert not missing, f"neither ported nor in the README's map: {missing}"
    for name, port in mapped.items():
        assert _resolve(name) is None, \
            f"the README maps {name}, which the port has under its name"
        for target in port:
            assert _resolve(target) is not None, \
                f"the README's port name {target} (for {name}) does not import"
