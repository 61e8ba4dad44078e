"""The slice as a whole: the port's Session against the reference's.

``Session.run`` (DPPS consensus, dense and circulant schedules) and
``Session.train`` (PartPSP on a narrow paper MLP, dense) run 7 rounds with
sync interval 5 and chunk 3 on both sides, so segment boundaries and a
sync round are crossed.
Noise off is compared with the reference's plain path; noise on with its
Pallas path in interpret mode, the port fed the reference's exact bits
through ``bits_at``. Initial parameters and batches come from the
reference and cross with :mod:`repro_torch.convert`.

Tolerances: consensus state to rtol 1e-5 / atol 1e-6 (f32 sums in another
order). Training to rtol 1e-4 / atol 1e-5: the gradients of tanh layers
pass the last-ulp differences of the forward pass on, and seven rounds
of that compound.
"""
from __future__ import annotations

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import load_reference, reference_bits, to_numpy

from repro_torch.api import PrivacySpec, Session
from repro_torch.convert import tree_from_numpy
from repro_torch.core import topology as T
from repro_torch.core.tree_utils import tree_leaves
from repro_torch.models.mlp import PARTITIONS, mlp_loss

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_CONS, N_TRAIN, SEED = 5, 6, 2024
ROUNDS, SYNC, CHUNK = 7, 5, 3
D_IN, HIDDEN, N_CLASSES, BATCH = 32, 10, 10, 32


@pytest.fixture(scope="module")
def R():
    return load_reference()


def _close(got, want, rtol, atol):
    # Plus an absolute term of 1e-6 of the array's largest magnitude: with
    # the noise on, an element near zero is the difference of mixed terms
    # hundreds of times larger, and carries their f32 rounding error.
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


def _check_report(rep, ref_rep, rtol, atol):
    assert rep.rounds == ref_rep.rounds == ROUNDS
    assert rep.epsilon_spent == ref_rep.epsilon_spent
    assert set(rep.trajectory) == set(ref_rep.trajectory)
    for k, v in ref_rep.trajectory.items():
        assert rep.trajectory[k].shape == v.shape, k
        _close(rep.trajectory[k], v, rtol, atol)
    assert rep.wall_clock >= rep.compile_s >= 0


def _check_dpps_state(st, ref_st, rtol, atol):
    assert st.t == int(ref_st.t) == ROUNDS
    _trees_close(st.push.s, ref_st.push.s, rtol, atol)
    _close(st.push.a, ref_st.push.a, rtol, atol)
    _close(st.sens.s_local, ref_st.sens.s_local, rtol, atol)
    _close(st.sens.prev_noise_l1, ref_st.sens.prev_noise_l1, rtol, atol)


# -- consensus ---------------------------------------------------------------

@pytest.mark.parametrize("noise,schedule", [
    (False, "dense"), (True, "dense"), (False, "circulant"),
    (True, "circulant")])
def test_session_run_matches_reference(R, noise, schedule):
    rng = np.random.default_rng(0)
    vals = {"w": rng.normal(size=(N_CONS, 40, 3)).astype(np.float32),
            "b": rng.normal(size=(N_CONS, 7)).astype(np.float32)}
    d_s = 127
    eps = [{"w": 0.05 * rng.normal(size=(N_CONS, 40, 3)).astype(np.float32),
            "b": np.zeros((N_CONS, 7), np.float32)} for _ in range(ROUNDS)]
    privacy = dict(b=2.0, gamma_n=0.02, noise=noise)
    deploy = dict(schedule=schedule, sync_interval=SYNC, chunk=CHUNK,
                  seed=SEED)
    ref_session = R.api.Session.build(
        R.core.topology.DOutGraph(N_CONS, 2),
        privacy=R.api.PrivacySpec(**privacy), use_kernels=noise, **deploy)
    ref_rep = ref_session.run(
        ROUNDS, values=jax.tree_util.tree_map(jnp.asarray, vals),
        eps_at=lambda t: jax.tree_util.tree_map(jnp.asarray, eps[t]))

    session = Session.build(T.DOutGraph(N_CONS, 2),
                            privacy=PrivacySpec(**privacy), device="cpu",
                            **deploy)
    assert (session.cfg.c_prime, session.cfg.lam) == (
        ref_session.cfg.c_prime, ref_session.cfg.lam)
    assert session.plan.schedule == ref_session.plan.schedule == schedule
    bits_at = ((lambda t: torch.from_numpy(
        reference_bits(SEED, t, N_CONS, d_s))) if noise else None)
    rep = session.run(ROUNDS, values=tree_from_numpy(vals, device="cpu"),
                      eps_at=lambda t: tree_from_numpy(eps[t], device="cpu"),
                      bits_at=bits_at)
    _check_report(rep, ref_rep, 1e-5, 1e-6)
    _check_dpps_state(rep.state, ref_rep.state, 1e-5, 1e-6)
    _trees_close(session.consensus(rep.state),
                 ref_session.consensus(ref_rep.state), 1e-5, 1e-6)
    if noise:
        assert rep.trajectory["noise_l1_mean"].min() > 0


def test_session_run_resumes_the_same_noise_stream():
    """Round t's noise is a function of (seed, t, node): one 7-round run
    equals 4 rounds then 3 more from the returned state."""
    vals = {"x": torch.randn((4, 300), generator=torch.Generator()
                             .manual_seed(0))}
    session = Session.build(T.DOutGraph(4, 2), privacy=PrivacySpec(
        b=1.0, gamma_n=0.01), schedule="dense", sync_interval=SYNC,
        chunk=CHUNK, device="cpu", seed=3)
    whole = session.run(ROUNDS, values=vals)
    part = session.run(4, values=vals)
    rest = session.run(ROUNDS - 4, state=part.state)
    torch.testing.assert_close(rest.state.push.s["x"],
                               whole.state.push.s["x"], rtol=0, atol=0)
    np.testing.assert_array_equal(
        np.concatenate([part.trajectory["sensitivity_used"],
                        rest.trajectory["sensitivity_used"]]),
        whole.trajectory["sensitivity_used"])
    assert rest.epsilon_spent + part.epsilon_spent == whole.epsilon_spent


# -- PartPSP training --------------------------------------------------------

def _ref_mlp_loss(p, batch, key):
    """The reference-side paper MLP loss (``benchmarks/common.py``), at a
    narrow input width."""
    x, y = batch
    h = jnp.tanh(x @ p["l1"])
    h = jnp.tanh(h @ p["l2"])
    logp = jax.nn.log_softmax(h @ p["l3"])
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


def _ref_init_mlp(key):
    k1, k2, k3 = jax.random.split(key, 3)
    s = lambda k, shape: jax.random.normal(k, shape) / jnp.sqrt(shape[0])
    return {"l1": s(k1, (D_IN, HIDDEN)), "l2": s(k2, (HIDDEN, D_IN)),
            "l3": s(k3, (D_IN, N_CLASSES))}


@pytest.mark.parametrize("noise", [False, True])
def test_session_train_matches_reference(R, noise):
    key = jax.random.PRNGKey(SEED)
    params = jax.tree_util.tree_map(np.asarray, _ref_init_mlp(key))
    task = R.data.SyntheticClassification(d_in=D_IN, n_classes=N_CLASSES,
                                          seed=SEED)
    skew = R.data.dirichlet_partition(N_TRAIN, N_CLASSES, seed=SEED)
    batches = [jax.tree_util.tree_map(np.asarray, task.node_batches(
        jax.random.fold_in(jax.random.PRNGKey(SEED + 1), t), N_TRAIN, BATCH,
        skew)) for t in range(ROUNDS)]
    privacy = dict(b=1.0, gamma_n=0.005, noise=noise)
    deploy = dict(algorithm="partpsp", gamma_l=0.1, gamma_s=0.1, clip=100.0,
                  schedule="dense", sync_interval=SYNC, chunk=CHUNK,
                  seed=SEED, partition=PARTITIONS["partpsp-1"])
    ref_session = R.api.Session.build(
        R.core.topology.DOutGraph(N_TRAIN, 2),
        privacy=R.api.PrivacySpec(**privacy), model=_ref_mlp_loss,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        use_kernels=noise, **deploy)
    ref_rep = ref_session.train(ROUNDS, lambda t: jax.tree_util.tree_map(
        jnp.asarray, batches[t]))

    session = Session.build(T.DOutGraph(N_TRAIN, 2),
                            privacy=PrivacySpec(**privacy), model=mlp_loss,
                            params=tree_from_numpy(params, device="cpu"),
                            device="cpu",
                            **deploy)
    d_s = session.partition.d_shared()
    assert d_s == ref_session.partition.d_shared() == D_IN * HIDDEN
    bits_at = ((lambda t: torch.from_numpy(reference_bits(
        SEED, t, N_TRAIN, d_s, partpsp=True))) if noise else None)
    rep = session.train(ROUNDS,
                        lambda t: tree_from_numpy(batches[t], device="cpu"),
                        bits_at=bits_at)
    _check_report(rep, ref_rep, 1e-4, 1e-5)
    _check_dpps_state(rep.state.dpps, ref_rep.state.dpps, 1e-4, 1e-5)
    _trees_close(rep.state.local, ref_rep.state.local, 1e-4, 1e-5)
    _trees_close(session.consensus_view(rep.state, 2),
                 ref_session.consensus_view(ref_rep.state, 2), 1e-4, 1e-5)
    losses = rep.trajectory["loss_mean"]
    assert np.all(np.isfinite(losses))


# -- guards ------------------------------------------------------------------

def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_session_build_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Session.build(T.DOutGraph(4, 2))
    with pytest.raises(ValueError, match="use_kernels=True"):
        Session.build(T.DOutGraph(4, 2), device="cpu", use_kernels=True)
    session = Session.build(T.DOutGraph(4, 2), device="cpu")
    assert session.plan.use_kernels is False and session.device.type == "cpu"
