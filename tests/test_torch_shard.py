"""The sharded engine (``repro_torch.engine.shard``) in a 4-rank gloo world
against the reference's ``shard_run_dpps`` / ``shard_run_partpsp`` on the 4
host devices ``tests/conftest.py`` forces, and against the port's own
single-process engine.

One world serves the module: :func:`world` spawns 4 ranks once (spawn
start method, ``file://`` store in a temporary directory, a process-group
timeout and a wall limit on the join, so a hung collective fails the
module's tests and cannot hold the suite), each rank runs every case of
:func:`rank_main` and saves what it got; the tests read the saved results.
This module imports JAX only inside fixtures, so the spawned ranks import
torch and the port alone.

Sizes are the reference's own sharded-engine tests' (``tests/
test_engine.py``): N = 8 nodes, T = 6 rounds, ``DOutGraph(d=3)`` for
DPPS and ``DOutGraph(d=2)`` for PartPSP, sync every 3 rounds. Tolerances:
noiseless runs against the reference as the reference holds its sharded
run to its single-device one (atol 1e-5 on the state, rtol 1e-5 on
``sensitivity_estimate``). Noised runs against the port's single-process
engine: the noise is keyed by global node, so the circulant and sparse
runs (elementwise arithmetic, the same on a row block) are bit for bit;
the dense run multiplies a (B, N) row block of W on the CPU's BLAS, which
may block the product otherwise than the (N, N) one, so its state is held
to 1e-6 relative (a last-ulp difference a round over 6 rounds), its
sensitivity rows likewise.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import time

import numpy as np
import pytest
import torch

N, T, WORLD = 8, 6, 4
D_IN, HIDDEN, CLASSES, PER_NODE = 12, 8, 4, 6
SEED = 2024
SCHEDULES = ("dense", "circulant", "sparse")
JOIN_LIMIT_S = 240
PG_TIMEOUT_S = 60


# -- inputs shared by the ranks and the reference ------------------------------

def dpps_inputs() -> tuple[list, list]:
    """s0 leaves (N, 11), (N, 2, 3) and their (T, ...) perturbations."""
    rng = np.random.default_rng(SEED)
    s0 = [rng.normal(size=(N, 11)).astype(np.float32),
          rng.normal(size=(N, 2, 3)).astype(np.float32)]
    eps = [0.1 * rng.normal(size=(T,) + x.shape).astype(np.float32)
           for x in s0]
    return s0, eps


def mlp_inputs() -> tuple[dict, tuple]:
    """Node-stacked MLP params (l1 shared, l2 local) and (T, N, ...) batches."""
    rng = np.random.default_rng(SEED + 1)
    params = {"l1": rng.normal(size=(D_IN, HIDDEN)).astype(np.float32) / 3,
              "l2": rng.normal(size=(HIDDEN, CLASSES)).astype(np.float32) / 3}
    stacked = {k: np.broadcast_to(v, (N,) + v.shape).copy()
               for k, v in params.items()}
    x = rng.normal(size=(T, N, PER_NODE, D_IN)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=(T, N, PER_NODE)).astype(np.int32)
    return stacked, (x, y)


def mlp_loss(p, batch):
    """Per-node NLL of ``tanh(x l1) l2`` over node-stacked params -> (N,)."""
    x, y = batch
    logits = torch.tanh(x @ p["l1"]) @ p["l2"]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, y.long()[..., None])[..., 0].mean(dim=-1)


def expected_collectives(plan, block: int, width: int, partpsp: bool) -> dict:
    """Per rank and round (no sync): the calls and operand bytes the code
    issues. Dense and sparse: one all-gather of the (B, width) buffer and
    one of ``a``; circulant: a send for each block exchange of each roll
    (a whole-block shift q and, for a remainder, q + 1; none to itself),
    for the buffer and for ``a``. All: the five node reductions of the
    DPPS round (sensitivity max; eps max, noise mean, a min, a max), two
    more for PartPSP (loss mean, gradient max), 4 bytes each."""
    reductions = 7 if partpsp else 5
    out = {"all-reduce": (reductions, 4 * reductions)}
    if plan.schedule == "circulant":
        sends = 0
        for off in plan.offsets:
            q, r = divmod(off % (block * WORLD), block)
            sends += (q % WORLD != 0) + (r != 0 and (q + 1) % WORLD != 0)
        out["collective-permute"] = (2 * sends,
                                     sends * 4 * block * (width + 1))
    else:
        out["all-gather"] = (2, 4 * block * (width + 1))
    return out


# -- what each rank runs -------------------------------------------------------

def _dpps_case(mesh, schedule, *, noise: bool, sync: int, rounds: int = T,
               count=contextlib.nullcontext()):
    from repro_torch import engine
    from repro_torch.core import topology as T_mod
    from repro_torch.core.dpps import DPPSConfig, dpps_init
    from repro_torch.launch.sharding import gather_rows, shard_rows

    topo = T_mod.DOutGraph(N, 3)
    cp, lam = T_mod.calibrate_constants(topo)
    cfg = DPPSConfig(noise=noise, gamma_n=0.02 if noise else 0.0, b=5.0,
                     c_prime=cp, lam=lam, sync_interval=sync,
                     schedule=schedule)
    plan = engine.ProtocolPlan.from_topology(
        topo, mesh=mesh, schedule=schedule, use_kernels=False,
        sync_interval=sync, device="cpu")
    s0, eps = dpps_inputs()
    state = dpps_init([torch.from_numpy(x) for x in s0],
                      plan.resolve_dpps(cfg))
    rows = shard_rows(state, mesh)
    eps_t = [torch.from_numpy(e) for e in eps]
    eps_at = lambda t: shard_rows([e[t] for e in eps_t], mesh)
    with count:
        final, traj = engine.shard_run_dpps(mesh, rows, eps_at, cfg=cfg,
                                            plan=plan, rounds=rounds,
                                            seed=SEED)
    whole = gather_rows(final, mesh)
    out = {"s": [x.clone() for x in whole.push.s], "a": whole.push.a,
           "s_local": whole.sens.s_local,
           "prev_noise_l1": whole.sens.prev_noise_l1,
           "traj": {k: v for k, v in traj.items()}}
    if noise:  # the port's single-process engine on the same inputs
        single, straj = engine.run_dpps(
            state, lambda t: [e[t] for e in eps_t], cfg=cfg, plan=plan,
            rounds=rounds, seed=SEED)
        out["single"] = {"s": list(single.push.s), "a": single.push.a,
                         "s_local": single.sens.s_local,
                         "traj": {k: straj[k] for k in traj}}
    return out


def _partpsp_case(mesh, count=contextlib.nullcontext(), rounds: int = T):
    from repro_torch import engine
    from repro_torch.core import topology as T_mod
    from repro_torch.core.partition import Partition
    from repro_torch.core.partpsp import make_baseline_config, partpsp_init
    from repro_torch.launch.sharding import gather_rows, shard_rows

    topo = T_mod.DOutGraph(N, 2)
    cp, lam = T_mod.calibrate_constants(topo)
    cfg = make_baseline_config("sgp", c_prime=cp, lam=lam, sync_interval=3)
    plan = engine.ProtocolPlan.from_topology(
        topo, mesh=mesh, use_kernels=False, sync_interval=3, device="cpu")
    stacked, (x, y) = mlp_inputs()
    params = {k: torch.from_numpy(v) for k, v in stacked.items()}
    part = Partition.from_rules(params, (("l1", "shared"),), default="local")
    state = partpsp_init(params, part, plan.resolve_partpsp(cfg))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    batch_at = lambda t: shard_rows((xt[t], yt[t]), mesh)
    kw = dict(cfg=cfg, partition=part, loss_fn=mlp_loss, plan=plan,
              rounds=rounds, seed=SEED)
    with count:
        final, traj = engine.shard_run_partpsp(
            mesh, shard_rows(state, mesh), batch_at, **kw)
    whole = gather_rows(final, mesh)
    single, _ = engine.run_partpsp(state, lambda t: (xt[t], yt[t]), **kw)
    return {"s": list(whole.dpps.push.s), "local": list(whole.local),
            "traj": dict(traj), "single_s": list(single.dpps.push.s),
            "single_local": list(single.local)}


def _rejections(mesh) -> dict:
    """The message of each refusal, in this world."""
    from repro_torch import engine
    from repro_torch.core import topology as T_mod
    from repro_torch.core.dpps import DPPSConfig, dpps_init
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import shard_rows

    out = {}

    def caught(name, fn):
        try:
            fn()
        except (ValueError, NotImplementedError, RuntimeError) as e:
            out[name] = f"{type(e).__name__}: {e}"
        else:
            out[name] = "no error"

    cfg = DPPSConfig(noise=False, gamma_n=0.0)
    # six nodes over four ranks
    topo6 = T_mod.DOutGraph(6, 2)
    plan6 = engine.ProtocolPlan.from_topology(topo6, schedule="dense",
                                              use_kernels=False,
                                              device="cpu")
    st6 = dpps_init([torch.zeros((6, 4))], cfg)
    caught("indivisible", lambda: engine.shard_run_dpps(
        mesh, st6, None, cfg=cfg, plan=plan6, rounds=1))
    caught("indivisible_plan", lambda: engine.ProtocolPlan.from_topology(
        topo6, mesh=mesh, device="cpu"))
    caught("production_mesh", make_production_mesh)
    from repro_torch.net import FaultModel

    topo = T_mod.DOutGraph(N, 3)
    faulted = engine.ProtocolPlan.from_topology(
        topo, faults=FaultModel(drop_rate=0.2), use_kernels=False,
        device="cpu")
    st = shard_rows(dpps_init([torch.zeros((N, 4))], cfg), mesh)
    caught("faults", lambda: engine.shard_run_dpps(
        mesh, st, None, cfg=cfg, plan=faulted, rounds=1))
    return out


def _layout(mesh) -> dict:
    """What a rank holds of a PartPSP state and of a loader's batch."""
    from repro_torch.core.partition import Partition
    from repro_torch.core.partpsp import PartPSPConfig, partpsp_init
    from repro_torch.core.tree_utils import tree_leaves
    from repro_torch.data import NodeShardedLoader, SyntheticLMStream
    from repro_torch.launch.sharding import (node_rows, shard_rows,
                                             train_batch_shardings,
                                             train_state_shardings)

    stacked, _ = mlp_inputs()
    params = {k: torch.from_numpy(v) for k, v in stacked.items()}
    part = Partition.from_rules(params, (("l1", "shared"),), default="local")
    state = partpsp_init(params, part, PartPSPConfig())
    spec = tree_leaves(train_state_shardings(state, mesh))
    stream = SyntheticLMStream(vocab_size=32, seq_len=8, n_nodes=N,
                               device="cpu")
    whole = NodeShardedLoader(stream, per_node_batch=2, seed=3).batch_at(1)
    mine = NodeShardedLoader(stream, per_node_batch=2, seed=3,
                             mesh=mesh).batch_at(1)
    rows = node_rows(mesh, N)
    return {
        "state": [None if x is None else (x.start, x.stop) for x in spec],
        "state_rows": [tuple(x.shape) for x in tree_leaves(
            shard_rows(state, mesh)) if isinstance(x, torch.Tensor)],
        "batch": [(x.start, x.stop) for x in tree_leaves(
            train_batch_shardings(whole, mesh))],
        "batch_equal": all(torch.equal(mine[k], whole[k][rows])
                           for k in whole)}


def rank_main(rank: int, store: str, out_dir: str) -> None:
    """One rank of the world: every case, its results saved for the tests."""
    import torch.distributed as dist

    from repro_torch.launch.op_analysis import CostMode
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cpu", (WORLD, 1),
                                mesh_dim_names=("data", "model"))
        results = {"noiseless": {}, "noised": {}, "collectives": {}}
        for schedule in SCHEDULES:
            results["noiseless"][schedule] = _dpps_case(
                mesh, schedule, noise=False, sync=3)
            results["noised"][schedule] = _dpps_case(
                mesh, schedule, noise=True, sync=0)
            count = CostMode(torch.device("cpu"))
            _dpps_case(mesh, schedule, noise=False, sync=0, rounds=1,
                       count=count)
            results["collectives"][schedule] = {
                k: (int(count.coll_calls[k]), int(count.coll[k]))
                for k in count.coll_calls}
        results["partpsp"] = _partpsp_case(mesh)
        count = CostMode(torch.device("cpu"))
        _partpsp_case(mesh, count=count, rounds=1)
        results["collectives"]["partpsp"] = {
            k: (int(count.coll_calls[k]), int(count.coll[k]))
            for k in count.coll_calls}
        results["rejections"] = _rejections(mesh)
        results["layout"] = _layout(mesh)
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- the world -----------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's saved results, from one spawned 4-rank world."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("shard_world")
    store = str(tmp / "store")
    t0 = time.monotonic()
    ctx = mp.start_processes(rank_main, args=(store, str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=max(1.0, JOIN_LIMIT_S -
                                       (time.monotonic() - t0))):
            if time.monotonic() - t0 > JOIN_LIMIT_S:
                pytest.fail(f"the 4-rank world did not finish in "
                            f"{JOIN_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def R():
    from test_torch_reference import load_reference

    return load_reference()


def _ref_mesh():
    import jax
    from jax.sharding import Mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 forced host devices (see conftest XLA_FLAGS)")
    return Mesh(np.asarray(jax.devices()[:4]).reshape(4, 1),
                ("data", "model"))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _leaves_close(got, want, atol, rtol=1e-6):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=atol, rtol=rtol)


# -- noiseless runs against the reference's sharded engine ----------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_dpps_matches_reference_noiseless(world, R, schedule):
    import jax
    import jax.numpy as jnp

    mesh = _ref_mesh()
    core = R.core
    topo = core.topology.DOutGraph(n_nodes=N, d=3)
    cp, lam = core.topology.calibrate_constants(topo)
    cfg = core.dpps.DPPSConfig(noise=False, gamma_n=0.0, c_prime=cp,
                               lam=lam, sync_interval=3, schedule=schedule)
    plan = R.engine.ProtocolPlan.from_topology(
        topo, mesh=mesh, schedule=schedule, use_kernels=False,
        sync_interval=3)
    s0, eps = dpps_inputs()
    ref, traj = R.engine.shard_run_dpps(
        mesh, core.dpps.dpps_init([jnp.asarray(x) for x in s0],
                                  plan.resolve_dpps(cfg)),
        [jnp.asarray(e) for e in eps], jax.random.PRNGKey(42), cfg=cfg,
        plan=plan)
    got = world[0]["noiseless"][schedule]
    _leaves_close(got["s"], ref.push.s, atol=1e-5)
    np.testing.assert_allclose(_np(got["a"]), np.asarray(ref.push.a),
                               atol=1e-5)
    np.testing.assert_allclose(_np(got["traj"]["sensitivity_estimate"]),
                               np.asarray(traj["sensitivity_estimate"]),
                               rtol=1e-5)
    assert set(got["traj"]) == set(traj)  # per-node series dropped on both
    assert "sensitivity_local" not in got["traj"]


def test_sharded_partpsp_matches_reference_noiseless(world, R):
    import jax
    import jax.numpy as jnp

    mesh = _ref_mesh()
    core = R.core
    topo = core.topology.DOutGraph(n_nodes=N, d=2)
    cp, lam = core.topology.calibrate_constants(topo)
    cfg = core.partpsp.make_baseline_config("sgp", c_prime=cp, lam=lam,
                                            sync_interval=3)
    plan = R.engine.ProtocolPlan.from_topology(topo, mesh=mesh,
                                               use_kernels=False,
                                               sync_interval=3)
    stacked, (x, y) = mlp_inputs()
    stacked = {k: jnp.asarray(v) for k, v in stacked.items()}
    part = core.partition.Partition.from_rules(stacked, (("l1", "shared"),),
                                               default="local")

    def loss_fn(p, batch, k):
        xb, yb = batch
        logp = jax.nn.log_softmax(jnp.tanh(xb @ p["l1"]) @ p["l2"])
        return -jnp.mean(jnp.take_along_axis(logp, yb[:, None], axis=1))

    state0 = core.partpsp.partpsp_init(stacked, part,
                                       plan.resolve_partpsp(cfg))
    ref, traj = R.engine.shard_run_partpsp(
        mesh, state0, (jnp.asarray(x), jnp.asarray(y)), jax.random.PRNGKey(9),
        cfg=cfg, partition=part, loss_fn=loss_fn, plan=plan)
    got = world[0]["partpsp"]
    _leaves_close(got["s"], ref.dpps.push.s, atol=1e-5)
    _leaves_close(got["local"], ref.local, atol=1e-5)
    assert "loss_per_node" not in got["traj"] and "loss_per_node" not in traj
    assert set(got["traj"]) == set(traj)


def test_sharded_runs_match_the_single_process_engine_noiseless(world):
    """The same 4-rank runs against the port's own single-process engine
    (PartPSP; DPPS's noised cases below take the same path)."""
    got = world[0]["partpsp"]
    _leaves_close(got["s"], got["single_s"], atol=1e-6)
    _leaves_close(got["local"], got["single_local"], atol=1e-6)


# -- noised runs against the port's single-process engine ------------------------

@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_noised_dpps_matches_single_process(world, schedule):
    got = world[0]["noised"][schedule]
    want = got["single"]
    assert float(got["traj"]["noise_l1_mean"].min()) > 0
    if schedule == "dense":  # BLAS on a (B, N) row block: see the docstring
        _leaves_close(got["s"], want["s"], atol=0, rtol=1e-6)
        np.testing.assert_allclose(_np(got["a"]), _np(want["a"]), rtol=1e-6)
        for k in ("sensitivity_used", "sensitivity_estimate"):
            np.testing.assert_allclose(_np(got["traj"][k]),
                                       _np(want["traj"][k]), rtol=1e-6)
        return
    for g, w in zip(got["s"], want["s"]):
        assert torch.equal(g, w)
    assert torch.equal(got["a"], want["a"])
    assert torch.equal(got["s_local"], want["s_local"])
    for k in ("sensitivity_used", "sensitivity_estimate", "eps_l1_max",
              "a_min", "a_max"):
        assert torch.equal(got["traj"][k], want["traj"][k]), k


def test_every_rank_holds_the_same_rows_and_scalars(world):
    for r in range(1, WORLD):
        for case in ("noiseless", "noised"):
            for schedule in SCHEDULES:
                a, b = world[0][case][schedule], world[r][case][schedule]
                for g, w in zip(a["s"], b["s"]):
                    assert torch.equal(g, w)
                for k, v in a["traj"].items():
                    assert torch.equal(v, b["traj"][k]), (case, schedule, k)


# -- the collectives a round lowers to -----------------------------------------

@pytest.mark.parametrize("schedule", SCHEDULES + ("partpsp",))
def test_one_round_lowers_to_the_collectives(world, schedule):
    from repro_torch import engine
    from repro_torch.core import topology as T_mod

    if schedule == "partpsp":
        plan = engine.ProtocolPlan.from_topology(
            T_mod.DOutGraph(N, 2), use_kernels=False, device="cpu")
        width = D_IN * HIDDEN  # the shared l1, packed at lane 1
    else:
        plan = engine.ProtocolPlan.from_topology(
            T_mod.DOutGraph(N, 3), schedule=schedule, use_kernels=False,
            device="cpu")
        width = 11 + 6
    want = expected_collectives(plan, N // WORLD, width,
                                partpsp=schedule == "partpsp")
    marker = "collective-permute" if plan.schedule == "circulant" \
        else "all-gather"
    for r in range(WORLD):
        got = world[r]["collectives"][schedule]
        assert got == want, (r, got, want)
        assert marker in got and "all-reduce" in got


# -- refusals -------------------------------------------------------------------

def test_refusals_in_the_world(world):
    rej = world[0]["rejections"]
    assert rej["indivisible"] == ("ValueError: node count 6 must divide "
                                  "evenly over 4 gossip shards")
    assert rej["indivisible_plan"] == ("ValueError: n_nodes=6 not divisible "
                                       "by the mesh's 4 gossip shards")
    assert rej["production_mesh"].startswith(
        "RuntimeError: mesh (16, 16) needs 256 devices, have 4")
    assert rej["faults"].startswith(
        "NotImplementedError: fault injection (ProtocolPlan.dynamic")


def test_each_rank_holds_its_rows_and_the_scalars_whole(world):
    """A PartPSPState's leaves in tree order: the shared l1, a, s_local,
    prev_noise_l1 node-stacked; c_prime, lam and t replicated; the local
    l2 node-stacked. A loader with the mesh yields the rank's rows of the
    batch every rank draws."""
    block = N // WORLD
    for r in range(WORLD):
        lay = world[r]["layout"]
        rows = (r * block, (r + 1) * block)
        assert lay["state"] == [rows, rows, rows, rows, None, None, None,
                                rows]
        assert lay["state_rows"] == [(block, D_IN, HIDDEN), (block,),
                                     (block,), (block,), (), (),
                                     (block, HIDDEN, CLASSES)]
        assert lay["batch"] and all(x == rows for x in lay["batch"])
        assert lay["batch_equal"]


def test_train_plan_takes_its_node_count_from_a_mesh():
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train_plan

    class FourNodes:
        mesh_dim_names = ("data", "model")
        shape = (4, 2)

    plan = build_train_plan(get_config("llama3.2-1b"), FourNodes())
    assert plan.n_nodes == 4
    assert all(x.shape[0] == 4 for x in plan.batch_specs.values())
    assert build_train_plan(get_config("llama3.2-1b"), 4).n_nodes == 4


def test_session_checks_the_mesh_divides_the_nodes(R):
    """``Session.build(mesh=)`` passes the mesh to the plan, which refuses
    a node count the gossip shards do not divide, as the reference's."""
    from repro_torch.api import Session
    from repro_torch.core import topology as T_mod

    class FourNodes:
        mesh_dim_names = ("data", "model")
        shape = (4, 1)

    want = _message(lambda: R.api.Session.build(
        R.core.topology.DOutGraph(6, 2), mesh=_ref_mesh()))
    assert _message(lambda: Session.build(
        T_mod.DOutGraph(6, 2), mesh=FourNodes(), device="cpu")) == want
    session = Session.build(T_mod.DOutGraph(N, 2), mesh=FourNodes(),
                            device="cpu")
    assert session.n_nodes == N


class _Mesh:
    """A mesh with two gossip axes, which the engine refuses before it
    touches a process group."""

    mesh_dim_names = ("pod", "data", "model")
    shape = (2, 2, 1)


def _message(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    raise AssertionError("no error")


def test_refusal_messages_match_the_reference(R):
    import importlib

    import jax
    from jax.sharding import Mesh

    from repro_torch import engine
    from repro_torch.core import topology as T_mod
    from repro_torch.core.dpps import DPPSConfig, dpps_init, dpps_step
    from repro_torch.engine import rounds as port_rounds
    from repro_torch.engine import shard as port_shard
    from repro_torch.net import DelayModel, FaultModel
    from repro_torch.wire import Bf16Codec, Int8StochasticCodec

    ref_shard = importlib.import_module("repro.engine.shard")
    ref_rounds = importlib.import_module("repro.engine.rounds")
    ref_dpps = R.core.dpps
    topo, ref_topo = T_mod.DOutGraph(N, 2), R.core.topology.DOutGraph(N, 2)
    ref_plan = lambda **kw: R.engine.ProtocolPlan.from_topology(
        ref_topo, use_kernels=False, **kw)
    port_plan = lambda **kw: engine.ProtocolPlan.from_topology(
        topo, use_kernels=False, device="cpu", **kw)

    # sensitivity_mode="real", an indivisible node count
    for mode_kw, n in ((dict(sensitivity_mode="real"), N), ({}, 6)):
        assert _message(lambda: port_shard._check_cfg(
            DPPSConfig(**mode_kw), n, WORLD)) == _message(
            lambda: ref_shard._check_cfg(ref_dpps.DPPSConfig(**mode_kw), n,
                                         WORLD))
    # a fault-masked plan
    assert _message(lambda: port_shard._check_cfg(
        DPPSConfig(), N, WORLD, port_plan(faults=FaultModel(drop_rate=0.2)))
    ) == _message(lambda: ref_shard._check_cfg(
        ref_dpps.DPPSConfig(), N, WORLD,
        ref_plan(faults=R.net.faults.FaultModel(drop_rate=0.2))))
    # a wire codec, and the bf16 wire (a codec of its own)
    for port_codec, ref_codec in (
            (Int8StochasticCodec(), R.wire.Int8StochasticCodec()),
            (Bf16Codec(), R.wire.Bf16Codec())):
        assert _message(lambda: port_shard._check_cfg(
            DPPSConfig(), N, WORLD, port_plan(wire=port_codec))) == _message(
            lambda: ref_shard._check_cfg(ref_dpps.DPPSConfig(), N, WORLD,
                                         ref_plan(wire=ref_codec)))
    # the seams: faults and delays beside a gossip builder
    st = dpps_init([torch.zeros((N, 4))], DPPSConfig(noise=False))
    builder = lambda mix: None
    faulted = port_plan(faults=FaultModel(drop_rate=0.2))
    assert _message(lambda: port_rounds.run_dpps(
        st, None, cfg=DPPSConfig(noise=False), plan=faulted, rounds=1,
        _gossip_builder=builder)) == _message(
        lambda: ref_rounds._check_dynamic(
            ref_plan(faults=R.net.faults.FaultModel(drop_rate=0.2)), builder))
    delayed = port_plan(schedule="dense", delays=DelayModel(max_delay=2))
    ref_delayed = ref_plan(schedule="dense",
                           delays=R.net.delays.DelayModel(max_delay=2))
    assert _message(lambda: port_rounds.run_dpps(
        st, None, cfg=DPPSConfig(noise=False), plan=delayed, rounds=1,
        _gossip_builder=builder)) == _message(
        lambda: ref_rounds._check_async(
            ref_delayed, builder, ref_delayed.resolve_dpps(
                ref_dpps.DPPSConfig())))
    # the bf16 wire beside a custom gossip_fn, in the round itself
    from repro_torch.core.packing import PackedLayout

    layout = PackedLayout.from_tree([torch.zeros((N, 4))], lane=1)
    cfg16 = DPPSConfig(noise=False, wire_dtype="bf16")
    packed = st._replace(push=st.push._replace(
        s=layout.pack(st.push.s)))
    port_msg = _message(lambda: dpps_step(
        packed, torch.zeros((N, 4)), cfg16, layout, gossip_fn=lambda p: p))
    ref_layout = R.core.packing.PackedLayout.from_tree(
        [jax.numpy.zeros((N, 4))], lane=1)
    ref_cfg16 = ref_dpps.DPPSConfig(noise=False, wire_dtype="bf16")
    ref_st = ref_rounds._pack_dpps(ref_dpps.dpps_init(
        [jax.numpy.zeros((N, 4))], ref_cfg16), ref_layout)
    assert port_msg == _message(lambda: ref_dpps.dpps_step(
        ref_st, [jax.numpy.zeros((N, 4))], jax.random.PRNGKey(0), ref_cfg16,
        gossip_fn=lambda p: p, layout=ref_layout))
    # more than one gossip axis
    if len(jax.devices()) >= 4:
        ref_mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2, 1),
                        ("pod", "data", "model"))
        assert _message(lambda: port_shard._gossip_axis(_Mesh())) == \
            _message(lambda: ref_shard._gossip_axis(ref_mesh))


def test_no_process_group_means_no_run():
    """No fallback to the single-process engine: without a process group
    the sharded engine raises; a mesh cannot be made, nor a host mesh."""
    import torch.distributed as dist

    from repro_torch.engine import shard as port_shard
    from repro_torch.launch.mesh import (gossip_axes, make_host_mesh,
                                         make_production_mesh,
                                         n_gossip_nodes)

    assert not dist.is_initialized()

    class OneAxis:
        mesh_dim_names = ("data", "model")
        shape = (4, 1)

    assert gossip_axes(OneAxis()) == ("data",)
    assert n_gossip_nodes(OneAxis()) == 4
    assert gossip_axes(_Mesh()) == ("pod", "data")
    assert n_gossip_nodes(_Mesh()) == 4
    with pytest.raises(RuntimeError, match="initialised process group"):
        port_shard._gossip_axis(OneAxis())
    with pytest.raises(RuntimeError, match="needs 256 devices, have 0"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="one rank, have 0"):
        make_host_mesh()
