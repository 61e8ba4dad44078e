"""PartPSP training over the model axis (``build_train_plan(arch, mesh)``,
the model half of ``repro_torch.launch.sharding``'s train state, the
column-sum seam ``core.dpps.ColumnOps``, the autograd collectives of
``repro_torch.models.parallel``, the perturbation's column map) against
the reference's ``train_state_shardings`` and its two-round
``partpsp_step`` jitted with them on the forced 4-device host mesh
(``tests/conftest.py``), and against the port's own unsharded plan.

One 4-rank gloo world serves the module (:func:`world`, spawned as
``tests/test_torch_model_axis.py`` spawns its own). Each rank runs the
meshes (data, model) = (1, 4) and (2, 2) over the smoke configs of
llama3.2-1b (K = 2 at M = 4: each KV head on 2 ranks; its layer-split
rule cut to one shared layer of the two, so a layer stack comes in two
parts) and llama4-scout (experts; the router and the norms shared and
replicated). A rank holds its N / D node rows of its model shard of the
reference's initial state (N = 4 nodes, each node's parameters its own)
and runs two PartPSP rounds on the reference's batch, fed its cut of the
reference's noise bits (``reference_tree_bits``); it saves its state,
each step's c10d calls, node 0's gradients, the vocabulary-parallel loss
of random logits, and whether its shards gather back to the whole state.
Rank 0 also runs the plan on a one-rank mesh (M = 1 with a group). This
module imports JAX only in fixtures, so the ranks import torch and the
port alone.

Tolerances: the state against the reference's at rtol 1e-4 and atol
1e-5 (or 1e-7 of a leaf's largest entry: the noise norms are ~1e9), the
port's training tolerance against the reference; node 0's gradients
against the port's unsharded ones at atol 1e-5 (only the M-way split of
the sums changes an order); the one-rank mesh bit for bit; the
collectives exactly the code's count and the dry run's meta count; the
Philox column map bit for bit the whole draw's columns.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time

import numpy as np
import pytest
import torch

WORLD = 4
MESHES = ((1, 4), (2, 2))
ARCHS = ("llama3.2-1b", "llama4-scout-17b-a16e")
N, B, S = 4, 2, 12
ROUNDS = 2
SEED = 2028
GAMMA_N = 1e-7
RTOL, ATOL = 1e-4, 1e-5     # against the reference
PORT_TOL = 1e-5             # node 0's gradients against the unsharded ones
JOIN_LIMIT_S = 240
PG_TIMEOUT_S = 60


# -- inputs shared by the ranks, the reference and the unsharded plan ----------

def smoke_arch(name: str):
    """The smoke config, its split_layers rules cut to one layer (the
    smoke models have two)."""
    from repro_torch.configs import get_config

    arch = get_config(name)
    rules = tuple((pat, ("split_layers", 1) if isinstance(act, tuple)
                   else act) for pat, act in arch.shared_rules)
    return dataclasses.replace(arch, model=arch.smoke, shared_rules=rules)


def train_shape():
    from repro_torch.configs import ShapeSpec

    return ShapeSpec("t", S, N * B, "train")


def port_cfg():
    from repro_torch.core.dpps import DPPSConfig
    from repro_torch.core.partpsp import PartPSPConfig
    from repro_torch.core.topology import DOutGraph, derive_constants

    c_prime, lam = derive_constants(DOutGraph(N, 2))
    return PartPSPConfig(gamma_l=0.05, gamma_s=0.05, clip=1.0,
                         dpps=DPPSConfig(b=1.0, gamma_n=GAMMA_N,
                                         c_prime=c_prime, lam=lam))


def plan_of(arch, mesh):
    """``build_train_plan`` of ``arch`` on ``mesh`` (None: the unsharded
    plan) at N nodes, the test's shape and config."""
    from repro_torch.core.topology import DOutGraph
    from repro_torch.launch.steps import build_train_plan

    return build_train_plan(arch, N if mesh is None else mesh, nodes=N,
                            shape=train_shape(), cfg=port_cfg(),
                            topology=DOutGraph(N, 2))


def whole_state(arch, stacked):
    """The global state (N rows, the whole model) over the node-stacked
    ``stacked`` params (numpy), with the whole model and its partition."""
    from repro_torch import convert
    from repro_torch.core.partition import Partition
    from repro_torch.core.partpsp import partpsp_init
    from repro_torch.models.transformer import Transformer

    params = convert.transformer_params_from_reference(
        stacked, arch.model, device="cpu", nodes=N)
    part = Partition.from_rules(params, arch.shared_rules, default="local")
    return partpsp_init(params, part, port_cfg()), Transformer(arch.model), \
        part


def node_params(state, part, node: int = 0):
    """Node ``node``'s parameter tree of a global state."""
    from repro_torch.core.tree_utils import tree_map

    return tree_map(lambda x: x[node],
                    part.merge(state.dpps.push.s, state.local))


def random_logits(vocab: int):
    """(B, S - 1, V) logits and targets for the vocabulary-parallel loss."""
    gen = torch.Generator().manual_seed(SEED + 3)
    logits = torch.randn((B, S - 1, vocab), generator=gen) * 3.0
    return logits, torch.randint(0, vocab, (B, S - 1), generator=gen)


def expected_collectives(arch, part, m: int, data: int, t: int) -> dict:
    """The c10d calls a rank's PartPSP round ``t`` issues, as the code is
    written. A node's loss and backward in each of the round's two
    gradient passes: a SUM all-reduce after the embedding lookup, after
    each layer's ``wo`` and its ``w_down`` (or MoE combine), and, at M > 1,
    three a loss chunk (the max, the exponentials' sum, the target's
    logit); the backward recomputes each checkpointed layer's first
    all-reduce (the second's output is saved by no op of the layer, so
    the recomputation stops before it) and, at M > 1, a chunk's first two;
    it sums each copy-to-model's gradient (two an attention layer, three
    an MoE unit: the attention's input, the experts' tokens, the gate
    probability; one a chunk's head) and, where M/K ranks share a KV head,
    each ``wk`` / ``wv`` stack (part) that pass differentiates. The round
    finishes its per-node norms over "model" (the perturbation's, the
    noise's, the clip's, and at round 0 s^(0)'s); over a data dim above 1
    it all-gathers each shared leaf and ``a`` and all-reduces its seven
    node reductions."""
    cfg = arch.model
    layers = sum(g.n_layers for g in cfg.groups)
    units = sum(g.n_layers for g in cfg.groups if g.kind == "moe")
    chunks = -(-(S - 1) // 512)
    per_pass = ((cfg.input_mode == "tokens") + 2 * layers
                + (3 * chunks if m > 1 else 0)        # forward
                + layers + (2 * chunks if m > 1 else 0)   # recomputation
                + 2 * layers + units + chunks)        # copy-to-model
    kv = [a for p, a in part.leaf_plans()
          if p.endswith(("attn/wk", "attn/wv"))] if m > cfg.n_kv_heads else []
    shared_heads = sum(a != "shared" for a in kv) + sum(a != "local"
                                                        for a in kv)
    calls = (N // data) * 2 * per_pass + shared_heads * (N // data) \
        + 3 + (t == 0)
    out = {"all-reduce": calls}
    if data > 1:
        out["all-reduce"] += 7
        out["all-gather"] = len(part.split_static(
            [None] * len(part.leaf_plans()))[0]) + 1
    return out


# -- what each rank runs -------------------------------------------------------

def _leaf_dict(state) -> dict:
    from repro_torch.core.tree_utils import tree_flatten_with_path

    return {p: x.clone() for p, x in tree_flatten_with_path(state)[0]
            if isinstance(x, torch.Tensor)}


def train_rank(mesh, name: str, inp: dict) -> dict:
    """Two rounds of ``arch``'s plan on ``mesh`` from the rank's cut of the
    reference's initial state, batch and bits; node 0's gradients; the
    vocabulary-parallel loss; the layout's round trip."""
    from repro_torch.core.tree_utils import tree_flatten_with_path, \
        tree_unflatten
    from repro_torch.launch.op_analysis import CollectiveCount
    from repro_torch.launch.sharding import (gather_train_state, node_rows,
                                             shard_train_state,
                                             train_state_shardings)
    from repro_torch.models.parallel import take

    arch = smoke_arch(name)
    plan = plan_of(arch, mesh)
    state0, whole, part = whole_state(arch, inp["stacked"])
    state = shard_train_state(state0, mesh, whole, part)
    pairs = train_state_shardings(state0, mesh, whole, part).dpps.push.s
    rows = node_rows(mesh, N)
    tokens = torch.from_numpy(inp["tokens"])[rows]
    out = {"initial": _leaf_dict(state), "calls": [], "loss": []}
    for t in range(ROUNDS):
        bits = [take(torch.from_numpy(b), p)
                for b, p in zip(inp["bits"][t], pairs)]
        count = CollectiveCount()
        with count:
            state, metrics = plan.step_fn(state, {"tokens": tokens},
                                          seed=SEED, bits=bits)
        out["calls"].append(dict(count.calls))
        out["loss"].append(float(metrics["loss_mean"]))
    out["final"] = _leaf_dict(state)
    back = gather_train_state(shard_train_state(state0, mesh, whole, part),
                              mesh, whole, part)
    out["gathered_equal"] = all(
        torch.equal(x, y) for x, y in zip(_leaf_dict(back).values(),
                                          _leaf_dict(state0).values()))

    # node 0's gradients on the rank's shard of its parameters
    pairs0, treedef = tree_flatten_with_path(
        plan.model.shard_params(node_params(state0, part)))
    leaves = [x.detach().requires_grad_(True) for _, x in pairs0]
    loss = plan.model.loss_fn(tree_unflatten(treedef, leaves),
                              {"tokens": torch.from_numpy(inp["tokens"][0])})
    grads = torch.autograd.grad(loss, leaves)
    out["grads"] = {p: g for (p, _), g in zip(pairs0, grads)}
    out["node0_loss"] = float(loss.detach())

    # the vocabulary-parallel loss of random logits, and its gradient
    axis = plan.model.axis
    vocab = arch.model.vocab_size
    logits, targets = random_logits(vocab)
    local = logits[..., axis.block(vocab, "vocab_size")].clone() \
        .requires_grad_(True)
    ce = axis.cross_entropy(local, targets, vocab) if axis.size > 1 else \
        (torch.logsumexp(local, -1) - local.gather(
            -1, targets[..., None])[..., 0]).sum()
    out["ce"] = (float(ce), torch.autograd.grad(ce, local)[0])
    return out


def one_rank(mesh, name: str, inp: dict) -> bool:
    """The plan on a one-rank mesh (M = 1 with a group) against the
    unsharded plan, from the same state and batch, Philox noise, two
    rounds: bit for bit."""
    from repro_torch.core.tree_utils import tree_leaves

    arch = smoke_arch(name)
    state0, _, _ = whole_state(arch, inp["stacked"])
    tokens = {"tokens": torch.from_numpy(inp["tokens"])}
    final = []
    for plan in (plan_of(arch, None), plan_of(arch, mesh)):
        state = state0
        for t in range(ROUNDS):
            state, _ = plan.step_fn(state, tokens, seed=SEED + t)
        final.append(tree_leaves(state))
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(*final))


def rank_main(rank: int, store: str, out_dir: str, inputs_path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        results = {}
        for shape in MESHES:
            mesh = make_host_mesh(shape=shape)
            for name in ARCHS:
                results[(shape, name)] = train_rank(mesh, name, inputs[name])
        # a one-rank mesh of each rank (every rank makes every mesh's
        # groups); rank 0 runs its own
        singles = [DeviceMesh("cpu", torch.tensor([[r]]),
                              mesh_dim_names=("data", "model"))
                   for r in range(WORLD)]
        if rank == 0:
            results["one_rank"] = {name: one_rank(singles[0], name,
                                                  inputs[name])
                                   for name in ARCHS}
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- fixtures ------------------------------------------------------------------

@pytest.fixture(scope="module")
def R():
    from test_torch_reference import load_reference

    R = load_reference()
    import repro.launch.sharding  # noqa: F401
    return R


def _ref_path(kp) -> str:
    """A reference key path as the port's ``tree_flatten_with_path`` names
    it (a NamedTuple field ``.name``)."""
    import jax

    names = []
    for k in kp:
        if isinstance(k, jax.tree_util.GetAttrKey):
            names.append("." + k.name)
        elif isinstance(k, jax.tree_util.SequenceKey):
            names.append(str(k.idx))
        else:
            names.append(str(k.key))
    return "/".join(names)


def _reference_case(R, name: str, keys) -> dict:
    """The reference's model, partition and initial state of ``name`` (each
    node's params its own), its batch and each round's noise bits."""
    import jax
    import jax.numpy as jnp
    from test_torch_models import cfg_to_reference
    from test_torch_reference import reference_tree_bits

    arch = smoke_arch(name)
    model = R.models.Transformer(cfg_to_reference(R, arch.model))
    params = jax.tree_util.tree_map(np.asarray,
                                    model.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(SEED)
    stacked = jax.tree_util.tree_map(
        lambda x: (x[None] + 0.01 * rng.normal(size=(N,) + x.shape))
        .astype(np.float32), params)
    jparams = jax.tree_util.tree_map(jnp.asarray, stacked)
    part = R.core.partition.Partition.from_rules(
        jparams, arch.shared_rules, default="local")
    st = R.core.partpsp.partpsp_init(jparams, part, _ref_cfg(R))
    tokens = rng.integers(0, arch.model.vocab_size, size=(N, B, S),
                          dtype=np.int32)
    bits = [reference_tree_bits(jax.random.split(k, 3)[2], st.dpps.push.s)
            for k in keys]
    return dict(model=model, part=part, state=st, stacked=stacked,
                tokens=tokens, bits=bits)


def _ref_cfg(R):
    topo = R.core.topology.DOutGraph(n_nodes=N, d=2)
    c_prime, lam = R.core.topology.derive_constants(topo)
    return R.core.partpsp.PartPSPConfig(
        gamma_l=0.05, gamma_s=0.05, clip=1.0,
        dpps=R.core.dpps.DPPSConfig(b=1.0, gamma_n=GAMMA_N, c_prime=c_prime,
                                    lam=lam, use_kernels=True))


def _host_meshes():
    import jax
    from jax.sharding import Mesh

    if len(jax.devices()) < WORLD:
        pytest.skip("needs 4 forced host devices (see conftest XLA_FLAGS)")
    return {shape: Mesh(np.asarray(jax.devices()[:WORLD]).reshape(shape),
                        ("data", "model")) for shape in MESHES}


@pytest.fixture(scope="module")
def inputs(R, tmp_path_factory):
    """Per arch: the reference's initial state, batch and noise bits of
    each round, and its ``train_state_shardings`` on both meshes as spec
    tuples; the inputs saved for the world, whose ranks start here (they
    run while :func:`reference` compiles)."""
    import jax
    import torch.multiprocessing as mp

    meshes = _host_meshes()
    keys = [jax.random.PRNGKey(SEED + t) for t in range(ROUNDS)]
    cases, specs = {}, {}
    for name in ARCHS:
        case = cases[name] = _reference_case(R, name, keys)
        specs[name] = {}
        for shape, mesh in meshes.items():
            flat = jax.tree_util.tree_flatten_with_path(
                R.launch.sharding.train_state_shardings(
                    case["model"], case["part"], mesh))[0]
            specs[name][shape] = {_ref_path(kp): tuple(sh.spec)
                                  for kp, sh in flat}
    tmp = tmp_path_factory.mktemp("model_axis_train")
    path = tmp / "inputs.pt"
    torch.save({name: {k: c[k] for k in ("stacked", "tokens", "bits")}
                for name, c in cases.items()}, path)
    ctx = mp.start_processes(rank_main, args=(str(tmp / "store"), str(tmp),
                                              str(path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    out = {"cases": cases, "keys": keys, "specs": specs, "tmp": tmp,
           "ctx": ctx, "t0": time.monotonic()}
    yield out
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
        p.join()


@pytest.fixture(scope="module")
def reference(R, inputs):
    """The reference's two rounds of both archs, jitted once with its
    ``train_state_shardings`` / ``train_batch_shardings`` as
    ``in_shardings`` on the (2, 2) host mesh -> per arch (final state by
    path, last loss)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    mesh = _host_meshes()[(2, 2)]
    cfg = _ref_cfg(R)
    w = R.core.topology.DOutGraph(n_nodes=N, d=2).weight_matrix_jnp(0)
    cases = inputs["cases"]
    states = {n: c["state"] for n, c in cases.items()}
    batches = {n: {"tokens": jnp.asarray(c["tokens"])}
               for n, c in cases.items()}
    in_sh = {n: R.launch.sharding.train_state_shardings(c["model"],
                                                        c["part"], mesh)
             for n, c in cases.items()}
    batch_sh = {n: R.launch.sharding.train_batch_shardings(batches[n], mesh)
                for n in cases}

    def rounds(sts, bs, ks):
        out = {}
        for name, st in sts.items():
            c = cases[name]
            for k in ks:
                st, m = R.core.partpsp.partpsp_step(
                    st, bs[name], k, cfg=cfg, partition=c["part"],
                    loss_fn=c["model"].loss_fn, w=w)
            out[name] = (st, m["loss_mean"])
        return out

    final = jax.jit(rounds, in_shardings=(
        in_sh, batch_sh, NamedSharding(mesh, P())))(
            states, batches, inputs["keys"])
    return {name: ({_ref_path(kp): np.asarray(x) for kp, x in
                    jax.tree_util.tree_flatten_with_path(st)[0]}, float(loss))
            for name, (st, loss) in final.items()}


@pytest.fixture(scope="module")
def world(inputs, reference):
    """Every rank's saved results, from the 4-rank world :func:`inputs`
    started (joined after the reference's compile, which ran meanwhile)."""
    ctx, t0 = inputs["ctx"], inputs["t0"]
    while not ctx.join(timeout=max(1.0, JOIN_LIMIT_S -
                                   (time.monotonic() - t0))):
        if time.monotonic() - t0 > JOIN_LIMIT_S:
            pytest.fail(f"the 4-rank world did not finish in "
                        f"{JOIN_LIMIT_S} s")
    return [torch.load(inputs["tmp"] / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def unsharded(inputs):
    """Per arch: the port's whole model, partition, initial state and node
    0's loss and gradients on it (by path)."""
    from repro_torch.core.tree_utils import tree_flatten_with_path, \
        tree_unflatten

    out = {}
    for name in ARCHS:
        inp = inputs["cases"][name]
        state0, whole, part = whole_state(smoke_arch(name), inp["stacked"])
        pairs, treedef = tree_flatten_with_path(node_params(state0, part))
        leaves = [x.detach().requires_grad_(True) for _, x in pairs]
        loss = whole.loss_fn(tree_unflatten(treedef, leaves),
                             {"tokens": torch.from_numpy(inp["tokens"][0])})
        grads = torch.autograd.grad(loss, leaves)
        out[name] = {"state": state0, "model": whole, "part": part,
                     "loss": float(loss.detach()),
                     "grads": {p: g for (p, _), g in zip(pairs, grads)}}
    return out


def _rank_axis(shape, rank: int):
    from repro_torch.models.parallel import ModelAxis

    data, m = shape
    return ModelAxis(size=m, rank=rank % m)


class _Coordinates:
    """A mesh stand-in: rank ``rank``'s coordinates on a ``shape`` mesh and
    no process group (what ``train_state_shardings`` reads)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape, rank: int):
        self.shape, self.rank = shape, rank

    def get_local_rank(self, name: str) -> int:
        m = self.shape[1]
        return self.rank // m if name == "data" else self.rank % m

    def get_group(self, name: str):
        return None


def _pairs(shape, rank: int, model, part, state) -> dict:
    """Rank ``rank``'s (dim, slice) pairs of each node-stacked leaf of the
    global ``state`` on a ``shape`` mesh
    (``train_state_shardings(state, mesh, model, partition)``), by path."""
    from repro_torch.launch.sharding import train_state_shardings

    sh = train_state_shardings(state, _Coordinates(shape, rank), model, part)
    out = {f".dpps/.push/.s/{i}": x for i, x in enumerate(sh.dpps.push.s)}
    out.update({f".local/{i}": x for i, x in enumerate(sh.local)})
    out.update({".dpps/.push/.a": sh.dpps.push.a,
                ".dpps/.sens/.s_local": sh.dpps.sens.s_local,
                ".dpps/.sens/.prev_noise_l1": sh.dpps.sens.prev_noise_l1})
    return out


def _cut(x: np.ndarray, pairs) -> np.ndarray:
    for dim, sl in pairs or ():
        x = np.take(x, np.arange(sl.start, sl.stop), axis=dim)
    return x


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# -- the layout ----------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_are_the_references(inputs, unsharded, shape,
                                              arch):
    """``train_state_pspecs`` equals the reference's
    ``train_state_shardings(model, partition, mesh)`` as spec tuples, leaf
    by leaf."""
    from repro_torch.launch.sharding import train_state_pspecs

    class Names:
        mesh_dim_names = ("data", "model")

    u = unsharded[arch]
    assert train_state_pspecs(u["model"], u["part"], Names()) == \
        inputs["specs"][arch][shape]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_holds_its_rows_of_its_model_block(world, unsharded, shape,
                                                arch):
    """Each rank's initial state is its node rows of its model block of
    the global state, exactly: ``a`` and the (N,) vectors its rows only,
    a shared KV head's columns on each of its ranks."""
    u = unsharded[arch]
    whole = {p: _np(x) for p, x in _leaf_dict(u["state"]).items()}
    for rank in range(WORLD):
        got = world[rank][(shape, arch)]["initial"]
        pairs = _pairs(shape, rank, u["model"], u["part"], u["state"])
        assert set(got) == set(whole)
        for path, x in got.items():
            want = _cut(whole[path], pairs.get(path))
            np.testing.assert_array_equal(_np(x), want, err_msg=path)
        assert pairs[".dpps/.push/.a"] == pairs[".dpps/.sens/.s_local"]
        assert len(pairs[".dpps/.push/.a"]) == 1


@pytest.mark.parametrize("shape", MESHES)
def test_gather_of_the_train_state_is_the_whole(world, shape):
    for rank in range(WORLD):
        assert all(world[rank][(shape, a)]["gathered_equal"] for a in ARCHS)


def test_columns_are_counted_once():
    """llama3.2-1b's smoke model at M = 4 (K = 2): a replicated leaf
    counts on rank 0, a shared KV head on the first of its two ranks, a
    split leaf on every rank; each rank's wire columns of a split leaf
    are its block of the whole leaf's."""
    from repro_torch.launch.sharding import train_columns
    from repro_torch.launch.steps import build_train_plan
    from repro_torch.models.parallel import ModelAxis
    from repro_torch.models.transformer import Transformer

    arch = smoke_arch("llama3.2-1b")
    cfg = arch.model
    plan = build_train_plan(arch, N, shape=train_shape(), model_shards=4)
    paths = [p for p, a in plan.partition.leaf_plans() if a != "local"]
    names = [p.rsplit("/", 1)[-1] for p in paths]
    sizes, maps = {}, {}
    for rank in range(4):
        model = Transformer(cfg, axis=ModelAxis(size=4, rank=rank))
        counted, maps[rank] = train_columns(model, plan.partition,
                                            model.axis)
        want = {"scale": rank == 0, "wk": rank % 2 == 0, "wv": rank % 2 == 0}
        assert counted == [want.get(n, True) for n in names], rank
    h, kd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    wq = names.index("wq")
    for rank in range(4):
        cmap = maps[rank][wq]
        assert (cmap.run, cmap.stride, cmap.off) == (h // 4, h, rank * h // 4)
        wk = maps[rank][names.index("wk")]
        assert (wk.run, wk.stride, wk.off) == (cfg.head_dim, kd,
                                               (rank // 2) * cfg.head_dim)
        assert sizes.setdefault("wq0", cmap.col0) == cmap.col0
    assert maps[0][names.index("wo")].contiguous is False


# -- the sharded step ------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_after_two_rounds_matches_the_reference(world, reference,
                                                      unsharded, shape,
                                                      arch):
    """Each rank's state after two rounds against its cut of the
    reference's GSPMD step (the (2, 2) host mesh; its output is the same
    global state on any mesh up to sum order), its loss too."""
    want, want_loss = reference[arch]
    u = unsharded[arch]
    for rank in range(WORLD):
        r = world[rank][(shape, arch)]
        np.testing.assert_allclose(r["loss"][-1], want_loss, rtol=RTOL)
        pairs = _pairs(shape, rank, u["model"], u["part"], u["state"])
        for path, x in r["final"].items():
            w = _cut(want[path], pairs.get(path))
            np.testing.assert_allclose(
                _np(x), w, rtol=RTOL, atol=max(ATOL, 1e-7 * np.abs(w).max()),
                err_msg=f"rank {rank} {path}")


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_node_gradients_match_the_unsharded_ones(world, unsharded, shape,
                                                 arch):
    """Node 0's loss and its gradient of every leaf of the rank's shard
    (the router, a shared KV head, the vocabulary block among them)
    against the port's unsharded ones cut by the shard."""
    from repro_torch.models.transformer import Transformer

    u = unsharded[arch]
    for rank in range(WORLD):
        r = world[rank][(shape, arch)]
        assert abs(r["node0_loss"] - u["loss"]) <= PORT_TOL * abs(u["loss"])
        shards = Transformer(u["model"].cfg,
                             axis=_rank_axis(shape, rank)).param_shards()
        assert set(r["grads"]) == set(u["grads"])
        for path, g in r["grads"].items():
            np.testing.assert_allclose(
                _np(g), _cut(_np(u["grads"][path]), shards[path]), rtol=0,
                atol=PORT_TOL, err_msg=f"rank {rank} {path}")


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_leaves_agree_across_model_ranks(world, unsharded, shape,
                                                    arch):
    """After two rounds the ranks of one data group hold every leaf they
    all hold whole (the norm scales, the router, ``a``, the sensitivity
    vectors) bit for bit alike."""
    u = unsharded[arch]
    m = shape[1]
    for rank in range(WORLD):
        first = world[rank - rank % m][(shape, arch)]["final"]
        got = world[rank][(shape, arch)]["final"]
        pairs = _pairs(shape, rank, u["model"], u["part"], u["state"])
        whole = [p for p, x in pairs.items() if len(x) == 1]
        assert ".dpps/.push/.a" in whole and len(whole) > 3
        for path in whole:
            assert torch.equal(got[path], first[path]), (rank, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_is_the_unsharded_plan_bit_for_bit(world, arch):
    assert world[0]["one_rank"][arch]


@pytest.mark.parametrize("shape", MESHES)
def test_vocabulary_parallel_loss_matches_the_gathered_one(world, shape):
    """The sum of cross entropies from a rank's vocabulary block (a MAX
    and two SUM all-reduces) against ``logsumexp`` of the whole logits,
    and its gradient against the whole one's block."""
    arch = smoke_arch(ARCHS[0])
    vocab = arch.model.vocab_size
    logits, targets = random_logits(vocab)
    full = logits.clone().requires_grad_(True)
    want = (torch.logsumexp(full, -1)
            - full.gather(-1, targets[..., None])[..., 0]).sum()
    grad = torch.autograd.grad(want, full)[0]
    want = float(want.detach())
    for rank in range(WORLD):
        got, g = world[rank][(shape, ARCHS[0])]["ce"]
        assert abs(got - want) <= 1e-6 * abs(want)
        m = shape[1]
        block = slice(rank % m * vocab // m, (rank % m + 1) * vocab // m)
        torch.testing.assert_close(g, grad[..., block], rtol=0, atol=1e-6)


# -- collectives -----------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_equal_the_codes_count(world, unsharded, shape, arch):
    spec = smoke_arch(arch)
    u = unsharded[arch]
    data, m = shape
    want = [expected_collectives(spec, u["part"], m, data, t)
            for t in range(ROUNDS)]
    for rank in range(WORLD):
        assert world[rank][(shape, arch)]["calls"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_counts_the_ranks_collectives(world, arch):
    """A rank's step on meta (``model_shards=4``, no process group)
    charges the collectives the (1, 4) world's ranks issued in round 0."""
    from repro_torch.core.topology import DOutGraph
    from repro_torch.launch.steps import build_train_plan

    terms = build_train_plan(smoke_arch(arch), N, shape=train_shape(),
                             cfg=port_cfg(), topology=DOutGraph(N, 2),
                             model_shards=4).cost()
    assert terms.mesh == f"nodes{N}+model4"
    assert dict(terms.coll_calls) == world[0][((1, 4), arch)]["calls"][0]


def test_dry_run_costs_a_train_row_over_the_axis(monkeypatch):
    """``--model-shards 2`` on a train row (the smoke model in place of
    the published one): one rank's FLOPs and peak below the whole step's,
    its all-reduces in the row."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "get_config", smoke_arch)
    whole = dryrun.run_one("llama3.2-1b", "train_4k", nodes=2, verbose=False)
    row = dryrun.run_one("llama3.2-1b", "train_4k", nodes=2, model_shards=2,
                         verbose=False)
    assert whole["status"] == row["status"] == "ok"
    assert row["mesh"] == "nodes2+model2" and row["nodes_whole"]
    assert row["coll_calls"]["all-reduce"] > 0
    assert row["flops_per_chip"] < whole["flops_per_chip"]
    assert row["peak_bytes"] < whole["peak_bytes"]


# -- the Philox column map --------------------------------------------------------

@pytest.mark.parametrize("lead, width, blocks, col0", [
    (6, 10, ((0, 4), (3, 8), (1, 10)), 5),      # run, off, col0 not % 4
    (3, 16, ((0, 8), (8, 16), (4, 12)), 0),     # aligned
    (2, 7, ((0, 7), (2, 5)), 3),                # a run of 3 (the plain map)
    (4, 33, ((11, 22),), 1024),
])
def test_philox_column_map_draws_the_whole_draws_columns(lead, width, blocks,
                                                         col0):
    """A block of columns [a, b) of a (lead, width) leaf at wire column
    col0: its map's bits are the whole leaf's draw at those columns, bit
    for bit, and the perturbation of the block (plain route) its columns
    of the whole perturbation, with the block's norms; a block of the
    leading dim (rows) is contiguous."""
    from repro_torch.kernels import ops, ref

    n, size = 3, lead * width
    whole = ref.philox_bits(7, 2, n, col0, col0 + size, node0=2)
    gen = torch.Generator().manual_seed(lead * width)
    s = torch.randn((n, size), generator=gen)
    eps = torch.randn((n, size), generator=gen)
    full = ops.dpps_perturb_rows(s, eps, 0.5, 0.1, size, seed=7, t=2,
                                 col0=col0, node0=2)
    for a, b in blocks:
        cmap = ref.ColumnMap(col0, b - a, width, a)
        bits = ref.philox_map(7, 2, n, cmap, lead * (b - a), node0=2)
        assert torch.equal(bits.reshape(n, lead, b - a),
                           whole.reshape(n, lead, width)[..., a:b])
        cut = lambda x: x.reshape(n, lead, width)[..., a:b].reshape(n, -1)
        got = ops.dpps_perturb_rows(cut(s).contiguous(), cut(eps).contiguous(),
                                    0.5, 0.1, lead * (b - a), seed=7, t=2,
                                    node0=2, col_map=cmap)
        assert torch.equal(got[0], cut(full[0]))
        noise = ref.laplace_from_bits(cut(whole), 0.5)
        torch.testing.assert_close(got[2], noise.abs().sum(dim=1))
    rows = ref.ColumnMap(col0, (lead - 1) * width, size, width)
    assert torch.equal(ref.philox_map(7, 2, n, rows, (lead - 1) * width,
                                      node0=2), whole[:, width:])


def test_tree_draw_keys_each_shard_by_its_global_columns():
    """The pytree runtime's draws over a rank's shards (plain and tree
    routes) are the whole tree's draws at the shards' columns, and the
    uncounted leaves drop out of the norms."""
    from repro_torch.core.privacy import noise_wire
    from repro_torch.kernels import ops, ref

    n = 2
    leaves = [torch.randn((n, 4, 6)), torch.randn((n, 5))]
    whole = noise_wire(leaves, 1.0, seed=3, t=1)
    shards = [leaves[0][..., 2:4].contiguous(), leaves[1]]
    maps = [ref.ColumnMap(0, 2, 6, 2), ref.ColumnMap(24, 1, 1)]
    got = noise_wire(shards, 1.0, seed=3, t=1, col_maps=maps)
    assert torch.equal(got[0], whole[0][..., 2:4])
    assert torch.equal(got[1], whole[1])
    zeros = [torch.zeros_like(x) for x in shards]
    out, _, noise_l1 = ops.dpps_perturb_tree(
        zeros, zeros, 1.0, 1.0, seed=3, t=1, col_maps=maps,
        counted=[True, False])
    assert torch.equal(out[0], got[0]) and torch.equal(out[1], got[1])
    torch.testing.assert_close(noise_l1, got[0].abs().sum(dim=(1, 2)))
