"""The model axis for the recurrent and cross-attention groups: xLSTM,
Mamba2 (a plain group, and zamba2's units with their shared attention
block) and the VLM's cross/self units split over the mesh's "model" dim
(``repro_torch.models.parallel``, ``models/ssm.py``,
``models/attention.py``), for serving (``build_serve_plan(arch, mesh)``)
and for PartPSP training (``build_train_plan(arch, mesh)``), against the
reference's GSPMD programs on the forced 4-device host mesh
(``tests/conftest.py``) and against the port's own unsharded plans.

One 4-rank gloo world serves the module (:func:`world`, started by the
:func:`inputs` fixture, as ``tests/test_torch_model_axis_train.py``
starts its own, and joined after the reference has compiled). Each rank
runs the meshes (data, model) = (1, 4) and (2, 2) over the smoke configs
of xlstm-125m (H = 4 mLSTM heads, one a rank at M = 4), zamba2-7b (nh =
4 Mamba2 heads, its shared block's 4 heads), a plain Mamba2 group (two
layers, every leaf shared: ``w_in``'s column map in the perturbation)
and llama-3.2-vision-11b (K = 2 at M = 4: each KV head on 2 ranks, in
the cross layer too; its gates opened to 0.5): a prefill and STEPS
decode steps sampled with Gumbel noise keyed by step, then two PartPSP
rounds from its cut of the reference's initial state fed its cut of the
reference's noise bits, node 0's gradients, and the layout's round trip.
Rank 0 also runs both plans on a one-rank mesh (M = 1 with a group).
This module imports JAX only in fixtures, so the ranks import torch and
the port alone.

Tolerances are PR 28's: the served logits and caches and the trained
state against the reference's at rtol 1e-4 / atol 1e-5 (a state leaf's
atol at least 1e-7 of its largest entry: the noise norms are ~1e9);
against the port's unsharded plan at atol 1e-5 (only the M-way split of
the sums changes an order), the sampled tokens exactly; the one-rank mesh
bit for bit; the c10d calls exactly the code's count and the dry run's
meta count; the gathered shards exactly the whole.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import time

import numpy as np
import pytest
import torch

WORLD = 4
MESHES = ((1, 4), (2, 2))
ARCHS = ("xlstm-125m", "zamba2-7b", "mamba2", "llama-3.2-vision-11b")
B, S, STEPS = 2, 8, 3          # serving
N, TB, TS = 4, 1, 8            # training: nodes, a node's batch, its length
ROUNDS = 2
SEED = 2031
GAMMA_N = 1e-7
GATE = 0.5
RTOL, ATOL = 1e-4, 1e-5        # against the reference
PORT_TOL = 1e-5                # against the port's unsharded plan
JOIN_LIMIT_S = 240
PG_TIMEOUT_S = 60


# -- the cases -----------------------------------------------------------------

def smoke_arch(name: str):
    """The arch's smoke config; "mamba2": a plain Mamba2 group of two
    layers at zamba2-7b's smoke width, every leaf of it shared."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import MambaGroup

    if name == "mamba2":
        arch = get_config("zamba2-7b")
        cfg = dataclasses.replace(arch.smoke, name="mamba2-smoke", groups=(
            MambaGroup(n_layers=2, d_state=16),))
        return dataclasses.replace(arch, name="mamba2", model=cfg,
                                   shared_rules=(("group_0/.*", "shared"),))
    arch = get_config(name)
    return dataclasses.replace(arch, model=arch.smoke)


def is_vlm(cfg) -> bool:
    return any(g.kind == "cross_self" for g in cfg.groups)


def image_tokens(cfg) -> int:
    return next(g.n_image_tokens for g in cfg.groups
                if g.kind == "cross_self")


def prompt_of(cfg) -> dict:
    rng = np.random.default_rng(SEED)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S))}
    if is_vlm(cfg):
        out["image_embeds"] = (rng.normal(size=(B, image_tokens(cfg),
                                                cfg.d_model))
                               * 0.1).astype(np.float32)
    return out


def first_tokens(cfg) -> np.ndarray:
    return np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size,
                                                    size=(B,))


def gumbel(step: int, vocab: int) -> np.ndarray:
    """The sampling noise of decode step ``step``, the same on every rank."""
    u = np.random.default_rng(SEED + 100 + step).random((B, vocab))
    return -np.log(-np.log(u * (1 - 2e-7) + 1e-7)).astype(np.float32)


def serve_shapes():
    from repro_torch.configs import ShapeSpec

    return (ShapeSpec("prompt", S, B, "prefill"),
            ShapeSpec("decode", S + STEPS, B, "decode"))


def train_shape():
    from repro_torch.configs import ShapeSpec

    return ShapeSpec("t", TS, N * TB, "train")


def port_cfg():
    from repro_torch.core.dpps import DPPSConfig
    from repro_torch.core.partpsp import PartPSPConfig
    from repro_torch.core.topology import DOutGraph, derive_constants

    c_prime, lam = derive_constants(DOutGraph(N, 2))
    return PartPSPConfig(gamma_l=0.05, gamma_s=0.05, clip=1.0,
                         dpps=DPPSConfig(b=1.0, gamma_n=GAMMA_N,
                                         c_prime=c_prime, lam=lam))


def train_plan(arch, mesh):
    """``build_train_plan`` of ``arch`` on ``mesh`` (None: unsharded)."""
    from repro_torch.core.topology import DOutGraph
    from repro_torch.launch.steps import build_train_plan

    return build_train_plan(arch, N if mesh is None else mesh, nodes=N,
                            shape=train_shape(), cfg=port_cfg(),
                            topology=DOutGraph(N, 2))


# -- the code's count of the collectives -----------------------------------------

def serve_collectives(cfg, b: int, s: int) -> dict:
    """The c10d calls and operand bytes of a step of ``b`` sequences of ``s``
    new positions on a rank of M > 1 (a data dim of 1 a model group), as
    the code is written: the embedding's sum and the (b, V) logits' gather;
    an mLSTM layer's gather of its (b, s, d_inner) ``u`` and its
    ``w_down`` sum; a Mamba2 layer's ``w_out`` sum; an attention layer's
    ``wo`` and ``w_down`` sums (zamba's shared block once a unit); a cross
    layer's ``wo`` sum. The sLSTM issues none."""
    act = 4 * b * s * cfg.d_model
    calls, nbytes = 2, act + 4 * b * cfg.vocab_size
    for g in cfg.groups:
        if g.kind == "xlstm":
            n = g.n_units * g.mlstm_per_unit
            calls += 2 * n
            nbytes += n * (act + 4 * b * s * int(cfg.d_model * g.proj_factor))
        elif g.kind == "mamba":
            calls, nbytes = calls + g.n_layers, nbytes + g.n_layers * act
        elif g.kind == "zamba":
            n = g.n_units * (g.mamba_per_unit + 2) + g.trailing_mamba
            calls, nbytes = calls + n, nbytes + n * act
        elif g.kind == "cross_self":
            n = g.n_units * (1 + 2 * g.self_per_unit)
            calls, nbytes = calls + n, nbytes + n * act
    return {"all-reduce": (calls, nbytes)}


def pass_collectives(cfg, diff: str, m: int) -> int:
    """The all-reduces of one node's loss and backward in the PartPSP pass
    that differentiates the ``diff`` ("local" or "shared") leaves, under
    the archs' own rules (the mLSTM layers, zamba's shared block, the
    plain Mamba2 group and the VLM's self layers shared; the embedding
    local), as the code is written. A forward issues the sums of
    :func:`serve_collectives`; a backward sums each copy-to-model's
    gradient whose input needs one (an mLSTM's normed input, ``w_if`` and
    ``b_if``; a Mamba2 layer's input and its six whole leaves; an
    attention layer's two; a cross layer's input) and the mLSTM's
    gathered ``u``; the checkpoint recomputation re-issues each
    collective before the last op of its region that saves a tensor (an
    mLSTM's gather; an attention layer's first sum; a unit's inner
    layers, which the unit's own recomputation runs whole but the last
    self layer of a cross/self unit). The loss: the embedding's sum, one
    copy-to-model a 512-position chunk and, at M > 1, its three
    vocabulary-parallel sums and the two that its recomputation
    re-issues."""
    chunks = -(-(TS - 1) // 512)
    calls = 1 + chunks + (5 * chunks if m > 1 else 0)
    local = diff == "local"
    for g in cfg.groups:
        if g.kind == "xlstm":
            calls += g.n_units * g.mlstm_per_unit * (5 if local else 7)
        elif g.kind == "mamba":
            calls += g.n_layers * (2 if local else 8)
        elif g.kind == "zamba":
            p = g.mamba_per_unit
            if local:
                calls += g.n_units * (9 * p + 5) + 8 * g.trailing_mamba
            else:
                calls += (2 * p + 5) + (g.n_units - 1) * (3 * p + 5) \
                    + 2 * g.trailing_mamba
        elif g.kind == "cross_self":
            p = g.self_per_unit
            calls += g.n_units * (7 * p + 1) - (0 if local else 1)
    return calls


def shared_kv_calls(cfg, part, m: int) -> int:
    """The backward sums of the shared KV heads (M > K) a node's two
    passes issue: each ``wk`` / ``wv`` stack (part) a pass
    differentiates."""
    if m <= cfg.n_kv_heads:
        return 0
    kv = [a for p, a in part.leaf_plans()
          if p.endswith(("attn/wk", "attn/wv", "cross/wk", "cross/wv"))]
    return sum(a != "shared" for a in kv) + sum(a != "local" for a in kv)


def train_collectives(arch, part, m: int, data: int, t: int) -> dict:
    """A rank's PartPSP round ``t``: two passes a node of its N / D, the
    per-node norms finished over "model" (the perturbation's, the
    noise's, the clip's, s^(0)'s at round 0); over a data dim above 1 an
    all-gather of each shared leaf and ``a``, and seven node
    reductions."""
    cfg = arch.model
    per_node = pass_collectives(cfg, "local", m) + pass_collectives(
        cfg, "shared", m) + shared_kv_calls(cfg, part, m)
    out = {"all-reduce": (N // data) * per_node + 3 + (t == 0)}
    if data > 1:
        out["all-reduce"] += 7
        out["all-gather"] = len(part.split_static(
            [None] * len(part.leaf_plans()))[0]) + 1
    return out


# -- what each rank runs -------------------------------------------------------

def _leaf_dict(tree) -> dict:
    from repro_torch.core.tree_utils import tree_flatten_with_path

    return {p: x.clone() for p, x in tree_flatten_with_path(tree)[0]
            if isinstance(x, torch.Tensor)}


def _equal_trees(x, y) -> bool:
    a, b = _leaf_dict(x), _leaf_dict(y)
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def serve(arch, mesh, whole: dict) -> dict:
    """The prefill and STEPS sampled decode steps through
    ``build_serve_plan(arch, mesh)`` (None: unsharded) on the whole
    ``whole`` params: this rank's logits, cache, decode logits, tokens and
    each step's c10d calls."""
    from repro_torch.launch.op_analysis import CollectiveCount
    from repro_torch.launch.steps import build_serve_plan

    cfg = arch.model
    pre_shape, dec_shape = serve_shapes()
    pre = build_serve_plan(arch, mesh, shape_name="prompt", shape=pre_shape)
    dec = build_serve_plan(arch, mesh, shape_name="decode", shape=dec_shape)
    params = pre.model.shard_params(whole)
    rows = pre.model.axis.batch_rows(B)
    batch = {k: torch.from_numpy(v[rows]) for k, v in prompt_of(cfg).items()}
    enc = (batch["image_embeds"],) if is_vlm(cfg) else ()
    calls = []

    def counted(fn, *args, **kw):
        count = CollectiveCount()
        with count:
            out = fn(*args, **kw)
        calls.append({k: (count.calls[k], count.bytes[k])
                      for k in count.calls})
        return out

    logits, cache = counted(pre.step_fn, params, batch, capacity=S + STEPS)
    prefill_cache = _leaf_dict(cache)
    tok = torch.from_numpy(first_tokens(cfg)[rows])
    toks, at = [], []
    for t in range(STEPS):
        step_logits, cache = counted(dec.step_fn, params, cache, tok, S + t,
                                     *enc)
        at.append(step_logits.clone())
        tok = (step_logits + torch.from_numpy(
            gumbel(t, cfg.vocab_size)[rows])).argmax(dim=-1)
        toks.append(tok)
    return {"logits": logits, "cache": prefill_cache,
            "decode_logits": torch.stack(at), "tokens": torch.stack(toks),
            "calls": calls, "rows": (rows.start, rows.stop)}


def train_batch(cfg, inp: dict, rows=slice(None)) -> dict:
    out = {"tokens": torch.from_numpy(inp["tokens"][rows])}
    if is_vlm(cfg):
        out["image_embeds"] = torch.from_numpy(inp["image_embeds"][rows])
    return out


def whole_state(arch, stacked):
    """The global state (N rows, the whole model), the whole model and its
    partition, over the node-stacked ``stacked`` params (numpy)."""
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
    from repro_torch.core.tree_utils import tree_map

    return tree_map(lambda x: x[node],
                    part.merge(state.dpps.push.s, state.local))


def node_grads(model, params, batch) -> tuple[float, dict]:
    """One node's loss and its gradient of every leaf of ``params``."""
    from repro_torch.core.tree_utils import (tree_flatten_with_path,
                                             tree_unflatten)

    pairs, treedef = tree_flatten_with_path(params)
    leaves = [x.detach().requires_grad_(True) for _, x in pairs]
    loss = model.loss_fn(tree_unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {p: g for (p, _), g in zip(pairs, grads)}


def train_rank(mesh, arch, inp: dict) -> dict:
    """Two rounds of the plan on ``mesh`` from the rank's cut of the
    reference's initial state, batch and bits; node 0's gradients on the
    rank's shard; the layout's round trip."""
    from repro_torch.launch.op_analysis import CollectiveCount
    from repro_torch.launch.sharding import (gather_train_state, node_rows,
                                             shard_train_state,
                                             train_state_shardings)
    from repro_torch.models.parallel import take

    plan = train_plan(arch, mesh)
    state0, whole, part = whole_state(arch, inp["stacked"])
    state = shard_train_state(state0, mesh, whole, part)
    pairs = train_state_shardings(state0, mesh, whole, part).dpps.push.s
    batch = train_batch(arch.model, inp, node_rows(mesh, N))
    out = {"calls": [], "loss": []}
    for t in range(ROUNDS):
        bits = [take(torch.from_numpy(b), p)
                for b, p in zip(inp["bits"][t], pairs)]
        count = CollectiveCount()
        with count:
            state, metrics = plan.step_fn(state, batch, seed=SEED, bits=bits)
        out["calls"].append(dict(count.calls))
        out["loss"].append(float(metrics["loss_mean"]))
    out["final"] = _leaf_dict(state)
    back = gather_train_state(shard_train_state(state0, mesh, whole, part),
                              mesh, whole, part)
    out["gathered_equal"] = _equal_trees(back, state0)
    out["node0_loss"], out["grads"] = node_grads(
        plan.model, plan.model.shard_params(node_params(state0, part)),
        train_batch(arch.model, inp, 0))
    return out


def one_rank(mesh, arch, whole: dict, inp: dict) -> dict:
    """Both plans on a one-rank mesh (M = 1 with a group) against the
    unsharded plans from the same params, state, batch and Philox noise:
    bit for bit."""
    from repro_torch.core.tree_utils import tree_leaves

    got, want = serve(arch, mesh, whole), serve(arch, None, whole)
    served = all(torch.equal(got[k], want[k])
                 for k in ("logits", "decode_logits", "tokens")) and \
        all(torch.equal(got["cache"][p], want["cache"][p])
            for p in want["cache"])
    state0, _, _ = whole_state(arch, inp["stacked"])
    final = []
    for plan in (train_plan(arch, None), train_plan(arch, mesh)):
        state = state0
        for t in range(ROUNDS):
            state, _ = plan.step_fn(state, train_batch(arch.model, inp),
                                    seed=SEED + t)
        final.append(tree_leaves(state))
    trained = all(torch.equal(x, y) if isinstance(x, torch.Tensor)
                  else x == y for x, y in zip(*final))
    return {"serve": served, "train": trained}


def seams(axis) -> dict:
    """The two new seams on the (1, 4) mesh's model group: the gather's
    backward (each rank's partial loss reads the whole gathered tensor
    with its own weights) and a whole leaf read in part by each rank
    through copy-to-model; each rank's gradient against the unsharded
    one's block (gather) or the whole (copy)."""
    gen = torch.Generator().manual_seed(SEED + 7)
    m, n = axis.size, 6
    x = torch.randn((3, m * n), generator=gen)
    w = torch.randn((m, 3, m * n), generator=gen)
    mine = x[:, axis.block(m * n)].clone().requires_grad_(True)
    gathered = axis.gather(mine)
    (g_gather,) = torch.autograd.grad((gathered * w[axis.rank]).sum(), mine)
    leaf = torch.randn((m * n, 5), generator=gen)
    y = torch.randn((3, m * n), generator=gen)
    req = leaf.clone().requires_grad_(True)
    part = axis.copy(req)[axis.block(m * n)]
    (g_copy,) = torch.autograd.grad((y[:, axis.block(m * n)] @ part).sum(),
                                    req)
    return {"gather": (gathered.detach(), g_gather), "copy": g_copy}


def rank_main(rank: int, store: str, out_dir: str, inputs_path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_host_mesh, model_axis
    from repro_torch.launch.sharding import gather_params, shard_params
    from repro_torch.models.transformer import Transformer

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        results = {}
        for shape in MESHES:
            mesh = make_host_mesh(shape=shape)
            axis = model_axis(mesh)
            results[shape] = {"axis": (axis.size, axis.rank, axis.data_size,
                                       axis.data_rank)}
            for name in ARCHS:
                arch, inp = smoke_arch(name), inputs[name]
                whole = Transformer(arch.model)
                r = serve(arch, mesh, inp["params"])
                r["gathered_equal"] = _equal_trees(gather_params(
                    shard_params(inp["params"], mesh, whole), mesh, whole),
                    inp["params"])
                r["train"] = train_rank(mesh, arch, inp)
                results[shape][name] = r
            if shape == (1, 4):
                results["seams"] = seams(axis)
        # a one-rank mesh of each rank (every rank makes every mesh's
        # groups); rank 0 runs its own
        singles = [DeviceMesh("cpu", torch.tensor([[r]]),
                              mesh_dim_names=("data", "model"))
                   for r in range(WORLD)]
        if rank == 0:
            results["one_rank"] = {
                name: one_rank(singles[0], smoke_arch(name),
                               inputs[name]["params"], inputs[name])
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


def _reference_case(R, name: str, keys) -> dict:
    """The reference's model and params (gates opened), the same converted
    for the port; its partition and initial state over node-stacked
    params (each node's its own), its batch and each round's noise
    bits."""
    import jax
    import jax.numpy as jnp
    from test_torch_models import cfg_to_reference
    from test_torch_reference import reference_tree_bits

    from repro_torch import convert
    from repro_torch.models.attention import open_cross_gates

    arch = smoke_arch(name)
    cfg = arch.model
    model = R.models.Transformer(cfg_to_reference(R, cfg))
    params = open_cross_gates(jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(1))), GATE)
    rng = np.random.default_rng(SEED + 2)
    stacked = jax.tree_util.tree_map(
        lambda x: (x[None] + 0.01 * rng.normal(size=(N,) + x.shape))
        .astype(np.float32), params)
    jparams = jax.tree_util.tree_map(jnp.asarray, stacked)
    part = R.core.partition.Partition.from_rules(
        jparams, arch.shared_rules, default="local")
    st = R.core.partpsp.partpsp_init(jparams, part, _ref_cfg(R))
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(N, TB, TS),
                                    dtype=np.int32)}
    if is_vlm(cfg):
        batch["image_embeds"] = (rng.normal(size=(N, TB, image_tokens(cfg),
                                                  cfg.d_model))
                                 * 0.1).astype(np.float32)
    bits = [reference_tree_bits(jax.random.split(k, 3)[2], st.dpps.push.s)
            for k in keys]
    port = convert.transformer_params_from_reference(params, cfg,
                                                     device="cpu")
    return dict(model=model, ref_params=params, params=port, part=part,
                state=st, stacked=stacked, bits=bits, **batch)


@pytest.fixture(scope="module")
def inputs(R, tmp_path_factory):
    """Per arch: the reference's model, params, initial state, batch and
    bits; saved for the world, whose ranks start here (they run while
    :func:`reference` compiles)."""
    import jax
    import torch.multiprocessing as mp

    _host_meshes()
    keys = [jax.random.PRNGKey(SEED + t) for t in range(ROUNDS)]
    cases = {name: _reference_case(R, name, keys) for name in ARCHS}
    tmp = tmp_path_factory.mktemp("model_axis_groups")
    path = tmp / "inputs.pt"
    torch.save({name: {k: c[k] for k in c if k in (
        "params", "stacked", "bits", "tokens", "image_embeds")}
        for name, c in cases.items()}, path)
    ctx = mp.start_processes(rank_main, args=(str(tmp / "store"), str(tmp),
                                              str(path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    yield {"cases": cases, "keys": keys, "tmp": tmp, "ctx": ctx,
           "t0": time.monotonic()}
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
        p.join()


@pytest.fixture(scope="module")
def reference(R, inputs):
    """The reference's prefill of every arch jitted once with its
    ``serve_param_shardings`` on the (1, 4) host mesh, and one PartPSP
    round of every arch jitted once with its ``train_state_shardings`` /
    ``train_batch_shardings`` on the (2, 2) host mesh and run twice ->
    per arch (prefill logits, cache by path) and (final state by path,
    last loss)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    meshes = _host_meshes()
    cases = inputs["cases"]
    mesh = meshes[(1, 4)]
    shard = {n: R.launch.sharding.serve_param_shardings(c["model"], mesh)
             for n, c in cases.items()}
    batches = {n: prompt_of(smoke_arch(n).model) for n in ARCHS}
    batch_sh = {n: {k: NamedSharding(mesh, P("data", *(None,) * (v.ndim - 1)))
                    for k, v in b.items()} for n, b in batches.items()}
    prefill = jax.jit(
        lambda ps, bs: {n: cases[n]["model"].prefill(ps[n], bs[n])
                        for n in ARCHS}, in_shardings=(shard, batch_sh))
    served = jax.tree_util.tree_map(np.asarray, prefill(
        {n: c["ref_params"] for n, c in cases.items()}, batches))
    served = {n: (logits, {_ref_path(kp): v for kp, v in
                           jax.tree_util.tree_flatten_with_path(cache)[0]})
              for n, (logits, cache) in served.items()}

    mesh = meshes[(2, 2)]
    cfg = _ref_cfg(R)
    w = R.core.topology.DOutGraph(n_nodes=N, d=2).weight_matrix_jnp(0)
    states = {n: c["state"] for n, c in cases.items()}
    tbatches = {n: {k: jnp.asarray(c[k]) for k in ("tokens", "image_embeds")
                    if k in c} for n, c in cases.items()}
    in_sh = {n: R.launch.sharding.train_state_shardings(c["model"],
                                                        c["part"], mesh)
             for n, c in cases.items()}
    tb_sh = {n: R.launch.sharding.train_batch_shardings(tbatches[n], mesh)
             for n in cases}

    def one_round(sts, bs, k):
        out = {}
        for name, st in sts.items():
            c = cases[name]
            st, m = R.core.partpsp.partpsp_step(
                st, bs[name], k, cfg=cfg, partition=c["part"],
                loss_fn=c["model"].loss_fn, w=w)
            out[name] = (st, m["loss_mean"])
        return out

    # one round compiled once and called a round (half the compile of
    # the rounds unrolled in one program), its state placed again by
    # the shardings between the calls
    step = jax.jit(one_round, in_shardings=(in_sh, tb_sh,
                                            NamedSharding(mesh, P())))
    for k in inputs["keys"]:
        final = step(states, tbatches, k)
        states = jax.device_put({n: st for n, (st, _) in final.items()},
                                in_sh)
    trained = {name: ({_ref_path(kp): np.asarray(x) for kp, x in
                       jax.tree_util.tree_flatten_with_path(st)[0]},
                      float(loss))
               for name, (st, loss) in final.items()}
    return {"serve": served, "train": trained}


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
    """Per arch: the port's unsharded serve, and its whole model,
    partition, initial state and node 0's loss and gradients."""
    out = {}
    for name in ARCHS:
        arch, case = smoke_arch(name), inputs["cases"][name]
        state0, whole, part = whole_state(arch, case["stacked"])
        loss, grads = node_grads(whole, node_params(state0, part),
                                 train_batch(arch.model, case, 0))
        out[name] = {"serve": serve(arch, None, case["params"]),
                     "state": state0, "model": whole, "part": part,
                     "loss": loss, "grads": grads}
    return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _cut(x: np.ndarray, pairs) -> np.ndarray:
    """``models.parallel.take`` on a numpy array."""
    from repro_torch.models.parallel import take

    return take(torch.from_numpy(np.array(x)), pairs).numpy()


def _rank_axis(shape, rank: int, data: bool = True):
    from repro_torch.models.parallel import ModelAxis

    d, m = shape
    return ModelAxis(size=m, rank=rank % m, data_size=d if data else 1,
                     data_rank=rank // m if data else 0)


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


def _state_pairs(shape, rank: int, u: dict) -> dict:
    """Rank ``rank``'s (dim, slice) pairs of each node-stacked state leaf,
    by path."""
    from repro_torch.launch.sharding import train_state_shardings

    sh = train_state_shardings(u["state"], _Coordinates(shape, rank),
                               u["model"], u["part"])
    out = {f".dpps/.push/.s/{i}": x for i, x in enumerate(sh.dpps.push.s)}
    out.update({f".local/{i}": x for i, x in enumerate(sh.local)})
    out.update({".dpps/.push/.a": sh.dpps.push.a,
                ".dpps/.sens/.s_local": sh.dpps.sens.s_local,
                ".dpps/.sens/.prev_noise_l1": sh.dpps.sens.prev_noise_l1})
    return out


# -- the split models build --------------------------------------------------------

@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("arch", ARCHS)
def test_the_groups_build_over_the_axis(arch, m):
    """``Transformer(cfg, axis=ModelAxis(size=M))`` builds, its rank's
    shards are a block of every split dim, and both plans build for the
    rank (an int M: rank 0 of M without a process group)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.steps import build_serve_plan, build_train_plan
    from repro_torch.models.parallel import ModelAxis
    from repro_torch.models.transformer import Transformer

    spec = smoke_arch(arch)
    model = Transformer(spec.model, axis=ModelAxis(size=m, rank=m - 1))
    shards = model.param_shards()
    assert any(v is not None for v in shards.values())
    assert build_serve_plan(spec, m, shape_name="prompt",
                            shape=serve_shapes()[0]).model.axis.size == m
    plan = build_train_plan(spec, N, shape=ShapeSpec("t", TS, N, "train"),
                            model_shards=m)
    assert plan.model.axis.size == m and len(plan.columns.col_maps) > 0


@pytest.mark.parametrize("arch, m, dim, heads", [
    ("xlstm-125m", 3, "n_heads", None),
    ("zamba2-7b", 3, "nh", None),
    ("mamba2", 3, "nh", None),
    ("llama-3.2-vision-11b", 3, "n_heads", None),
])
def test_m_not_dividing_the_groups_heads_is_refused(arch, m, dim, heads):
    """An M that does not divide a "model" leaf dim of the mLSTM (its
    d_inner, n_heads x its head dim), of Mamba2 (2 d_inner of nh heads) or
    of the VLM (H D) raises a ``ValueError`` naming the config dims."""
    from repro_torch.models.parallel import ModelAxis
    from repro_torch.models.transformer import Transformer

    cfg = smoke_arch(arch).model
    if heads is not None:
        cfg = dataclasses.replace(cfg, n_heads=heads, n_kv_heads=heads)
    with pytest.raises(ValueError, match=dim):
        Transformer(cfg, axis=ModelAxis(size=m))


@pytest.mark.parametrize("arch, m, heads", [
    ("xlstm-125m", 8, None),
    ("zamba2-7b", 8, 8),
    ("mamba2", 8, 8),
])
def test_groups_split_where_m_does_not_divide_their_heads(arch, m, heads):
    """M = 8 over 4 mLSTM or Mamba2 heads (refused before the head runs;
    the smoke configs given 8 attention heads, so nh alone is short of M):
    every rank builds, odd ranks hold a head and even ranks none (an empty
    block of each head leaf, ``w_in`` an empty ``Halves``), and both
    plans build for the busiest rank."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.steps import build_serve_plan, build_train_plan
    from repro_torch.models.parallel import Halves, ModelAxis
    from repro_torch.models.transformer import Transformer

    spec = smoke_arch(arch)
    cfg = spec.model if heads is None else dataclasses.replace(
        spec.model, n_heads=heads, n_kv_heads=heads)
    spec = dataclasses.replace(spec, model=cfg)
    for r in range(m):
        shards = Transformer(cfg, axis=ModelAxis(size=m, rank=r)) \
            .param_shards()
        key = next(p for p in shards if p.endswith(
            ("cell/w_q", "cell/w_in")))
        sl = shards[key][0][1]
        assert ((sl.stop - sl.start) > 0) == (r % 2 == 1), (r, key, sl)
        assert isinstance(sl, Halves) == key.endswith("w_in")
    assert build_serve_plan(spec, ModelAxis(size=m, rank=1),
                            shape_name="prompt", shape=serve_shapes()[0]
                            ).model.axis.size == m
    plan = build_train_plan(spec, N, shape=ShapeSpec("t", TS, N, "train"),
                            model_shards=m, model_rank=1)
    assert plan.model.axis.rank == 1 and len(plan.columns.col_maps) > 0


def test_w_in_holds_its_heads_x_and_z_columns():
    """A known difference: the reference's pspec cuts Mamba2's ``w_in``
    (d, 2 d_inner) into M contiguous blocks (at M = 2 rank 0 all of x,
    rank 1 all of the gate z); the port's rank holds the x columns and the
    z columns of its own nh / M heads, and gathers back to the whole."""
    from repro_torch.models.parallel import Halves, ModelAxis, take
    from repro_torch.models.transformer import Transformer

    cfg = smoke_arch("mamba2").model
    params = Transformer(cfg).init(torch.Generator().manual_seed(0), "cpu")
    w_in = params["group_0"]["cell"]["w_in"]
    d_inner = w_in.shape[-1] // 2
    for m in (2, 4):
        parts = []
        for r in range(m):
            model = Transformer(cfg, axis=ModelAxis(size=m, rank=r))
            pairs = model.param_shards()["group_0/cell/w_in"]
            run = d_inner // m
            assert pairs == ((2, Halves(r * run, (r + 1) * run)),)
            got = take(w_in, pairs)
            want = torch.cat([w_in[..., r * run:(r + 1) * run],
                              w_in[..., d_inner + r * run:
                                   d_inner + (r + 1) * run]], dim=-1)
            assert torch.equal(got, want)
            parts.append(got.unflatten(-1, (2, -1)))
        assert torch.equal(torch.cat(parts, dim=-1).flatten(-2), w_in)


def test_mlstm_cache_follows_the_heads():
    """A known difference: the reference's spec replicates the mLSTM
    state; the port's rank holds its heads' C / n / m (dim 3 of (units,
    mlstm_per_unit, B, H, ...)), a Mamba2 state its heads' h (the
    reference's spec), the sLSTM state whole."""
    from repro_torch.launch.sharding import serve_cache_shardings
    from repro_torch.models.parallel import ModelAxis
    from repro_torch.models.transformer import Transformer

    for name, want in (("xlstm-125m", {"mlstm": 3, "slstm": None}),
                       ("zamba2-7b", {"mamba": 3})):
        model = Transformer(smoke_arch(name).model)
        for r in range(4):
            axis = ModelAxis(size=4, rank=r)
            got = serve_cache_shardings(model, axis, batch=B,
                                        capacity=S)["group_0"]
            for sub, dim in want.items():
                for key, pairs in got[sub].items():
                    assert pairs == (None if dim is None else
                                     ((dim, slice(r, r + 1)),)), (sub, key)
    assert Transformer(smoke_arch("xlstm-125m").model).cache_pspecs()[
        "group_0"]["mlstm"]["C"] == (None, None, "data", None, None, None)


def test_w_in_column_map_draws_the_whole_draws_columns():
    """The plain Mamba2 group at M = 4: ``train_columns`` maps each rank's
    ``w_in`` (its heads' x and z columns, every layer) as ONE column map of
    runs of d_inner / M at a stride of d_inner; its Philox bits are the
    whole leaf's draw at those columns bit for bit, and the perturbation
    of the shard (plain route) its columns of the whole perturbation
    (within rtol 1e-4 / atol 1e-5: in about one run in twenty, one CPU
    worker thread's block of elements came out up to 35 ulp apart between
    the two elementwise passes, its recomputation equal; ROADMAP Queue
    3); the whole leaves count on rank 0, the split ones on every rank."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.sharding import train_columns
    from repro_torch.launch.steps import build_train_plan
    from repro_torch.models.parallel import ModelAxis, take
    from repro_torch.models.transformer import Transformer

    arch = smoke_arch("mamba2")
    plan = build_train_plan(arch, N, shape=train_shape(), model_shards=4)
    paths = [p for p, a in plan.partition.leaf_plans() if a != "local"]
    i = paths.index("group_0/cell/w_in")
    whole_shape = tuple(Transformer(arch.model).init(
        torch.Generator(), device="meta")["group_0"]["cell"]["w_in"].shape)
    d_inner = whole_shape[-1] // 2
    size = math.prod(whole_shape)
    n = 3
    gen = torch.Generator().manual_seed(5)
    for rank in range(4):
        model = Transformer(arch.model, axis=ModelAxis(size=4, rank=rank))
        counted, maps = train_columns(model, plan.partition, model.axis)
        cmap = maps[i]
        assert (cmap.run, cmap.stride, cmap.off) == (
            d_inner // 4, d_inner, rank * d_inner // 4)
        whole_map = train_columns(Transformer(arch.model), plan.partition,
                                  ModelAxis())[1][i]
        assert cmap.col0 == whole_map.col0
        want = {"w_in": True, "w_out": True}
        names = [p.rsplit("/", 1)[-1] for p in paths]
        assert counted == [want.get(k, rank == 0) for k in names]
        col0 = cmap.col0
        bits = ref.philox_bits(7, 2, n, col0, col0 + size, node0=1)
        pairs = model.param_shards()["group_0/cell/w_in"]
        shard = lambda x: take(x.reshape((n,) + whole_shape),  # noqa: E731
                               tuple((d + 1, sl) for d, sl in pairs)
                               ).reshape(n, -1)
        part = size // 4
        assert torch.equal(ref.philox_map(7, 2, n, cmap, part, node0=1),
                           shard(bits))
        s = torch.randn((n, size), generator=gen)
        eps = torch.randn((n, size), generator=gen)
        full = ops.dpps_perturb_rows(s, eps, 0.5, 0.1, size, seed=7, t=2,
                                     col0=col0, node0=1)
        got = ops.dpps_perturb_rows(shard(s).contiguous(),
                                    shard(eps).contiguous(), 0.5, 0.1, part,
                                    seed=7, t=2, node0=1, col_map=cmap)
        torch.testing.assert_close(got[0], shard(full[0]), rtol=1e-4,
                                   atol=1e-5)


# -- the world: layout ------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
def test_gather_of_the_shards_is_the_whole(world, shape):
    """The parameters (``gather_params``) and the train state
    (``gather_train_state``), exactly, on every rank."""
    for rank in range(WORLD):
        for name in ARCHS:
            got = world[rank][shape][name]
            assert got["gathered_equal"] and got["train"]["gathered_equal"]


@pytest.mark.parametrize("shape", MESHES)
def test_model_axis_of_a_mesh(world, shape):
    data, m = shape
    for rank in range(WORLD):
        assert world[rank][shape]["axis"] == (m, rank % m, data, rank // m)


# -- the world: serving -------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_matches_the_references(world, reference, shape,
                                                arch):
    """Each rank's prefill logits (its batch rows) and cache (its rows and
    heads: the mLSTM's and Mamba2's states, the KV heads) against the
    reference's sharded prefill on the (1, 4) host mesh."""
    from repro_torch.models.transformer import Transformer

    cfg = smoke_arch(arch).model
    want_logits, want_cache = reference["serve"][arch]
    for rank in range(WORLD):
        r = world[rank][shape][arch]
        rows = slice(*r["rows"])
        np.testing.assert_allclose(_np(r["logits"]), want_logits[rows],
                                   rtol=RTOL, atol=ATOL)
        shards = Transformer(cfg, axis=_rank_axis(shape, rank)).cache_shards(
            B, S)
        assert set(r["cache"]) == set(want_cache)
        for path, x in r["cache"].items():
            got = _np(x)
            if path.rsplit("/", 1)[-1] in ("k", "v"):
                got = got[..., :S, :, :]
            np.testing.assert_allclose(
                got, _cut(want_cache[path], shards[path]), rtol=RTOL,
                atol=ATOL, err_msg=path)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_the_unsharded_plan(world, unsharded, shape,
                                                  arch):
    """Prefill and decode logits within ``PORT_TOL`` of the unsharded plan's
    rows, the sampled tokens exactly (each step's top-1 margin of logits +
    noise in the unsharded run is asserted above 1e-4)."""
    want = unsharded[arch]["serve"]
    vocab = want["logits"].shape[-1]
    scores = want["decode_logits"] + torch.stack(
        [torch.from_numpy(gumbel(t, vocab)) for t in range(STEPS)])
    top2 = scores.topk(2, dim=-1).values
    assert (top2[..., 0] - top2[..., 1]).min() > 1e-4
    for rank in range(WORLD):
        r = world[rank][shape][arch]
        rows = slice(*r["rows"])
        np.testing.assert_allclose(_np(r["logits"]), _np(want["logits"][rows]),
                                   rtol=0, atol=PORT_TOL)
        np.testing.assert_allclose(_np(r["decode_logits"]),
                                   _np(want["decode_logits"][:, rows]),
                                   rtol=0, atol=PORT_TOL)
        assert torch.equal(r["tokens"], want["tokens"][:, rows])


@pytest.mark.parametrize("shape", MESHES)
def test_ranks_of_a_data_group_agree_bit_for_bit(world, shape):
    m = shape[1]
    for rank in range(WORLD):
        first = world[rank - rank % m][shape]
        for n in ARCHS:
            for key in ("logits", "decode_logits", "tokens"):
                assert torch.equal(world[rank][shape][n][key], first[n][key])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_collectives_equal_the_codes_count(world, shape, arch):
    cfg = smoke_arch(arch).model
    b = B // shape[0]
    want = [serve_collectives(cfg, b, S)] + \
        [serve_collectives(cfg, b, 1)] * STEPS
    for rank in range(WORLD):
        assert world[rank][shape][arch]["calls"] == want


# -- the world: training ------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_after_two_rounds_matches_the_reference(world, reference,
                                                      unsharded, shape,
                                                      arch):
    """Each rank's state after two rounds against its cut of the
    reference's GSPMD step on the (2, 2) host mesh, its loss too."""
    want, want_loss = reference["train"][arch]
    u = unsharded[arch]
    for rank in range(WORLD):
        r = world[rank][shape][arch]["train"]
        np.testing.assert_allclose(r["loss"][-1], want_loss, rtol=RTOL)
        pairs = _state_pairs(shape, rank, u)
        assert set(r["final"]) == set(want) - {".dpps/.t"}  # a host int
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
    against the port's unsharded ones cut by the shard: a whole leaf
    that the rank's heads read in part (``w_if``, ``b_if``, ``w_b``,
    ``w_c``, ``w_dt``, ``b_dt``, ``a_log``, ``d_skip``) whole on every
    rank, counted once; a cross layer's ``gate`` and shared KV head
    likewise."""
    from repro_torch.models.transformer import Transformer

    u = unsharded[arch]
    for rank in range(WORLD):
        r = world[rank][shape][arch]["train"]
        assert abs(r["node0_loss"] - u["loss"]) <= PORT_TOL * abs(u["loss"])
        shards = Transformer(u["model"].cfg, axis=_rank_axis(
            shape, rank, data=False)).param_shards()
        assert set(r["grads"]) == set(u["grads"])
        for path, g in r["grads"].items():
            np.testing.assert_allclose(
                _np(g), _cut(_np(u["grads"][path]), shards[path]), rtol=0,
                atol=PORT_TOL, err_msg=f"rank {rank} {path}")


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_collectives_equal_the_codes_count(world, unsharded, shape,
                                                 arch):
    spec = smoke_arch(arch)
    data, m = shape
    want = [train_collectives(spec, unsharded[arch]["part"], m, data, t)
            for t in range(ROUNDS)]
    for rank in range(WORLD):
        assert world[rank][shape][arch]["train"]["calls"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_is_the_unsharded_plan_bit_for_bit(world, arch):
    assert world[0]["one_rank"][arch] == {"serve": True, "train": True}


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_counts_the_ranks_collectives(world, arch):
    """A rank's steps on meta (an int M, no process group) charge the
    collectives the (1, 4) world's ranks issued: the prefill (the smoke
    model at D = 64, which the flash kernel's meta path takes), a decode
    step and the first training round (the mLSTM's gather among the
    all-reduces)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.core.topology import DOutGraph
    from repro_torch.launch.steps import build_serve_plan, build_train_plan

    spec = smoke_arch(arch)
    got = world[0][(1, 4)][arch]
    for kind, step in (("prefill", 0), ("decode", 1)):
        arch64 = spec if kind == "decode" else dataclasses.replace(
            spec, model=dataclasses.replace(spec.model, head_dim=64))
        shape = ShapeSpec("t", S if kind == "prefill" else S + STEPS, B,
                          kind)
        terms = build_serve_plan(arch64, 4, shape_name="t",
                                 shape=shape).cost()
        assert {k: (terms.coll_calls[k], int(terms.coll_bytes[k]))
                for k in terms.coll_calls} == got["calls"][step]
    terms = build_train_plan(spec, N, shape=train_shape(), cfg=port_cfg(),
                             topology=DOutGraph(N, 2), model_shards=4).cost()
    assert dict(terms.coll_calls) == got["train"]["calls"][0]


# -- the world: the seams -----------------------------------------------------------

def test_gather_backward_is_the_unsharded_gradient(world):
    """``ModelAxis.gather`` on the (1, 4) mesh: every rank's output is the
    whole tensor; the gradient of the ranks' summed partial losses (each
    reading the whole gathered tensor with its own weights) is, on each
    rank, the unsharded gradient's block."""
    gen = torch.Generator().manual_seed(SEED + 7)
    m, n = 4, 6
    x = torch.randn((3, m * n), generator=gen)
    w = torch.randn((m, 3, m * n), generator=gen)
    want = w.sum(dim=0)
    for rank in range(WORLD):
        gathered, grad = world[rank]["seams"]["gather"]
        assert torch.equal(gathered, x)
        torch.testing.assert_close(grad, want[:, rank * n:(rank + 1) * n],
                                   rtol=0, atol=1e-6)


def test_a_whole_leaf_read_in_part_has_its_gradient_counted_once(world):
    """A whole leaf that each rank reads only its block of rows of, through
    ``ModelAxis.copy``: its gradient on every rank is the unsharded one
    (every rank's share summed once), not the rank's share."""
    gen = torch.Generator().manual_seed(SEED + 7)
    m, n = 4, 6
    torch.randn((3, m * n), generator=gen)
    torch.randn((m, 3, m * n), generator=gen)
    leaf = torch.randn((m * n, 5), generator=gen).requires_grad_(True)
    y = torch.randn((3, m * n), generator=gen)
    (want,) = torch.autograd.grad((y @ leaf).sum(), leaf)
    for rank in range(WORLD):
        torch.testing.assert_close(world[rank]["seams"]["copy"], want,
                                   rtol=0, atol=1e-6)
