"""The model axis for serving (``repro_torch.models.parallel``, the model
half of ``repro_torch.launch.sharding``, ``build_serve_plan(arch, mesh)``)
against the reference's pspecs, its ``serve_param_shardings`` on the
forced 4-device host mesh (``tests/conftest.py``) and its prefill jitted
with those ``in_shardings``, and against the port's own unsharded plan.

One 4-rank gloo world serves the module (:func:`world`, spawned as
``tests/test_torch_shard.py`` spawns its own: ``file://`` store, a
process-group timeout, a wall limit on the join). Each rank runs the
meshes (data, model) = (1, 4) and (2, 2) over the smoke configs of
llama3.2-1b (K = 2 at M = 4: each KV head on 2 ranks), gemma3-1b (windows,
softcap, tied embedding, K = 1 replicated), musicgen-large (embedding
input) and llama4-scout (experts; at (2, 2) its routing over the data
ranks' tokens): a prefill of S tokens, then STEPS decode steps sampled
with Gumbel noise keyed by step, never by rank, and saves what it got.
The (2, 2) mesh's model groups are two M = 2 axes, its data dim splits
the batch; a (1, 2) mesh over ranks 0 and 1 checks the layout's round
trip too. This module imports JAX only in fixtures, so
the ranks import torch and the port alone.

Tolerances: the sharded prefill against the reference's sharded prefill
at rtol 1e-4 / atol 1e-4, the tolerance ``tests/test_torch_models.py``
holds the unsharded prefill to; against the port's unsharded plan at atol
1e-5 (only the M-way split of the ``wo`` / ``w_down`` sums and of the
embedding's zero terms changes an order), the sampled tokens exactly.
Ranks of one data group agree bit for bit. The collectives a step issues
(``CollectiveCount``) equal :func:`expected_collectives`, and the dry
run's meta count of a rank.
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

from repro_torch.configs import ARCH_NAMES

WORLD = 4
MESHES = ((1, 4), (2, 2))
ARCHS = ("llama3.2-1b", "gemma3-1b", "musicgen-large",
         "llama4-scout-17b-a16e")
B, S, STEPS = 2, 12, 4
SEED = 2027
RTOL = ATOL = 1e-4   # against the reference
PORT_TOL = 1e-5      # against the port's unsharded plan
JOIN_LIMIT_S = 240
PG_TIMEOUT_S = 60


# -- inputs shared by the ranks, the reference and the unsharded plan ----------

def smoke_arch(name: str):
    from repro_torch.configs import get_config

    arch = get_config(name)
    return dataclasses.replace(arch, model=arch.smoke)


def prompt_of(cfg) -> dict:
    rng = np.random.default_rng(SEED)
    if cfg.input_mode == "embeddings":
        return {"embeds": (rng.normal(size=(B, S, cfg.d_model))
                           * 0.1).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S))}


def step_inputs_of(cfg):
    """(first token, per-step embeddings or None) of the decode."""
    rng = np.random.default_rng(SEED + 1)
    tok0 = rng.integers(0, cfg.vocab_size, size=(B,))
    if cfg.input_mode == "embeddings":
        return tok0, (rng.normal(size=(STEPS, B, cfg.d_model))
                      * 0.1).astype(np.float32)
    return tok0, None


def gumbel(step: int, vocab: int) -> np.ndarray:
    """The sampling noise of decode step ``step``: keyed by the step, the
    same on every rank."""
    u = np.random.default_rng(SEED + 100 + step).random((B, vocab))
    return -np.log(-np.log(u * (1 - 2e-7) + 1e-7)).astype(np.float32)


def shapes():
    from repro_torch.configs import ShapeSpec

    return (ShapeSpec("prompt", S, B, "prefill"),
            ShapeSpec("decode", S + STEPS, B, "decode"))


def serve(arch, mesh, whole: dict):
    """The prefill and ``STEPS`` sampled decode steps of ``arch`` through
    ``build_serve_plan(arch, mesh)`` (``mesh`` None: the unsharded plan) on
    the whole ``whole`` params: this rank's logits, cache, decode logits,
    tokens and each step's c10d calls."""
    from repro_torch.core.tree_utils import tree_flatten_with_path
    from repro_torch.engine.rounds import run_decode
    from repro_torch.launch.op_analysis import CollectiveCount
    from repro_torch.launch.steps import build_serve_plan

    cfg = arch.model
    pre_shape, dec_shape = shapes()
    pre = build_serve_plan(arch, mesh, shape_name="prompt", shape=pre_shape)
    dec = build_serve_plan(arch, mesh, shape_name="decode", shape=dec_shape)
    params = pre.init_args("cpu", params=whole)[0]
    rows = pre.model.axis.batch_rows(B)
    batch = {k: torch.from_numpy(v[rows]) for k, v in prompt_of(cfg).items()}
    tok0, embeds = step_inputs_of(cfg)
    calls, logits_at = [], []

    def counted(fn, *args, **kw):
        count = CollectiveCount()
        with count:
            out = fn(*args, **kw)
        calls.append({k: (count.calls[k], count.bytes[k])
                      for k in count.calls})
        return out

    def decode_fn(cache, step_in, pos):
        logits, cache = counted(dec.step_fn, params, cache, step_in, pos)
        logits_at.append(logits.clone())
        return logits, cache

    logits, cache = counted(pre.step_fn, params, batch,
                            capacity=S + STEPS)
    prefill_cache = {p: x.clone() for p, x in
                     tree_flatten_with_path(cache)[0]}
    toks, _ = run_decode(
        decode_fn, cache, torch.from_numpy(tok0[rows]), start_pos=S,
        steps=STEPS, step_inputs=None if embeds is None
        else torch.from_numpy(embeds[:, rows]),
        noise_at=lambda t: torch.from_numpy(gumbel(t, cfg.vocab_size)[rows]))
    return {"logits": logits, "cache": prefill_cache,
            "decode_logits": torch.stack(logits_at), "tokens": toks,
            "calls": calls, "params": params, "rows": (rows.start, rows.stop)}


def expected_collectives(cfg, b: int, s: int, data: int = 1) -> dict:
    """The c10d calls and operand bytes a step of ``b`` sequences of ``s``
    new positions issues on a rank of M > 1, as the model is written: a SUM
    all-reduce of the (b, s, d) activations after each layer's ``wo`` and
    after its ``w_down`` (or MoE combine), one after a token model's
    embedding lookup, one of the (b, V) logits' vocabulary gather, and,
    with a data dim above 1, one of the (data b s, d) tokens each MoE
    block routes."""
    act = 4 * b * s * cfg.d_model
    layers = sum(g.n_layers for g in cfg.groups)
    moe = sum(g.n_units for g in cfg.groups if g.kind == "moe")
    calls, nbytes = 2 * layers + 1, 2 * layers * act + 4 * b * cfg.vocab_size
    if cfg.input_mode == "tokens":
        calls, nbytes = calls + 1, nbytes + act
    if data > 1:
        calls, nbytes = calls + moe, nbytes + moe * data * act
    return {"all-reduce": (calls, nbytes)}


# -- what each rank runs -------------------------------------------------------

def _gathered_equal(whole: dict, mesh, model) -> bool:
    """``gather_params(shard_params(whole))`` equals ``whole`` exactly."""
    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.sharding import gather_params, shard_params

    back = gather_params(shard_params(whole, mesh, model), mesh, model)
    return all(torch.equal(x, y) for x, y in
               zip(tree_flatten(back)[0], tree_flatten(whole)[0]))


def rank_main(rank: int, store: str, out_dir: str, params_path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_host_mesh, model_axis
    from repro_torch.models.transformer import Transformer

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        wholes = torch.load(params_path, weights_only=False)
        results = {}
        for shape in MESHES:
            mesh = make_host_mesh(shape=shape)
            axis = model_axis(mesh)
            out = {"axis": (axis.size, axis.rank, axis.data_size,
                            axis.data_rank)}
            for name in ARCHS:
                arch = smoke_arch(name)
                r = serve(arch, mesh, wholes[name])
                r["gathered_equal"] = _gathered_equal(
                    wholes[name], mesh, Transformer(arch.model))
                out[name] = r
            results[shape] = out
        # (1, 2): a mesh of ranks 0 and 1 (the others hold no part of it)
        mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                          mesh_dim_names=("data", "model"))
        if mesh.get_coordinate() is not None:
            results[(1, 2)] = {name: _gathered_equal(
                wholes[name], mesh, Transformer(smoke_arch(name).model))
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


@pytest.fixture(scope="module")
def reference(R, tmp_path_factory):
    """The reference's models, their params (numpy), the same converted
    for the port (also saved for the world), and the reference's prefill
    of every arch jitted once with its ``in_shardings`` on the (1, 4) host
    mesh, and its ``device_put`` shards on both meshes."""
    import jax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P
    from test_torch_models import cfg_to_reference

    from repro_torch import convert

    if len(jax.devices()) < WORLD:
        pytest.skip("needs 4 forced host devices (see conftest XLA_FLAGS)")
    models, params, port = {}, {}, {}
    for name in ARCHS:
        cfg = smoke_arch(name).model
        models[name] = R.models.Transformer(cfg_to_reference(R, cfg))
        params[name] = jax.tree_util.tree_map(
            np.asarray, models[name].init(jax.random.PRNGKey(1)))
        port[name] = convert.transformer_params_from_reference(
            params[name], cfg, device="cpu")
    path = tmp_path_factory.mktemp("model_axis_params") / "params.pt"
    torch.save(port, path)

    meshes = {shape: Mesh(np.asarray(jax.devices()[:WORLD]).reshape(shape),
                          ("data", "model")) for shape in MESHES}
    mesh = meshes[(1, 4)]
    shard = {n: R.launch.sharding.serve_param_shardings(models[n], mesh)
             for n in ARCHS}
    batches = {n: prompt_of(smoke_arch(n).model) for n in ARCHS}
    batch_sh = {n: {k: NamedSharding(mesh, P("data", *(None,) * (v.ndim - 1)))
                    for k, v in b.items()} for n, b in batches.items()}
    prefill = jax.jit(
        lambda ps, bs: {n: models[n].prefill(ps[n], bs[n]) for n in ARCHS},
        in_shardings=(shard, batch_sh))
    out = jax.tree_util.tree_map(np.asarray, prefill(params, batches))

    placed = {}
    for shape, m in meshes.items():
        rank_of = {d: i for i, d in enumerate(m.devices.reshape(-1))}
        placed[shape] = {}
        for n in ARCHS:
            put = jax.device_put(
                params[n], R.launch.sharding.serve_param_shardings(models[n], m))
            flat = jax.tree_util.tree_flatten_with_path(put)[0]
            placed[shape][n] = {
                "/".join(k.key for k in kp): {
                    rank_of[sh.device]: np.asarray(sh.data)
                    for sh in leaf.addressable_shards}
                for kp, leaf in flat}
    return {"prefill": out, "params": port, "path": str(path),
            "placed": placed}


@pytest.fixture(scope="module")
def world(reference, tmp_path_factory):
    """Every rank's saved results, from one spawned 4-rank world."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("model_axis_world")
    store = str(tmp / "store")
    t0 = time.monotonic()
    ctx = mp.start_processes(rank_main, args=(store, str(tmp),
                                              reference["path"]),
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
def unsharded(reference):
    """The port's unsharded plans on the same params and inputs."""
    return {n: serve(smoke_arch(n), None, reference["params"][n])
            for n in ARCHS}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _cut(x: np.ndarray, shard) -> np.ndarray:
    for dim, sl in shard or ():
        x = np.take(x, np.arange(sl.start, sl.stop), axis=dim)
    return x


def _rank_axis(shape, rank: int):
    from repro_torch.models.parallel import ModelAxis

    data, m = shape
    return ModelAxis(size=m, rank=rank % m, data_size=data,
                     data_rank=rank // m)


# -- specs ---------------------------------------------------------------------

def _spec_tuples(R, tree) -> dict:
    import jax
    from jax.sharding import PartitionSpec as P

    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(k.key for k in kp): tuple(spec) for kp, spec in flat}


def _port_specs(tree, prefix: str = "") -> dict:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_port_specs(v, f"{prefix}/{k}" if prefix else k))
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_pspecs_are_the_references(R, arch):
    """``param_pspecs()`` and ``cache_pspecs()`` (batch over "data", and the
    sequence-sharded form) of every architecture's smoke config equal the
    reference's PartitionSpecs as tuples."""
    from test_torch_models import cfg_to_reference

    from repro_torch.models.parallel import SHARDED_KINDS, ModelAxis
    from repro_torch.models.transformer import Transformer

    cfg = smoke_arch(arch).model
    ref, port = R.models.Transformer(cfg_to_reference(R, cfg)), Transformer(cfg)
    assert _port_specs(port.param_pspecs()) == _spec_tuples(
        R, ref.param_pspecs())
    for kw in ({}, dict(batch_axis="data", seq_axis=None),
               dict(batch_axis=None, seq_axis="data")):
        assert _port_specs(port.cache_pspecs(**kw)) == _spec_tuples(
            R, ref.cache_pspecs(**kw))
    if all(g.kind in SHARDED_KINDS for g in cfg.groups):  # a rank's too
        rank = Transformer(cfg, axis=ModelAxis(size=2, rank=1))
        assert rank.param_pspecs() == port.param_pspecs()
        assert rank.cache_pspecs() == port.cache_pspecs()


# -- the layout ------------------------------------------------------------------

@pytest.mark.parametrize("shape", ((1, 2),) + MESHES)
def test_gather_of_the_shards_is_the_whole(world, shape):
    """Exactly, on every rank of the mesh ((1, 2): ranks 0 and 1 of the
    world)."""
    for rank in range(math.prod(shape)):
        got = world[rank][shape]
        assert all((got[n] if shape == (1, 2) else got[n]["gathered_equal"])
                   for n in ARCHS)


@pytest.mark.parametrize("shape", MESHES)
def test_model_axis_of_a_mesh(world, shape):
    data, m = shape
    for rank in range(WORLD):
        assert world[rank][shape]["axis"] == (m, rank % m, data, rank // m)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_shards_are_the_references_addressable_shards(world, reference,
                                                      shape, arch):
    """Each rank's parameter shard equals what the reference's
    ``device_put(params, serve_param_shardings(model, mesh))`` places on
    that device, but ``wk`` / ``wv`` where K divides M (the port keeps a
    KV head whole on each of its M/K ranks; the reference splits its
    columns): those equal the whole head (checked here against the
    whole parameter)."""
    from repro_torch.core.tree_utils import tree_flatten_with_path
    from repro_torch.models.transformer import Transformer

    cfg = smoke_arch(arch).model
    whole = dict(tree_flatten_with_path(reference["params"][arch])[0])
    placed = reference["placed"][shape][arch]
    for rank in range(WORLD):
        got = dict(tree_flatten_with_path(world[rank][shape][arch]["params"])[0])
        assert set(got) == set(placed)
        shards = Transformer(cfg, axis=_rank_axis(shape, rank)).param_shards()
        for path, x in got.items():
            replicated_kv = path.rsplit("/", 1)[-1] in ("wk", "wv") and \
                cfg.n_kv_heads % shape[1] != 0
            want = _cut(_np(whole[path]), shards[path]) if replicated_kv \
                else placed[path][rank]
            np.testing.assert_array_equal(_np(x), want, err_msg=path)


def test_kv_heads_are_replicated_where_k_divides_m():
    """llama3.2-1b's smoke config, K = 2 at M = 4: ranks 0, 1 hold KV head
    0, ranks 2, 3 head 1, each whole (its D columns of ``wk`` / ``wv``, its
    slot of the cache), with their own query heads."""
    from repro_torch.launch.sharding import (serve_cache_shardings,
                                             serve_param_shardings)
    from repro_torch.models.parallel import ModelAxis
    from repro_torch.models.transformer import Transformer

    cfg = smoke_arch("llama3.2-1b").model
    d = cfg.head_dim
    params = Transformer(cfg).init(torch.Generator().manual_seed(0), "cpu")
    for rank in range(4):
        axis = ModelAxis(size=4, rank=rank)
        model = Transformer(cfg, axis=axis)
        j = rank // 2
        share = model.groups[0].share
        assert (share.h, share.kv) == (2, 1)
        shard = model.shard_params(params)
        for leaf in ("wk", "wv"):
            assert torch.equal(shard["group_0"]["attn"][leaf],
                               params["group_0"]["attn"][leaf]
                               [..., j * d:(j + 1) * d])
        assert torch.equal(shard["group_0"]["attn"]["wq"],
                           params["group_0"]["attn"]["wq"]
                           [..., rank * 2 * d:(rank + 1) * 2 * d])
        spec = serve_param_shardings(model, axis)["group_0"]["attn"]
        assert spec["wk"] == ((2, slice(j * d, (j + 1) * d)),)
        cache = serve_cache_shardings(model, axis, batch=B, capacity=S)
        assert cache["group_0"]["k"] == ((3, slice(j, j + 1)),)


# -- the sharded step ------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_matches_the_references(world, reference, shape,
                                                arch):
    """Each rank's prefill logits (its batch rows, every vocabulary entry)
    and cache (its rows and KV heads, by ``serve_cache_shardings``) against
    the reference's sharded prefill."""
    import jax

    from repro_torch.models.transformer import Transformer

    cfg = smoke_arch(arch).model
    want_logits, want_cache = reference["prefill"][arch]
    want_cache = {"/".join(k.key for k in kp): v for kp, v in
                  jax.tree_util.tree_flatten_with_path(want_cache)[0]}
    for rank in range(WORLD):
        r = world[rank][shape][arch]
        rows = slice(*r["rows"])
        np.testing.assert_allclose(_np(r["logits"]), want_logits[rows],
                                   rtol=RTOL, atol=ATOL)
        shards = Transformer(cfg, axis=_rank_axis(shape, rank)).cache_shards(
            B, S)
        assert set(r["cache"]) == set(want_cache)
        for path, x in r["cache"].items():
            np.testing.assert_allclose(
                _np(x)[..., :S, :, :], _cut(want_cache[path], shards[path]),
                rtol=RTOL, atol=ATOL, err_msg=path)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_the_unsharded_plan(world, unsharded, shape,
                                                  arch):
    """Prefill and decode logits within ``PORT_TOL`` of the unsharded plan's
    rows, the sampled tokens exactly (each step's top-1 margin of logits +
    noise in the unsharded run is asserted above 1e-4, so no near tie
    decides a token)."""
    want = unsharded[arch]
    scores = want["decode_logits"] + torch.stack(
        [torch.from_numpy(gumbel(t, want["logits"].shape[-1]))
         for t in range(STEPS)])
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
def test_collectives_equal_the_codes_count(world, shape, arch):
    cfg = smoke_arch(arch).model
    data = shape[0]
    b = B // data
    want = [expected_collectives(cfg, b, S, data)] + \
        [expected_collectives(cfg, b, 1, data)] * STEPS
    for rank in range(WORLD):
        assert world[rank][shape][arch]["calls"] == want


# -- the seam --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_no_axis_issues_no_collective_and_is_todays_model(unsharded,
                                                          reference, arch):
    """The plan without a mesh: no c10d call, and the prefill of the model
    built without an axis bit for bit."""
    from repro_torch.launch.steps import build_serve_plan
    from repro_torch.models.parallel import NO_AXIS
    from repro_torch.models.transformer import Transformer

    arch_spec = smoke_arch(arch)
    got = unsharded[arch]
    assert got["calls"] == [{}] * (1 + STEPS)
    plan = build_serve_plan(arch_spec, shape_name="prompt", shape=shapes()[0])
    assert plan.model.axis is NO_AXIS
    model = Transformer(plan.model.cfg)
    batch = {k: torch.from_numpy(v) for k, v in
             prompt_of(arch_spec.model).items()}
    with torch.no_grad():
        logits, _ = model.prefill(reference["params"][arch], batch,
                                  capacity=S + STEPS)
    assert torch.equal(logits, got["logits"])


# -- the dry run -------------------------------------------------------------------

def _meta_calls(arch, m: int, b: int, kind: str) -> dict:
    """A rank's step of ``arch`` over ``m`` ranks on meta at ``b``
    sequences: (its collectives by kind, its terms). The prefill's flash
    meta path takes the kernel's head dims only, so the smoke model runs
    at D = 64 there (a step's collectives carry (b, s, d_model)
    activations and (b, V) logits: D changes none of them)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.steps import build_serve_plan

    if kind == "prefill":
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, head_dim=64))
    shape = ShapeSpec("t", S if kind == "prefill" else S + STEPS, b, kind)
    terms = build_serve_plan(arch, m, shape_name="t", shape=shape).cost()
    return {k: (terms.coll_calls[k], int(terms.coll_bytes[k]))
            for k in terms.coll_calls}, terms


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_counts_the_ranks_collectives(world, arch):
    """A rank's step on meta (an int M, no process group) charges the
    collectives the gloo rank issued: M = 4 against the (1, 4) mesh; M = 2
    at its batch rows against the (2, 2) mesh (but scout's, which routes
    over the data ranks there: one more all-reduce a MoE block)."""
    spec = smoke_arch(arch)
    for kind, step in (("prefill", 0), ("decode", 1)):
        calls, _ = _meta_calls(spec, 4, B, kind)
        assert calls == world[0][(1, 4)][arch]["calls"][step]
        if not any(g.kind == "moe" for g in spec.model.groups):
            calls, _ = _meta_calls(spec, 2, B // 2, kind)
            assert calls == world[0][(2, 2)][arch]["calls"][step]


def test_dry_run_charges_a_rank_less_than_the_whole(monkeypatch):
    """``--model-shards 2`` on a serve row (the smoke model at D = 64 in
    place of the published one): one rank's peak below the whole model's,
    its collectives in the row."""
    from repro_torch.launch import dryrun

    def smoke64(name):
        arch = smoke_arch(name)
        return dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, head_dim=64))

    monkeypatch.setattr(dryrun, "get_config", smoke64)
    whole = dryrun.run_one("llama3.2-1b", "decode_32k", verbose=False)
    row = dryrun.run_one("llama3.2-1b", "decode_32k", model_shards=2,
                         verbose=False)
    assert whole["status"] == row["status"] == "ok"
    assert whole["mesh"] == "nodes16" and row["mesh"] == "model2"
    assert whole["coll_breakdown"] == {} and "coll_calls" not in whole
    assert row["batch_whole"] and row["model_shards"] == 2
    assert row["coll_calls"] == {"all-reduce": 2 * 2 + 2}
    assert row["peak_bytes"] < whole["peak_bytes"]
    assert row["flops_per_chip"] < whole["flops_per_chip"]


@pytest.mark.parametrize("arch, shards, reason", [
    ("gemma3-1b", 3, "vocab_size"),
])
def test_dry_run_skips_where_m_does_not_split(arch, shards, reason):
    """A row whose M does not divide a leaf dim of the reference's "model"
    pspecs (gemma3-1b's V = 262,144 and H D = 1,024 over 3) is skipped
    with the reason; M = 8, which divides every such dim but not its H =
    4, is an ``ok`` row (:func:`test_dry_run_splits_where_m_does_not_
    divide_the_heads`)."""
    from repro_torch.launch import dryrun

    row = dryrun.run_one(arch, "prefill_32k", model_shards=shards,
                         verbose=False)
    assert row["status"] == "skipped" and reason in row["reason"]
    assert row["mesh"] == f"model{shards}"


def test_dry_run_splits_where_m_does_not_divide_the_heads(monkeypatch):
    """gemma3-1b at M = 8 (H = 4, K = 1: four ranks hold no heads): an
    ``ok`` row of the busiest rank, which holds one query head and the KV
    head (gemma3-1b's smoke config at D = 64, M = 8)."""
    from repro_torch.launch import dryrun

    def smoke64(name):
        arch = smoke_arch(name)
        return dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, head_dim=64))

    monkeypatch.setattr(dryrun, "get_config", smoke64)
    row = dryrun.run_one("gemma3-1b", "prefill_32k", model_shards=8,
                         verbose=False)
    assert row["status"] == "ok" and row["mesh"] == "model8"
    assert (row["model_rank"], row["heads"], row["kv_heads"]) == (1, 1, 1)
    assert row["coll_calls"]["all-reduce"] > 2


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-7b",
                                  "llama-3.2-vision-11b"])
def test_dry_run_splits_the_recurrent_and_cross_groups(monkeypatch, arch):
    """``--model-shards 2`` on a serve row of the xLSTM, zamba2 and VLM
    archs (the smoke model at D = 64 in place of the published one) is an
    ``ok`` row: one rank's FLOPs and peak below the whole model's, its
    all-reduces in the row."""
    from repro_torch.launch import dryrun

    def smoke64(name):
        spec = smoke_arch(name)
        return dataclasses.replace(spec, model=dataclasses.replace(
            spec.model, head_dim=64))

    monkeypatch.setattr(dryrun, "get_config", smoke64)
    whole = dryrun.run_one(arch, "prefill_32k", verbose=False)
    row = dryrun.run_one(arch, "prefill_32k", model_shards=2, verbose=False)
    assert whole["status"] == row["status"] == "ok"
    assert row["mesh"] == "model2" and row["model_shards"] == 2
    assert row["coll_calls"]["all-reduce"] > 2
    assert row["flops_per_chip"] < whole["flops_per_chip"]
    assert row["peak_bytes"] < whole["peak_bytes"]


# -- refusals ---------------------------------------------------------------------

def _cfg(arch: str, **kw):
    return dataclasses.replace(smoke_arch(arch).model, **kw)


@pytest.mark.parametrize("cfg, m, dim", [
    (lambda: _cfg("llama3.2-1b"), 3, "n_heads"),
    (lambda: _cfg("llama3.2-1b", d_ff=250), 4, "d_ff"),
    (lambda: _cfg("llama4-scout-17b-a16e"), 8, "n_experts"),
    (lambda: _cfg("llama3.2-1b", vocab_size=510), 4, "vocab_size"),
    (lambda: _cfg("llama3.2-1b", n_heads=12, n_kv_heads=3), 32,
     "n_kv_heads"),
])
def test_m_not_dividing_a_dim_is_refused(cfg, m, dim):
    from repro_torch.models.parallel import ModelAxis
    from repro_torch.models.transformer import Transformer

    with pytest.raises(ValueError, match=dim):
        Transformer(cfg(), axis=ModelAxis(size=m))


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-7b",
                                  "llama-3.2-vision-11b"])
def test_recurrent_and_cross_groups_split_at_m_2(arch):
    """The xLSTM, zamba2 and VLM groups build over two ranks, the model
    and its serve plan, each rank holding a block of its split leaves."""
    from repro_torch.launch.steps import build_serve_plan
    from repro_torch.models.parallel import ModelAxis
    from repro_torch.models.transformer import Transformer

    for rank in range(2):
        model = Transformer(smoke_arch(arch).model,
                            axis=ModelAxis(size=2, rank=rank))
        assert any(v is not None for v in model.param_shards().values())
    plan = build_serve_plan(smoke_arch(arch), 2, shape_name="prompt",
                            shape=shapes()[0])
    assert plan.model.axis.size == 2
    Transformer(smoke_arch(arch).model, axis=ModelAxis(size=1))  # M = 1 runs


def test_sequence_sharded_decode_over_data_is_refused():
    """``shard_seq`` over a data dim of D: each KV leaf's slots in D
    blocks (gemma3-1b's smoke group: 2 layers, capacity S), refused with
    a ``ValueError`` where D does not divide them; a data dim of one
    splits nothing."""
    from repro_torch.launch.sharding import serve_cache_shardings
    from repro_torch.models.parallel import ModelAxis
    from repro_torch.models.transformer import Transformer

    model = Transformer(smoke_arch("gemma3-1b").model)
    for r in range(2):
        axis = ModelAxis(size=1, data_size=2, data_rank=r)
        got = serve_cache_shardings(model, axis, batch=1, capacity=S,
                                    shard_seq=True)
        half = slice(r * S // 2, (r + 1) * S // 2)
        assert got == {"group_0": {"k": ((2, half),), "v": ((2, half),)}}
    with pytest.raises(ValueError, match="KV slots"):
        serve_cache_shardings(model, ModelAxis(size=1, data_size=5),
                              batch=1, capacity=S, shard_seq=True)
    assert serve_cache_shardings(model, ModelAxis(size=1), batch=1,
                                 capacity=S, shard_seq=True) == {
        "group_0": {"k": None, "v": None}}


def test_straddling_gqa_groups_build_and_run():
    """H = 12, K = 3 at M = 2 (refused before the head runs: M divides K D
    and H D): rank 0's query heads 0-5 read KV heads 0 and 1, rank 1's
    6-11 read 1 and 2, GQA group 1 straddling the two; each rank's
    ``wq`` / ``wk`` / ``wv`` / ``wo`` shards follow, and a rank's prefill
    and decode run (on meta: the dry run's count, its collectives
    charged; the flash kernel's meta path takes D = 64)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.steps import build_serve_plan
    from repro_torch.models.parallel import ModelAxis
    from repro_torch.models.transformer import Transformer

    cfg = _cfg("llama3.2-1b", n_heads=12, n_kv_heads=3, head_dim=64)
    d = cfg.head_dim
    for r, (q, kv) in enumerate(((slice(0, 6), slice(0, 2)),
                                 (slice(6, 12), slice(1, 3)))):
        axis = ModelAxis(size=2, rank=r)
        shards = Transformer(cfg, axis=axis).param_shards()
        assert shards["group_0/attn/wq"] == ((2, slice(q.start * d,
                                                       q.stop * d)),)
        assert shards["group_0/attn/wo"] == ((1, slice(q.start * d,
                                                       q.stop * d)),)
        assert shards["group_0/attn/wk"] == ((2, slice(kv.start * d,
                                                       kv.stop * d)),)
        arch = dataclasses.replace(smoke_arch("llama3.2-1b"), model=cfg)
        for shape in (ShapeSpec("p", S, B, "prefill"),
                      ShapeSpec("d", S, B, "decode")):
            plan = build_serve_plan(arch, axis, shape_name="p", shape=shape)
            assert plan.model.groups[0].share.off == (0, 2)[r]
            assert plan.cost().coll_calls["all-reduce"] > 0


def test_training_refuses_an_m_not_dividing_the_mlstm_heads():
    """xlstm-125m's smoke config (H = 4 mLSTM heads) trains over M = 2
    ranks and over M = 8 (ranks 0, 2, 4 and 6 hold no head: M divides its
    column leaves); M = 3, which divides none of them, is refused by the
    train plan with a ``ValueError`` naming the heads; at M = 1 its plan
    builds with no axis."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.steps import build_train_plan

    arch = smoke_arch("xlstm-125m")
    shape = ShapeSpec("t", 8, 4, "train")
    assert build_train_plan(arch, 2, shape=shape,
                            model_shards=2).model.axis.size == 2
    plan = build_train_plan(arch, 2, shape=shape, model_shards=8)
    assert plan.model.axis.size == 8
    assert plan.model.param_shards()[
        "group_0/mlstm/cell/w_q"][0][1] == slice(0, 0)
    with pytest.raises(ValueError, match="n_heads"):
        build_train_plan(arch, 2, shape=shape, model_shards=3)
    assert build_train_plan(arch, 2, shape=shape).model.axis.off


def test_groupless_ranks_are_refused():
    """A rank of M = 2 without a process group serves and trains nothing
    on real tensors (its collectives have no peer; meta is the dry run's)."""
    from repro_torch.models.parallel import ModelAxis
    from repro_torch.models.transformer import Transformer

    cfg = smoke_arch("llama3.2-1b").model
    model = Transformer(cfg, axis=ModelAxis(size=2))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="process group"):
        model.prefill(params, {"tokens": tokens})
    with pytest.raises(RuntimeError, match="process group"):
        model.loss_fn(params, {"tokens": tokens})
