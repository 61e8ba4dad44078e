"""The rest of the model axis: head counts that M does not divide, and the
sequence-sharded decode of a global batch of one over "data" (the
reference's ``shard_seq``), against the reference's GSPMD programs on the
forced 4-device host mesh (``tests/conftest.py``) and against the port's
own unsharded plan.

One 4-rank gloo world serves the module (:func:`inputs` spawns it as
``tests/test_torch_model_axis.py`` spawns its own, and it runs while the
reference's programs compile). Each rank runs:

* on the (1, 4) mesh, five smoke configs whose heads M = 4 does not
  divide (rank r holds query heads [floor(r H / 4), floor((r + 1) H / 4))):
  llama3.2-1b's at H = 6, K = 2 and at H = 6, K = 3 (rank 1's heads 1-2
  read KV heads 0 and 1: a GQA group straddles two ranks, and rank 1
  counts only KV head 1's columns), gemma3-1b's at H = 2, K = 1 (ranks 0
  and 2 hold no heads), an mLSTM of 6 heads (xlstm-125m's at d_model 96)
  and a plain Mamba2 group of 6 heads (d_model 192): a prefill of S tokens
  and STEPS decode steps sampled with Gumbel noise keyed by step, and two
  PartPSP rounds from its cut of the reference's initial state, fed its
  cut of the reference's noise bits;
* on the (4, 1) and (2, 2) meshes, the sequence-sharded decode of
  gemma3-1b's smoke config with a ring-buffer group (every layer at window
  8) before its mixed-window group, and of zamba2-7b's: DSTEPS steps from
  a seeded whole cache of T slots (the rank's cut of it), at positions T -
  DSTEPS ... T - 1, teacher-forced with seeded tokens.

This module imports JAX only in fixtures, so the ranks import torch and
the port alone.

Tolerances: those of ``tests/test_torch_model_axis.py`` and
``tests/test_torch_model_axis_train.py``. The sharded prefill and decode
against the reference's at rtol 1e-4 / atol 1e-4, against the port's unsharded
plan at atol 1e-5 (the M-way split of the sums, and for the split slots
the data ranks' merge, change an order), the greedy or sampled tokens
exactly; the PartPSP state after two rounds against the reference's
(llama-h6k3's not: one compile less) and the port's unsharded plan at
rtol 1e-4 / atol 1e-5 (or 1e-7 of a leaf's largest entry: the noise
norms reach ~1e9). Data ranks agree bit for
bit. The c10d calls of a step equal the code's count and the dry run's
meta count of the rank.
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
HEAD_MESH = (1, 4)
HEAD_CASES = ("llama-h6k2", "llama-h6k3", "gemma-h2k1", "xlstm-h6",
              "mamba2-h6")
# the head cases whose two PartPSP rounds are held against the
# reference's GSPMD step too (llama-h6k3's against the unsharded plan
# only: one compile less)
TRAIN_REF_CASES = ("llama-h6k2", "gemma-h2k1", "xlstm-h6", "mamba2-h6")
SEQ_MESHES = ((4, 1), (2, 2))
SEQ_CASES = ("gemma-ring", "zamba2")
T, DSTEPS = 16, 4          # the split decode: slots, steps
SEED = 2033
RTOL = ATOL = 1e-4         # serving, against the reference
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5
PORT_TOL = 1e-5            # against the port's unsharded plan
JOIN_LIMIT_S = 300
PG_TIMEOUT_S = 90


# -- the cases -----------------------------------------------------------------

def case_arch(name: str):
    """The case's arch: a smoke config with the case's heads (its
    ``split_layers`` rules cut to one layer of the two)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import MambaGroup

    def arch_of(base: str, **kw):
        spec = get_config(base)
        rules = tuple((pat, ("split_layers", 1) if isinstance(act, tuple)
                       else act) for pat, act in spec.shared_rules)
        return dataclasses.replace(
            spec, model=dataclasses.replace(spec.smoke, **kw),
            shared_rules=rules)

    if name == "llama-h6k2":
        return arch_of("llama3.2-1b", n_heads=6, n_kv_heads=2)
    if name == "llama-h6k3":
        return arch_of("llama3.2-1b", n_heads=6, n_kv_heads=3)
    if name == "gemma-h2k1":
        return arch_of("gemma3-1b", n_heads=2, n_kv_heads=1)
    if name == "xlstm-h6":
        return arch_of("xlstm-125m", d_model=96, n_heads=6, n_kv_heads=6)
    if name == "mamba2-h6":
        arch = arch_of("zamba2-7b", d_model=192,
                       groups=(MambaGroup(n_layers=2, d_state=16),))
        return dataclasses.replace(arch, shared_rules=(
            ("group_0/.*", "shared"),))
    if name == "gemma-ring":
        from repro_torch.models.config import AttnGroup

        mixed = get_config("gemma3-1b").smoke.groups[0]
        return arch_of("gemma3-1b", groups=(
            AttnGroup(n_layers=1, windows=(8,), thetas=(10_000.0,)), mixed))
    if name == "zamba2":
        return arch_of("zamba2-7b")
    raise KeyError(name)


def seq_shape():
    from repro_torch.configs import ShapeSpec

    return ShapeSpec("long", T, 1, "decode")


def seq_inputs(arch) -> dict:
    """The split decode's whole cache (numpy, the port's and the
    reference's layout: seeded K/V and recurrent states) and each step's
    token."""
    from repro_torch.core.tree_utils import tree_flatten_with_path
    from repro_torch.models.transformer import Transformer

    rng = np.random.default_rng(SEED + 7)
    meta = Transformer(arch.model).init_cache(1, T, device="meta")
    cache = {p: (rng.normal(size=tuple(x.shape)) * (0.1 if p.endswith("/h")
                                                    else 0.5))
             .astype(np.float32)
             for p, x in tree_flatten_with_path(meta)[0]}
    tokens = rng.integers(0, arch.model.vocab_size, size=(DSTEPS, 1))
    return {"cache": cache, "tokens": tokens}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, x in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return out


def seq_collectives(cfg, data: int) -> int:
    """The c10d calls of one split decode step on a rank, as the code is
    written: the embedding's sum and the logits' vocabulary gather over
    "model" (issued whatever M with a group), each attention layer's ``wo``
    and MLP sums, each Mamba2 layer's ``w_out`` sum, and with a data dim
    above 1 each attention application's MAX and SUM over "data"."""
    merge = 2 if data > 1 else 0
    calls = 2
    for g in cfg.groups:
        if g.kind == "attn":
            calls += (2 + merge) * g.n_layers
        elif g.kind == "zamba":
            calls += g.n_units * (g.mamba_per_unit + 2 + merge) \
                + g.trailing_mamba
    return calls


# -- what each rank runs -------------------------------------------------------

def head_rank(mesh, name: str, inp: dict) -> dict:
    """Serving and two PartPSP rounds of a head case on ``mesh``."""
    from test_torch_model_axis import serve
    from test_torch_model_axis_train import (ROUNDS, plan_of, whole_state,
                                             _leaf_dict)

    from repro_torch.core.tree_utils import tree_flatten
    from repro_torch.launch.op_analysis import CollectiveCount
    from repro_torch.launch.sharding import (gather_params,
                                             gather_train_state, node_rows,
                                             shard_params, shard_train_state,
                                             train_state_shardings)
    from repro_torch.models.parallel import take
    from repro_torch.models.transformer import Transformer

    arch = case_arch(name)
    out = serve(arch, mesh, inp["params"])
    whole = Transformer(arch.model)
    back = gather_params(shard_params(inp["params"], mesh, whole), mesh,
                         whole)
    out["gathered_equal"] = all(
        torch.equal(x, y) for x, y in zip(tree_flatten(back)[0],
                                          tree_flatten(inp["params"])[0]))

    plan = plan_of(arch, mesh)
    state0, model, part = whole_state(arch, inp["stacked"])
    state = shard_train_state(state0, mesh, model, part)
    pairs = train_state_shardings(state0, mesh, model, part).dpps.push.s
    tokens = torch.from_numpy(inp["tokens"])[node_rows(mesh, 4)]
    out["train_calls"] = []
    for t in range(ROUNDS):
        bits = [take(torch.from_numpy(b), p)
                for b, p in zip(inp["bits"][t], pairs)]
        count = CollectiveCount()
        with count:
            state, _ = plan.step_fn(state, {"tokens": tokens}, seed=SEED,
                                    bits=bits)
        out["train_calls"].append(dict(count.calls))
    out["final"] = _leaf_dict(gather_train_state(state, mesh, model, part))
    out["columns"] = plan.columns.counted
    return out


def seq_rank(mesh, name: str, inp: dict) -> dict:
    """The split decode of a sequence case on ``mesh``: its logits and
    each step's c10d calls."""
    from repro_torch.core.tree_utils import tree_flatten_with_path
    from repro_torch.launch.op_analysis import CollectiveCount
    from repro_torch.launch.sharding import shard_cache
    from repro_torch.launch.steps import build_serve_plan

    arch = case_arch(name)
    plan = build_serve_plan(arch, mesh, shape_name="long", shape=seq_shape())
    model = plan.model
    params = model.shard_params(inp["params"])
    whole = _nest({p: torch.from_numpy(x) for p, x in inp["cache"].items()})
    cache = shard_cache(whole, mesh, model, batch=1, capacity=T,
                        shard_seq=True)
    logits, calls = [], []
    for i in range(DSTEPS):
        count = CollectiveCount()
        with count:
            lg, cache = plan.step_fn(
                params, cache, torch.from_numpy(inp["tokens"][i]),
                T - DSTEPS + i)
        logits.append(lg.clone())
        calls.append(dict(count.calls))
    axis = model.axis
    return {"logits": torch.stack(logits), "calls": calls,
            "axis": (axis.size, axis.rank, axis.data_size, axis.data_rank),
            "seq_split": axis.seq_split,
            "slots": next(x.shape[-3] for p, x in tree_flatten_with_path(
                model.init_cache(1, T, device="meta"))[0]
                if p.endswith("/k"))}


def rank_main(rank: int, store: str, out_dir: str, inputs_path: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        results = {}
        mesh = make_host_mesh(shape=HEAD_MESH)
        for name in HEAD_CASES:
            results[name] = head_rank(mesh, name, inputs["heads"][name])
        for shape in SEQ_MESHES:
            mesh = make_host_mesh(shape=shape)
            for name in SEQ_CASES:
                results[(shape, name)] = seq_rank(mesh, name,
                                                  inputs["seq"][name])
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


def _host_mesh(shape):
    import jax
    from jax.sharding import Mesh

    if len(jax.devices()) < WORLD:
        pytest.skip("needs 4 forced host devices (see conftest XLA_FLAGS)")
    return Mesh(np.asarray(jax.devices()[:WORLD]).reshape(shape),
                ("data", "model"))


def _head_case(R, name: str, keys) -> dict:
    """The reference's model, its params (numpy, and converted for the
    port), and its PartPSP case: partition, initial state (each node's
    params its own), batch and each round's noise bits."""
    import jax
    import jax.numpy as jnp
    from test_torch_model_axis_train import N, B as TB, S as TS, _ref_cfg
    from test_torch_models import cfg_to_reference
    from test_torch_reference import reference_tree_bits

    from repro_torch import convert

    arch = case_arch(name)
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
    tokens = rng.integers(0, arch.model.vocab_size, size=(N, TB, TS),
                          dtype=np.int32)
    bits = [reference_tree_bits(jax.random.split(k, 3)[2], st.dpps.push.s)
            for k in keys]
    return dict(model=model, ref_params=params, part=part, state=st,
                stacked=stacked, tokens=tokens, bits=bits,
                params=convert.transformer_params_from_reference(
                    params, arch.model, device="cpu"))


@pytest.fixture(scope="module")
def inputs(R, tmp_path_factory):
    """The reference's cases, saved for the world, whose ranks start here
    (they run while :func:`reference` compiles)."""
    import jax
    import torch.multiprocessing as mp
    from test_torch_model_axis_train import ROUNDS
    from test_torch_models import cfg_to_reference

    from repro_torch import convert

    _host_mesh(HEAD_MESH)
    keys = [jax.random.PRNGKey(SEED + t) for t in range(ROUNDS)]
    heads = {name: _head_case(R, name, keys) for name in HEAD_CASES}
    seq = {}
    for name in SEQ_CASES:
        arch = case_arch(name)
        model = R.models.Transformer(cfg_to_reference(R, arch.model))
        params = jax.tree_util.tree_map(np.asarray,
                                        model.init(jax.random.PRNGKey(1)))
        seq[name] = dict(model=model, ref_params=params, **seq_inputs(arch),
                         params=convert.transformer_params_from_reference(
                             params, arch.model, device="cpu"))
    tmp = tmp_path_factory.mktemp("model_axis_uneven")
    path = tmp / "inputs.pt"
    torch.save({"heads": {n: {k: c[k] for k in ("params", "stacked",
                                                 "tokens", "bits")}
                          for n, c in heads.items()},
                "seq": {n: {k: c[k] for k in ("params", "cache", "tokens")}
                        for n, c in seq.items()}}, path)
    ctx = mp.start_processes(rank_main, args=(str(tmp / "store"), str(tmp),
                                              str(path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    out = {"heads": heads, "seq": seq, "keys": keys, "tmp": tmp,
           "ctx": ctx, "t0": time.monotonic()}
    yield out
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
        p.join()


@pytest.fixture(scope="module")
def reference(R, inputs):
    """The reference's GSPMD runs: the head cases' prefill jitted with
    ``serve_param_shardings`` and their two PartPSP rounds jitted with
    ``train_state_shardings`` on the (1, 4) host mesh; the sequence cases'
    DSTEPS decode steps jitted with ``serve_cache_shardings(shard_seq=
    True)`` on the (4, 1) and (2, 2) meshes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from test_torch_model_axis import prompt_of
    from test_torch_model_axis_train import N, _ref_cfg, _ref_path

    sh = R.launch.sharding
    mesh = _host_mesh(HEAD_MESH)
    heads = inputs["heads"]
    shard = {n: sh.serve_param_shardings(c["model"], mesh)
             for n, c in heads.items()}
    batches = {n: prompt_of(case_arch(n).model) for n in HEAD_CASES}
    batch_sh = {n: {k: NamedSharding(mesh, P("data", *(None,) * (v.ndim - 1)))
                    for k, v in b.items()} for n, b in batches.items()}
    prefill = jax.jit(
        lambda ps, bs: {n: heads[n]["model"].prefill(ps[n], bs[n])[0]
                        for n in HEAD_CASES},
        in_shardings=(shard, batch_sh))
    pre = jax.tree_util.tree_map(np.asarray, prefill(
        {n: c["ref_params"] for n, c in heads.items()}, batches))

    cfg = _ref_cfg(R)
    w = R.core.topology.DOutGraph(n_nodes=N, d=2).weight_matrix_jnp(0)
    states = {n: c["state"] for n, c in heads.items()}
    tok = {n: {"tokens": jnp.asarray(c["tokens"])} for n, c in heads.items()}
    st_sh = {n: sh.train_state_shardings(c["model"], c["part"], mesh)
             for n, c in heads.items()}
    tok_sh = {n: sh.train_batch_shardings(tok[n], mesh) for n in heads}

    final = {}
    for name in TRAIN_REF_CASES:
        c = heads[name]
        # one round of an arch compiled, run twice (its output placed as
        # its input)
        step = jax.jit(lambda st, bs, k, c=c: R.core.partpsp.partpsp_step(
            st, bs, k, cfg=cfg, partition=c["part"],
            loss_fn=c["model"].loss_fn, w=w)[0], in_shardings=(
                st_sh[name], tok_sh[name], NamedSharding(mesh, P())),
            out_shardings=st_sh[name])
        final[name] = states[name]
        for k in inputs["keys"]:
            final[name] = step(final[name], tok[name], k)
    trained = {n: {_ref_path(kp): np.asarray(x) for kp, x in
                   jax.tree_util.tree_flatten_with_path(st)[0]}
               for n, st in final.items()}

    decoded = {}
    for shape in SEQ_MESHES:
        m = _host_mesh(shape)
        for name, c in inputs["seq"].items():
            model = c["model"]
            cache = jax.tree_util.tree_map(jnp.asarray, _nest(c["cache"]))
            c_sh = sh.serve_cache_shardings(model, m, shard_seq=True)
            p_sh = sh.serve_param_shardings(model, m)

            def steps(ps, ch, toks, model=model):
                out = []
                for i in range(DSTEPS):
                    lg, ch = model.decode_step(ps, ch, toks[i],
                                               T - DSTEPS + i)
                    out.append(lg)
                return jnp.stack(out)

            decoded[(shape, name)] = np.asarray(jax.jit(
                steps, in_shardings=(p_sh, c_sh, NamedSharding(m, P())))(
                    c["ref_params"], cache, jnp.asarray(c["tokens"])))
    return {"prefill": pre, "trained": trained, "decoded": decoded}


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
    """The port's unsharded plans on the same params and inputs: the head
    cases' serving and two PartPSP rounds (the reference's bits whole),
    the sequence cases' decode steps from the whole cache."""
    from test_torch_model_axis import serve
    from test_torch_model_axis_train import (ROUNDS, plan_of, whole_state,
                                             _leaf_dict)

    out = {}
    for name in HEAD_CASES:
        c = inputs["heads"][name]
        arch = case_arch(name)
        r = serve(arch, None, c["params"])
        plan = plan_of(arch, None)
        state, _, _ = whole_state(arch, c["stacked"])
        for t in range(ROUNDS):
            state, _ = plan.step_fn(
                state, {"tokens": torch.from_numpy(c["tokens"])}, seed=SEED,
                bits=[torch.from_numpy(b) for b in c["bits"][t]])
        r["final"] = _leaf_dict(state)
        out[name] = r
    from repro_torch.launch.steps import build_serve_plan

    for name in SEQ_CASES:
        c = inputs["seq"][name]
        plan = build_serve_plan(case_arch(name), None, shape_name="long",
                                shape=seq_shape())
        cache = _nest({p: torch.from_numpy(x).clone()
                       for p, x in c["cache"].items()})
        logits = []
        for i in range(DSTEPS):
            lg, cache = plan.step_fn(c["params"], cache,
                                     torch.from_numpy(c["tokens"][i]),
                                     T - DSTEPS + i)
            logits.append(lg)
        out[name] = torch.stack(logits)
    return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _state_close(got: np.ndarray, want: np.ndarray, path: str) -> None:
    atol = max(TRAIN_ATOL, 1e-7 * float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL, atol=atol,
                               err_msg=path)


# -- the share rule (no world) -------------------------------------------------

@pytest.mark.parametrize("h, k, m, want", [
    (6, 2, 4, [(0, 1, 0, 1), (1, 2, 0, 1), (3, 1, 1, 1), (4, 2, 1, 1)]),
    (6, 3, 4, [(0, 1, 0, 1), (1, 2, 0, 2), (3, 1, 1, 1), (4, 2, 2, 1)]),
    (2, 1, 4, [(0, 0, 0, 0), (0, 1, 0, 1), (1, 0, 0, 0), (1, 1, 0, 1)]),
    (40, 8, 16, None),
])
def test_a_rank_holds_whole_heads_and_the_kv_heads_they_read(h, k, m, want):
    """Rank r's query heads are [floor(r H / M), floor((r + 1) H / M)) and
    its KV heads those they read (q // (H / K)); the runs cover every
    head once, the KV runs every KV head, each KV head owned by its first
    holder. llama4-scout's 40 heads over 16 ranks: runs of 2 and 3."""
    from repro_torch.models.parallel import ModelAxis, owned_runs

    shares = [ModelAxis(size=m, rank=r).attn_heads(h, k) for r in range(m)]
    if want is not None:
        assert [(s.q0, s.h, s.k0, s.kv) for s in shares] == want
    assert sum(s.h for s in shares) == h
    assert [s.q0 for s in shares] == sorted(s.q0 for s in shares)
    kv = [slice(s.k0, s.k0 + s.kv) for s in shares]
    owned = owned_runs(kv)
    assert sum(o.stop - o.start for o in owned) == k
    assert {s.h for s in shares if s.h} <= {h // m, -(-h // m)}
    for s in shares:
        if s.h:
            assert s.off == s.q0 - s.k0 * (h // k) and 0 <= s.off < h // k


@pytest.mark.parametrize("q0, h", [(3, 3), (5, 2), (0, 5), (4, 0)])
def test_plain_flash_at_a_head_offset_is_the_whole_attentions_heads(q0, h):
    """The plain version of ``flash_attention.cu`` at a head offset: a
    rank's run of scout-like heads (H = 10, K = 2, group 5) against the
    whole model's attention cut to those heads, bit for bit; the model's
    wrapper on the CPU routes to it, and no heads gives an empty output."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(q0 + 10 * h)
    s, d, group = 9, 8, 5
    q_all = torch.randn((1, s, 10, d), generator=gen)
    k_all = torch.randn((1, s, 2, d), generator=gen)
    v_all = torch.randn((1, s, 2, d), generator=gen)
    k0 = q0 // group
    k1 = (q0 + h - 1) // group + 1 if h else k0
    q, k, v = (q_all[:, :, q0:q0 + h], k_all[:, :, k0:k1],
               v_all[:, :, k0:k1])
    got = ops.flash_attention_bshd(q, k, v, window=4, group=group,
                                   head0=q0 - k0 * group)
    assert got.shape == q.shape
    if h:
        whole = ref.flash_attention(q_all.transpose(1, 2),
                                    k_all.transpose(1, 2),
                                    v_all.transpose(1, 2), group=group,
                                    window=4).transpose(1, 2)
        torch.testing.assert_close(got, whole[:, :, q0:q0 + h], rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="exactly"):
        ops.flash_attention_bshd(q_all[:, :, 3:6], k_all[:, :, :1],
                                 v_all[:, :, :1], group=group, head0=3)


def test_a_partly_counted_leaf_counts_its_owned_kv_heads():
    """A rank whose first KV head another rank counts (rank 1 of H = 6, K
    = 3 at M = 4) counts only the rest of its ``wk`` / ``wv`` columns in
    every per-node norm: the plain and the tree norms of the part, and the
    perturbation's two norms from a second pass over it with its Philox
    columns."""
    from repro_torch.core.tree_utils import l1_norm_per_node
    from repro_torch.kernels import ref
    from repro_torch.kernels.ref import ColumnMap

    gen = torch.Generator().manual_seed(3)
    d = 4
    s = torch.randn((3, 2, 5, 2 * d), generator=gen)   # (N, L, d_model, 2 D)
    e = torch.randn((3, 2, 5, 2 * d), generator=gen)
    keep = slice(d, 2 * d)
    part = s[..., keep].reshape(3, -1)
    torch.testing.assert_close(l1_norm_per_node([s], [keep]),
                               part.abs().sum(1))
    torch.testing.assert_close(ref.l1_norm_tree([s], [keep]),
                               part.abs().sum(1))
    cmap = ColumnMap(100, 2 * d, 3 * d, 0)       # KV heads 0-1 of 3
    out, e1, n1 = ref.dpps_perturb_tree([s], [e], 0.5, 1.0, seed=7, t=2,
                                        col_maps=[cmap], counted=[keep])
    full, _, _ = ref.dpps_perturb_tree([s], [e], 0.5, 1.0, seed=7, t=2,
                                       col_maps=[cmap])
    assert torch.equal(out[0], full[0])
    bits = ref.philox_map(7, 2, 3, ref.counted_map(cmap, keep), 40)
    noise = ref.laplace_from_bits(bits, 0.5)
    torch.testing.assert_close((out[0] - s - e)[..., keep].reshape(3, -1),
                               noise, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(e1, e[..., keep].reshape(3, -1).abs().sum(1))
    torch.testing.assert_close(n1, noise.abs().sum(1))
    _, _, n_none = ref.dpps_perturb_tree([s], [e], 0.5, 1.0, seed=7, t=2,
                                         col_maps=[cmap], counted=[False])
    assert float(n_none.abs().max()) == 0.0


def test_the_production_mesh_splits_every_published_config():
    """``ModelAxis.check`` accepts all ten published configs at M = 8 and
    M = 16 (every leaf dim the reference's "model" pspecs cut divides
    both), though gemma3-1b, xlstm-125m, minitron-4b and the two llama4
    models have head counts M does not divide."""
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.models.parallel import ModelAxis

    uneven = set()
    for name in ARCH_NAMES:
        cfg = get_config(name).model
        for m in (8, 16):
            ModelAxis(size=m).check(cfg)
            if cfg.n_heads % m:
                uneven.add(name)
    assert {"gemma3-1b", "xlstm-125m", "minitron-4b",
            "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"} <= uneven


# -- uneven heads: serving -------------------------------------------------------

@pytest.mark.parametrize("name", HEAD_CASES)
def test_sharded_prefill_matches_the_references(world, reference, name):
    want = reference["prefill"][name]
    for rank in range(WORLD):
        np.testing.assert_allclose(_np(world[rank][name]["logits"]), want,
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", HEAD_CASES)
def test_sharded_serve_matches_the_unsharded_plan(world, unsharded, name):
    """The prefill and decode logits within 1e-5 of the unsharded plan,
    the sampled tokens equal, every rank's alike bit for bit."""
    u = unsharded[name]
    for rank in range(WORLD):
        r = world[rank][name]
        np.testing.assert_allclose(_np(r["logits"]), _np(u["logits"]),
                                   rtol=0, atol=PORT_TOL)
        np.testing.assert_allclose(_np(r["decode_logits"]),
                                   _np(u["decode_logits"]), rtol=0,
                                   atol=PORT_TOL)
        assert torch.equal(r["tokens"], u["tokens"])
        assert torch.equal(r["decode_logits"], world[0][name]["decode_logits"])


@pytest.mark.parametrize("name", HEAD_CASES)
def test_serve_collectives_equal_the_codes_count(world, name):
    """Ranks with and without heads issue the same sums, as the code counts
    them (``test_torch_model_axis`` / ``_groups``' formulas)."""
    import test_torch_model_axis as ma
    import test_torch_model_axis_groups as mg

    cfg = case_arch(name).model
    count = ma.expected_collectives if cfg.groups[0].kind == "attn" \
        else mg.serve_collectives
    want = [count(cfg, ma.B, ma.S)] + [count(cfg, ma.B, 1)] * ma.STEPS
    for rank in range(WORLD):
        got = world[rank][name]["calls"]
        assert got == [{k: tuple(v) for k, v in w.items()} for w in want]


@pytest.mark.parametrize("name", HEAD_CASES)
def test_gather_of_uneven_shards_is_the_whole(world, name):
    assert all(world[r][name]["gathered_equal"] for r in range(WORLD))


def test_ranks_without_heads_hold_empty_blocks(world):
    """gemma3-1b at H = 2 over 4 ranks: ranks 0 and 2 hold no query head
    and no KV head (empty blocks of ``wq`` / ``wk`` / ``wv`` / ``wo`` and
    of the cache), ranks 1 and 3 one head each of the one KV head, which
    rank 1 counts."""
    for rank in range(WORLD):
        r = world[rank]["gemma-h2k1"]
        wq = r["params"]["group_0"]["attn"]["wq"]
        k = r["cache"]["group_0/k"]
        assert wq.shape[-1] == (32 if rank % 2 else 0)
        assert k.shape[-2] == (1 if rank % 2 else 0)
    counted = [dict(enumerate(world[r]["gemma-h2k1"]["columns"]))
               for r in range(WORLD)]
    assert counted[1] != counted[3]


# -- uneven heads: training ------------------------------------------------------

@pytest.mark.parametrize("name", TRAIN_REF_CASES)
def test_state_after_two_rounds_matches_the_reference(world, reference,
                                                      name):
    want = reference["trained"][name]
    for rank in range(WORLD):
        got = world[rank][name]["final"]
        assert set(got) <= set(want)
        for path, x in got.items():
            _state_close(_np(x), want[path], path)


@pytest.mark.parametrize("name", HEAD_CASES)
def test_state_after_two_rounds_matches_the_unsharded_plan(world, unsharded,
                                                           name):
    want = unsharded[name]["final"]
    for rank in range(WORLD):
        for path, x in world[rank][name]["final"].items():
            _state_close(_np(x), _np(want[path]), path)


def test_a_straddled_kv_head_is_counted_in_part():
    """llama3.2-1b's smoke layers at H = 6, K = 3 over 4 ranks: rank 1's
    ``wk`` / ``wv`` hold KV heads 0 and 1 and count only head 1's columns
    (rank 0 counts head 0), rank 2's hold head 1 and count none, rank 3's
    head 2."""
    from repro_torch.launch.steps import build_train_plan

    arch = case_arch("llama-h6k3")
    d = arch.model.head_dim
    got = []
    for r in range(4):
        plan = build_train_plan(arch, 4, model_shards=4, model_rank=r,
                                shape_name="t", shape=_train_shape())
        paths = [p for p, a in plan.partition.leaf_plans() if a != "local"]
        kv = [c for p, c in zip(paths, plan.columns.counted)
              if p.endswith("attn/wk")]
        got.append(kv[0])
    assert got == [True, slice(d, 2 * d), False, True]


def _train_shape():
    from repro_torch.configs import ShapeSpec

    return ShapeSpec("t", 8, 4, "train")


# -- the sequence-sharded decode ------------------------------------------------

@pytest.mark.parametrize("shape", SEQ_MESHES)
@pytest.mark.parametrize("name", SEQ_CASES)
def test_split_decode_matches_the_references(world, reference, shape, name):
    want = reference["decoded"][(shape, name)]
    for rank in range(WORLD):
        got = world[rank][(shape, name)]
        assert got["seq_split"]
        np.testing.assert_allclose(_np(got["logits"]), want, rtol=RTOL,
                                   atol=ATOL)
        assert (_np(got["logits"]).argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("shape", SEQ_MESHES)
@pytest.mark.parametrize("name", SEQ_CASES)
def test_split_decode_matches_the_unsharded_plan(world, unsharded, shape,
                                                 name):
    """Within 1e-5 of the unsharded plan, the greedy tokens equal; data
    ranks (those of one model rank) bit for bit alike; each holds T / D of
    the first group's slots (the ring group's window 8 / D)."""
    want = _np(unsharded[name])
    data, m = shape
    for rank in range(WORLD):
        got = world[rank][(shape, name)]
        np.testing.assert_allclose(_np(got["logits"]), want, rtol=0,
                                   atol=PORT_TOL)
        assert (_np(got["logits"]).argmax(-1) == want.argmax(-1)).all()
        assert torch.equal(got["logits"], world[rank % m][(shape, name)]
                           ["logits"])
        full = 8 if name == "gemma-ring" else T
        assert got["slots"] == full // data


@pytest.mark.parametrize("shape", SEQ_MESHES)
@pytest.mark.parametrize("name", SEQ_CASES)
def test_split_decode_collectives_equal_the_codes_and_the_dry_runs(
        world, shape, name):
    """Each step's c10d calls: the code's count, and the dry run's meta
    count of the rank (``build_serve_plan`` over a groupless ``ModelAxis``
    of the mesh's shape: its collectives charged)."""
    from repro_torch.launch.steps import build_serve_plan
    from repro_torch.models.parallel import ModelAxis

    data, m = shape
    arch = case_arch(name)
    want = seq_collectives(arch.model, data)
    for rank in range(WORLD):
        calls = world[rank][(shape, name)]["calls"]
        assert [c["all-reduce"] for c in calls] == [want] * DSTEPS
    # on meta a model axis of one rank has no group and charges no sum
    meta = build_serve_plan(arch, ModelAxis(size=m, data_size=data),
                            shape_name="long", shape=seq_shape()).cost()
    model_sums = seq_collectives(arch.model, 1)
    assert meta.coll_calls["all-reduce"] == want - (0 if m > 1
                                                    else model_sums)


def test_split_decode_is_refused_where_the_slots_do_not_divide():
    """T = 12 slots over D = 8: a ``ValueError``; a prefill on a split
    plan: a ``ValueError`` naming the way (cut a prefill's cache)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.steps import build_serve_plan
    from repro_torch.models.parallel import ModelAxis

    arch = case_arch("gemma-ring")
    axis = ModelAxis(size=1, data_size=8)
    plan = build_serve_plan(arch, axis, shape_name="d",
                            shape=ShapeSpec("d", 12, 1, "decode"))
    with pytest.raises(ValueError, match="KV slots"):
        plan.model.init_cache(1, 12, device="meta")
    split = dataclasses.replace(axis, shard_seq=True)
    from repro_torch.models.transformer import Transformer

    with pytest.raises(ValueError, match="shard_cache"):
        Transformer(arch.model, axis=split).prefill(
            {}, {"tokens": torch.zeros((1, 4), dtype=torch.int64)})
