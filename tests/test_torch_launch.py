"""The launch tooling of the port (``repro_torch.configs.shapes``,
``launch/flops.py``, ``launch/steps.py``, ``launch/op_analysis.py``,
``launch/dryrun.py`` and the loop seam ``core/loops.py``) against the
reference's ``repro.configs.shapes``, ``repro.launch.flops``,
``repro.launch.steps`` and ``repro.launch.hlo_analysis``, on the CPU.

* Parameter counts, model FLOPs, the batch stand-ins and the abstract
  training state equal the reference's for all ten architectures (the
  reference counts through ``jax.eval_shape``, the port on the meta device).
* One ``TrainPlan.step_fn`` round of the llama3.2-1b smoke model at 4 nodes
  agrees with the reference's ``partpsp_step`` (rtol 1e-4; atol 1e-5, or
  1e-7 of a leaf's largest entry where the noise makes entries of ~1e3),
  fed the reference's noise bits, in both gradient schedules (two-pass,
  and the single-pass ``two_pass=False``).
* The counterparts of ``tests/test_hlo_analysis.py``: a loop of L matmuls
  costs L times one, nested loops multiply, a windowed cache write is
  charged the window, a one-rank gloo ``all_reduce`` is a collective.
* The loop rule's FLOPs, bytes and peak equal the unrolled run's exactly:
  the time loops (xlstm-125m's and zamba2-7b's smoke models at 16
  positions, with and without grad) and the node loop (a smoke train step
  at 4 nodes).
* ``dryrun.run_one``'s rows and ``--out``'s resume.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import (load_reference, reference_tree_bits,
                                  to_numpy)

from repro_torch.configs import (ARCH_NAMES, INPUT_SHAPES, ShapeSpec,
                                 get_config, input_specs)
from repro_torch.convert import tree_from_numpy
from repro_torch.core import loops
from repro_torch.core.partpsp import partpsp_init
from repro_torch.core.tree_utils import tree_leaves, tree_map
from repro_torch.launch import dryrun, flops
from repro_torch.launch.op_analysis import HW, analyze_step
from repro_torch.launch.steps import build_serve_plan, build_train_plan
from repro_torch.models.transformer import Transformer

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 7
SMOKE_STEP = ShapeSpec("smoke_step", 16, 8, "train")  # 2 sequences a node


@pytest.fixture(scope="module")
def R():
    repro = load_reference()
    import repro.launch.flops  # noqa: F401
    import repro.launch.steps  # noqa: F401
    return repro


@functools.lru_cache(maxsize=None)
def _port_counts(arch: str):
    return flops.param_counts(get_config(arch))


@functools.lru_cache(maxsize=None)
def _reference_counts(arch: str):
    from repro.configs import get_config as ref_config
    from repro.launch.flops import param_counts
    return param_counts(ref_config(arch))


def _smoke_arch(arch: str, R=None):
    """The arch's smoke config with its split_layers rules clamped to 1 (the
    smoke models have 2 layers)."""
    spec = R.configs.get_config(arch) if R is not None else get_config(arch)
    rules = tuple((pat, ("split_layers", 1) if isinstance(act, tuple) else act)
                  for pat, act in spec.shared_rules)
    return dataclasses.replace(spec, model=spec.smoke, shared_rules=rules)


# -- parameter counts, model FLOPs, stand-ins, abstract state ------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_match_reference(R, arch):
    assert _port_counts(arch) == _reference_counts(arch)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_match_reference(R, arch, monkeypatch):
    monkeypatch.setattr(flops, "param_counts", lambda a: _port_counts(a.name))
    monkeypatch.setattr(R.launch.flops, "param_counts",
                        lambda a: _reference_counts(a.name))
    for shape in INPUT_SHAPES:
        for chips in (1, 256):
            assert flops.model_flops_per_chip(get_config(arch), shape, chips) \
                == R.launch.flops.model_flops_per_chip(
                    R.configs.get_config(arch), shape, chips)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_specs_match_reference(R, arch):
    for shape in INPUT_SHAPES:
        got = input_specs(get_config(arch), shape)
        want = R.configs.input_specs(R.configs.get_config(arch), shape)
        assert set(got) == set(want)
        for k, spec in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(spec.shape), (shape, k)
            assert str(got[k].dtype).split(".")[-1] == str(spec.dtype), (shape, k)


def _leaf_shapes(tree) -> list:
    return [() if isinstance(x, int) else tuple(x.shape)
            for x in tree_leaves(tree)]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_state_matches_reference(R, arch):
    """The meta ``PartPSPState`` and its partition against the reference's
    ``_abstract_state`` at 16 nodes (its model, rules and default config,
    as ``build_train_plan`` makes them)."""
    plan = build_train_plan(get_config(arch), 16)
    state = plan.abstract_args()[0]
    assert all(x.device.type == "meta" for x in tree_leaves(state)
               if isinstance(x, torch.Tensor))
    spec = R.configs.get_config(arch)
    model = R.models.Transformer(spec.model)
    shapes = jax.eval_shape(lambda k: model.init(k), jax.random.PRNGKey(0))
    stacked = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((16,) + x.shape, x.dtype), shapes)
    part = R.core.partition.Partition.from_rules(stacked, spec.shared_rules,
                                                 default="local")
    c_prime, lam = R.core.topology.derive_constants(
        R.core.topology.DOutGraph(n_nodes=16, d=2))
    cfg = R.core.partpsp.PartPSPConfig(
        gamma_l=0.05, gamma_s=0.05, clip=100.0,
        dpps=R.core.dpps.DPPSConfig(b=1.0, gamma_n=0.01, c_prime=c_prime,
                                    lam=lam))
    want = R.launch.steps._abstract_state(model, part, cfg, 16)
    assert _leaf_shapes(state) == [tuple(x.shape)
                                   for x in jax.tree_util.tree_leaves(want)]
    assert plan.partition.d_shared() == part.d_shared()
    assert plan.partition.d_local() == part.d_local()
    assert (plan.cfg.dpps.c_prime, plan.cfg.dpps.lam) == (c_prime, lam)


# -- one training step against the reference --------------------------------------

def _step_arch(R=None):
    """llama3.2-1b's smoke model at one layer, with two shared leaves (each
    layer and shared leaf adds to the reference's compile, and to the
    port's ops on a loaded CPU)."""
    spec = R.configs.get_config("llama3.2-1b") if R is not None \
        else get_config("llama3.2-1b")
    group = dataclasses.replace(spec.smoke.groups[0], n_layers=1)
    return dataclasses.replace(
        spec, model=dataclasses.replace(spec.smoke, groups=(group,)),
        shared_rules=(("group_0/attn/w[qk]", "shared"),))


@pytest.fixture(scope="module")
def reference_steps(R):
    """The reference's ``partpsp_step`` on llama3.2-1b's smoke model (one
    layer), 4 nodes, 2 x 16 tokens a node, noise on, with the cfg,
    partition and dense W its ``build_train_plan`` makes (that needs a mesh
    of 4 gossip nodes, so this builds them as it does): the two-pass step
    and the single-pass one (``two_pass=False``) from the same state, key
    and batch, in one jitted call (one compile for both)."""
    ref_arch, n = _step_arch(R), 4
    ref_model = R.models.Transformer(ref_arch.model)
    # the port's init (the reference's costs a compile); both steps take it
    params = tree_map(to_numpy, Transformer(_step_arch().model).init(
        torch.Generator().manual_seed(SEED), device="cpu"))
    stacked = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(x[None], (n,) + x.shape).copy(), params)
    jparams = jax.tree_util.tree_map(jnp.asarray, stacked)
    rpart = R.core.partition.Partition.from_rules(
        jparams, ref_arch.shared_rules, default="local")
    topo = R.core.topology.DOutGraph(n_nodes=n, d=2)
    c_prime, lam = R.core.topology.derive_constants(topo)
    cfg = R.core.partpsp.PartPSPConfig(
        gamma_l=0.05, gamma_s=0.05, clip=100.0,
        dpps=R.core.dpps.DPPSConfig(b=1.0, gamma_n=0.01, c_prime=c_prime,
                                    lam=lam, use_kernels=True))
    cfgs = (cfg, dataclasses.replace(cfg, two_pass=False))
    rst = R.core.partpsp.partpsp_init(jparams, rpart, cfg)
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, ref_arch.model.vocab_size, size=(n, 2, 16),
                          dtype=np.int32)
    key = jax.random.PRNGKey(SEED)
    bits = reference_tree_bits(jax.random.split(key, 3)[2], rst.dpps.push.s)
    w = topo.weight_matrix_jnp(0)
    two, one = jax.jit(lambda st, b, k: tuple(
        R.core.partpsp.partpsp_step(st, b, k, cfg=c, partition=rpart,
                                    loss_fn=ref_model.loss_fn, w=w)
        for c in cfgs))(rst, {"tokens": jnp.asarray(tokens)}, key)
    return dict(stacked=stacked, tokens=tokens, bits=bits, two_pass=two,
                single_pass=one)


def _port_step(ref, monkeypatch, **plan_kw):
    """The port's ``TrainPlan.step_fn`` on the CPU from the reference's
    state, batch and noise bits -> (state, metrics, gradient passes)."""
    from repro_torch.core import partpsp

    passes = []
    grads = partpsp._grads
    monkeypatch.setattr(partpsp, "_grads",
                        lambda *a: passes.append(1) or grads(*a))
    plan = build_train_plan(_step_arch(), 4, shape=SMOKE_STEP, **plan_kw)
    state = partpsp_init(tree_from_numpy(ref["stacked"], device="cpu"),
                         plan.partition, plan.cfg)
    st, m = plan.step_fn(state, {"tokens": torch.from_numpy(ref["tokens"])},
                         SEED, bits=[torch.from_numpy(b) for b in ref["bits"]])
    return st, m, len(passes)


def _assert_step_matches(st, m, rst, rm):
    """Losses and the largest shared-gradient L1 norm at rtol 1e-4; the
    shared and local leaves at rtol 1e-4 and atol 1e-5, or 1e-7 of a
    leaf's largest entry (the default gamma_n = 0.01 at this sensitivity
    gives noise of ~1e3: an f32 rounding of the sum)."""
    for k in ("loss_per_node", "grad_l1_max"):
        np.testing.assert_allclose(to_numpy(m[k]), np.asarray(rm[k]),
                                   rtol=1e-4, err_msg=k)
    for got, want in zip(tree_leaves(st.dpps.push.s) + list(st.local),
                         jax.tree_util.tree_leaves(rst.dpps.push.s)
                         + list(rst.local)):
        want = np.asarray(want)
        np.testing.assert_allclose(to_numpy(got), want, rtol=1e-4,
                                   atol=max(1e-5, 1e-7 * np.abs(want).max()))
    assert st.dpps.t == int(rst.dpps.t) == 1


def test_train_step_matches_reference(reference_steps, monkeypatch):
    """The two-pass round (the default) against the reference's, in two
    gradient passes."""
    st, m, passes = _port_step(reference_steps, monkeypatch)
    _assert_step_matches(st, m, *reference_steps["two_pass"])
    assert passes == 2


def test_single_pass_step(reference_steps, monkeypatch):
    """``two_pass=False`` (the reference's fused variant) against the
    reference's, at gamma_l = 0.05: both gradients in one pass, the shared
    one at (y, l_t). The two variants' shared gradients differ here well
    beyond the tolerance, so a shared gradient taken at (y, l_{t+1}) would
    fail."""
    rm_two, rm_one = (float(reference_steps[k][1]["grad_l1_max"])
                      for k in ("two_pass", "single_pass"))
    assert abs(rm_two - rm_one) > 1e-3 * abs(rm_one)
    st, m, passes = _port_step(reference_steps, monkeypatch, two_pass=False)
    _assert_step_matches(st, m, *reference_steps["single_pass"])
    assert passes == 1


# -- the cost count: the counterparts of tests/test_hlo_analysis.py -----------------

D = 256


def _matmul_loop(x, ws):
    def step(h, inp):
        h = torch.tanh(h @ inp[0])
        return h, h

    return loops.time_loop(step, x, (ws,), dim=0, out_dim=0)[1].sum()


@pytest.mark.parametrize("rule", [True, False])
def test_loop_of_matmuls_costs_its_trip_count(rule):
    x = torch.empty((32, D), device="meta")
    ws = torch.empty((8, D, D), device="meta")
    terms = analyze_step(_matmul_loop, x, ws, arch="a", shape="s", nodes=1,
                         model_flops=0.0, loop_rule=rule)
    assert terms.flops == 8 * 2 * 32 * D * D
    assert terms.raw_flops == (3 if rule else 8) * 2 * 32 * D * D


def test_nested_loops_multiply():
    def nested(x, ws):
        def outer(h, grp):
            return (_inner(h, grp[0]),) * 2

        def _inner(h, group):
            def step(hh, inp):
                hh = torch.tanh(hh @ inp[0])
                return hh, hh
            return loops.time_loop(step, h, (group,), dim=0, out_dim=0)[1]

        return loops.time_loop(outer, x, (ws,), dim=0, out_dim=0)[1].sum()

    x = torch.empty((32, D), device="meta")
    ws = torch.empty((4, 4, D, D), device="meta")
    terms = analyze_step(nested, x, ws, arch="a", shape="s", nodes=1,
                         model_flops=0.0)
    assert terms.flops == 16 * 2 * 32 * D * D
    assert terms.raw_flops == 9 * 2 * 32 * D * D  # 3 steps of 3 steps


def test_window_write_is_charged_the_window():
    cache_shape = (4, 4096, 8, 16)

    def update(cache, x):
        cache[:, 17] = x
        return cache

    cache = torch.empty(cache_shape, device="meta")
    x = torch.empty((4, 8, 16), device="meta")
    terms = analyze_step(update, cache, x, arch="a", shape="s", nodes=1,
                         model_flops=0.0)
    window = 4 * 8 * 16 * 4
    assert terms.bytes_accessed == 3 * window  # x read, window read and written
    assert terms.bytes_accessed < np.prod(cache_shape) * 4
    assert terms.peak_memory_bytes == np.prod(cache_shape) * 4 + window


def test_collective_on_one_rank_gloo_group(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        def f(a):
            dist.all_reduce(a)
            return a @ a.T

        terms = analyze_step(f, torch.ones((64, 64)), arch="a", shape="s",
                             nodes=1, model_flops=0.0)
    finally:
        dist.destroy_process_group()
    assert terms.coll_bytes == {"all-reduce": 64 * 64 * 4}
    assert terms.t_collective == 64 * 64 * 4 / HW.link_bw
    assert terms.flops == 2 * 64 * 64 * 64


# -- the loop rule against the unrolled run ------------------------------------------

def _rule_against_unrolled(fn, *args):
    got, want = (analyze_step(fn, *args, arch="a", shape="s", nodes=1,
                              model_flops=0.0, loop_rule=rule)
                 for rule in (True, False))
    assert got.raw_flops < want.raw_flops  # the rule ran fewer iterations
    assert (got.flops, got.bytes_accessed, got.peak_memory_bytes) == \
        (want.flops, want.bytes_accessed, want.peak_memory_bytes)
    return got


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-7b"])
def test_time_loop_rule_equals_unrolled(arch, grad):
    """The smoke model over 16 positions: the prefill without grad, the
    loss and its gradients with grad (the layers checkpointed, the sLSTM
    not)."""
    model = Transformer(get_config(arch).smoke)
    params = model.init(torch.Generator(), device="meta")
    tokens = torch.empty((2, 16), dtype=torch.int32, device="meta")
    if grad:
        params = tree_map(lambda x: x.detach().requires_grad_(True), params)

        def fn(p, t):
            return torch.autograd.grad(model.loss_fn(p, {"tokens": t}),
                                       tree_leaves(p), allow_unused=True)
    else:
        def fn(p, t):
            with torch.no_grad():
                return model.prefill(p, {"tokens": t})
    _rule_against_unrolled(fn, params, tokens)


def test_node_loop_rule_equals_unrolled():
    """A PartPSP round of llama3.2-1b's smoke model at 4 nodes (both passes'
    node loops, forward and backward, and the DPPS round's kernels)."""
    plan = build_train_plan(_smoke_arch("llama3.2-1b"), 4, shape=SMOKE_STEP)
    plan.mix_args(torch.device("meta"))  # made once, outside both counts
    terms = _rule_against_unrolled(plan.step_fn, *plan.abstract_args())
    shared = len(tree_leaves(plan.abstract_args()[0].dpps.push.s))
    assert terms.launches == {"l1_norm_rows": 2 * shared,
                              "dpps_perturb_rows": shared,
                              "pushsum_mix": shared}


# -- the dry run --------------------------------------------------------------

# the reference's row keys that XLA alone fills, and the port's own
XLA_ONLY = {"xla_flops_raw", "xla_bytes_raw", "lower_s", "compile_s",
            "memory_analysis"}
PORT_ONLY = {"raw_flops", "raw_bytes", "aten_flops", "kernel_flops",
             "kernel_bytes", "launches", "compute_dtype", "trace_s",
             "peak_bytes", "fits"}
REFERENCE_OK_KEYS = {
    "arch", "shape", "mesh", "flops_per_chip", "bytes_per_chip",
    "coll_bytes_per_chip", "coll_breakdown", "peak_memory_gib",
    "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
    "model_flops_per_chip", "useful_flops_ratio", "xla_flops_raw",
    "xla_bytes_raw", "status", "schedule", "lower_s", "compile_s",
    "memory_analysis"}


def test_dryrun_rows():
    skipped = dryrun.run_one("llama3.2-1b", "long_500k", verbose=False)
    assert skipped == {"arch": "llama3.2-1b", "shape": "long_500k",
                       "mesh": "nodes16", "status": "skipped",
                       "reason": "full-attention arch; long_500k needs "
                                 "sub-quadratic attention (DESIGN.md)"}
    row = dryrun.run_one("xlstm-125m", "decode_32k", verbose=False)
    assert set(row) == (REFERENCE_OK_KEYS - XLA_ONLY) | PORT_ONLY
    assert row["status"] == "ok" and row["schedule"] == "dense"
    assert row["flops_per_chip"] > 0 and row["fits"] is True
    assert row["peak_bytes"] == row["peak_memory_gib"] * 2**30
    assert row["model_flops_per_chip"] == flops.model_flops_per_chip(
        get_config("xlstm-125m"), "decode_32k", 1)


def test_dryrun_out_resumes(tmp_path, capsys):
    out = tmp_path / "rows.json"
    argv = ["--arch", "gemma3-1b", "--shape", "long_500k", "--out", str(out)]
    dryrun.main(argv)
    first = json.loads(out.read_text())
    assert [r["status"] for r in first] == ["ok"]
    capsys.readouterr()
    dryrun.main(argv)
    text = capsys.readouterr().out
    assert "cached" in text and "dry-run summary: 1 ok, 0 skipped" in text
    assert json.loads(out.read_text()) == first


def test_dryrun_exits_1_on_an_error_row(monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("no plan")

    monkeypatch.setattr(dryrun, "build_serve_plan", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k"])
    assert e.value.code == 1
    assert "ERROR xlstm-125m x decode_32k x nodes16: RuntimeError: no plan" \
        in capsys.readouterr().out


def test_serve_plans_cost_flash_on_meta():
    """The prefill routes its attention through the flash kernel's meta path
    (no (S, S) scores); the decode step reads its cache at the last slot.
    The smoke model at a head dim the kernel takes (64)."""
    spec = get_config("llama3.2-1b")
    arch = dataclasses.replace(spec, model=dataclasses.replace(
        spec.smoke, head_dim=64))
    plan = build_serve_plan(arch, shape_name="p",
                            shape=ShapeSpec("p", 64, 2, "prefill"))
    flash = plan.cost()
    assert flash.launches == {"flash_attention": 2}
    plain = dataclasses.replace(plan, model=Transformer(dataclasses.replace(
        plan.model.cfg, flash_prefill=False))).cost()
    assert plain.launches == {}
    assert flash.peak_memory_bytes < plain.peak_memory_bytes
    assert flash.aten_flops < plain.aten_flops  # the scores' products
    decode = build_serve_plan(arch, shape_name="d",
                              shape=ShapeSpec("d", 64, 2, "decode"))
    args = decode.abstract_args()
    assert args[3] == 63 and args[1]["group_0"]["k"].shape[2] == 64
    assert decode.cost().flops > 0


def test_variant_knobs_cost_on_meta():
    """Each variant knob of the plans, costed on meta at smoke size against
    the default: the single pass (fewer gradient FLOPs, the same kernels),
    bf16 parameters (the DPPS kernels on f32 rows of the bf16 leaves, a
    lower peak), the circulant schedule (no mix kernel: its rolls are no
    contraction, as in the reference), a bf16 cache, and ``carry_cache``
    (the same count: the port's decode has that path's layout anyway)."""
    arch = _smoke_arch("llama3.2-1b")
    base, single, bf16, circ = (
        build_train_plan(arch, 4, shape=SMOKE_STEP, **kw).cost()
        for kw in ({}, dict(two_pass=False), dict(param_dtype="bfloat16"),
                   dict(schedule="circulant")))
    kernels = {"l1_norm_rows": 18, "dpps_perturb_rows": 9}
    assert base.launches == single.launches == bf16.launches \
        == dict(kernels, pushsum_mix=9)
    assert circ.launches == kernels
    assert single.aten_flops < base.aten_flops
    assert single.kernel_flops == base.kernel_flops
    assert (bf16.compute_dtype, base.compute_dtype) == ("bfloat16", "float32")
    assert bf16.peak_memory_bytes < base.peak_memory_bytes
    assert circ.kernel_flops < base.kernel_flops

    shape = ShapeSpec("d", 64, 2, "decode")
    plans = [build_serve_plan(arch, shape_name="d", shape=shape, **kw)
             for kw in ({}, dict(cache_dtype="bfloat16"),
                        dict(param_dtype="bfloat16"), dict(carry_cache=True))]
    assert plans[1].abstract_args()[1]["group_0"]["k"].dtype == torch.bfloat16
    d, cache16, params16, carry = (p.cost() for p in plans)
    assert cache16.peak_memory_bytes < d.peak_memory_bytes
    assert params16.compute_dtype == "bfloat16"
    assert params16.peak_memory_bytes < d.peak_memory_bytes
    assert carry.row() == d.row()
    row = dryrun.run_one("xlstm-125m", "decode_32k", carry_cache=True,
                         verbose=False)
    assert row["status"] == "ok" and row["schedule"] == "dense"


# -- guards ---------------------------------------------------------------------

NEW_MODULES = ("configs/shapes.py", "core/loops.py", "launch/flops.py",
               "launch/op_analysis.py", "launch/steps.py", "launch/dryrun.py")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_launch_tooling_imports_no_jax_and_no_reference(module):
    """The new modules are among the files ``tests/test_torch_session.py``'s
    guard walks, and import neither JAX nor the reference."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in set((ROOT / "src" / "repro_torch").rglob("*.py"))
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}
