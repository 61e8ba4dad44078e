"""Wire codecs of the port (``repro_torch.wire``, the bf16 wire, the
error-feedback residual) against the reference's, on the CPU.

* Each codec's encode on the same numpy inputs: int8 and the compress-first
  codec on the reference's uniforms (``jax.random.uniform`` under its key)
  bit for bit, with all-zero rows and values at the +-127 edges; top-k and
  its residual bit for bit, ties kept; ``parse_wire_spec``'s vocabulary and
  errors; ``payload_bytes`` and ``estimate_wire_bytes`` equal.
* The port's own uniform stream: a window is a slice of the row, the words
  share none with the noise bits, and a windowed encode equals a one-pass
  one.
* The bf16 wire (the messages rounded once, then the plain f32 mix:
  dense, sparse, circulant) against the reference's bf16 gossip to rtol
  1e-6 (the summation order differs); sync rounds average the f32 buffer.
* ``Session.run`` under int8, top-k, bf16 and the compress-first codec,
  dense, sparse and circulant, noise off and on, fed the reference's noise
  bits (``reference_bits``), uniforms (``reference_wire_uniforms``) and,
  for the compress-first codec's plain Laplace row, its unit draws
  (``reference_noise_draws``): states and trajectories to rtol 1e-5 (plus
  1e-6 of each array's largest magnitude), the ``wd_wire_resid`` row
  included. ``Session.train`` (PartPSP) under int8 and top-k to the
  training tolerance (rtol 1e-4).
* The refusals as the reference's: the loop driver, bf16 with delays, with
  ``packed=False``, the orphaned residual, ``plan=`` beside ``wire=``; the
  compress-first codec runs with the kernels (the reference refuses it
  there); the deprecated
  ``wire_dtype="bf16"`` warns once; the launcher's ``--wire`` /
  ``--wire-dtype`` flags and their parse-time refusals.
* The ledger's and ``NetworkStatsHook``'s accounting equal the reference's;
  a top-k state saves its residual as ``.dpps/.resid`` and resumes across
  the packages both ways.

Sizes: N = 8, d_s = 17 (two leaves), <= 6 rounds; the MLP at 6 -> 4 -> 6
-> 3 sharing 48 (``test_torch_net``'s).
"""
from __future__ import annotations

import argparse
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hooks import _ref_mlp_loss
from test_torch_net import (BATCH, D_IN, GAMMA_N, HIDDEN, N_CLASSES, SEED,
                            _close, _trees_close, _values, ledgers_equal,
                            reports_close)
from test_torch_reference import (load_reference, reference_bits,
                                  reference_noise_draws, reference_round_key,
                                  reference_wire_uniforms, to_numpy)

from repro_torch.api import LedgerHook, PrivacySpec, RoundHook, Session
from repro_torch.api.results import estimate_wire_bytes
from repro_torch.convert import tree_from_numpy
from repro_torch.core import pushsum as P
from repro_torch.core import topology as T
from repro_torch.core.dpps import DPPSConfig, dpps_init, dpps_step
from repro_torch.core.packing import PackedLayout
from repro_torch.engine import ProtocolPlan, run_dpps
from repro_torch.engine import plan as plan_mod
from repro_torch.kernels import ref as kref
from repro_torch.api import cli as cli_mod
from repro_torch.launch import train as train_cli
from repro_torch.models.mlp import PARTITIONS, mlp_loss
from repro_torch.net import DelayModel, NetworkStatsHook
from repro_torch.obs import MetricsBus
from repro_torch.wire import (WIRE_SALT, Bf16Codec, BrokenCompressFirstCodec,
                              IdentityCodec, Int8StochasticCodec, TopKCodec,
                              parse_wire_spec, wire_uniforms)
from repro_torch.wire import codecs as codecs_mod

N, ROUNDS, D_S = 8, 6, 17


@pytest.fixture(scope="module")
def R():
    """The reference, with the submodules these tests read bound on their
    packages: a submodule left in ``sys.modules`` by a failed collection
    import is not bound again on its re-imported package."""
    ref = load_reference()
    import importlib
    import sys
    for name in ("repro.wire", "repro.net", "repro.obs", "repro.data",
                 "repro.api.hooks", "repro.api.cli", "repro.api.results",
                 "repro.core.packing", "repro.core.pushsum",
                 "repro.core.topology", "repro.engine.plan"):
        parent, _, child = name.rpartition(".")
        setattr(sys.modules[parent], child, importlib.import_module(name))
    return ref


# -- the codecs against the reference's ----------------------------------------

SPECS = ["f32", "identity", "", None, "bf16", "int8", "topk:5", "topk:1/16",
         "TOPK:d/4", " int8 ", "broken-compress-first",
         "broken_compress_first"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_wire_spec_vocabulary(R, spec):
    got, want = parse_wire_spec(spec), R.wire.parse_wire_spec(spec)
    assert type(got).__name__ == type(want).__name__
    assert (got.name, got.active, got.wire_dtype, got.transforms_values,
            got.stateful, got.compress_before_noise,
            got.noise_scale_factor) == (
        want.name, want.active, want.wire_dtype, want.transforms_values,
        want.stateful, want.compress_before_noise, want.noise_scale_factor)
    assert hash(got) == hash(parse_wire_spec(spec))


@pytest.mark.parametrize("spec,match", [("int4", "unknown wire spec"),
                                        ("topk:x", "bad top-k spec"),
                                        ("topk:1/y", "bad top-k spec"),
                                        ("topk:0", "exactly one of")])
def test_parse_wire_spec_errors(R, spec, match):
    with pytest.raises(ValueError, match=match):
        parse_wire_spec(spec)
    with pytest.raises(ValueError, match=match):
        R.wire.parse_wire_spec(spec)


@pytest.mark.parametrize("d_s", [1, 17, 7840, 65535, 65536])
def test_payload_bytes_equal_the_references(R, d_s):
    for spec in ("f32", "bf16", "int8", "topk:5", "topk:1/16",
                 "broken-compress-first"):
        got, want = parse_wire_spec(spec), R.wire.parse_wire_spec(spec)
        if d_s >= 65536 and spec.startswith("topk"):
            with pytest.raises(ValueError, match="uint16"):
                got.payload_bytes(d_s)
            with pytest.raises(ValueError, match="uint16"):
                want.payload_bytes(d_s)
            continue
        assert got.payload_bytes(d_s) == want.payload_bytes(d_s)
    with pytest.raises(ValueError, match="exactly one"):
        TopKCodec(k=3, frac=2)


def _wire_rows(rng, n, d):
    x = (rng.normal(size=(n, d)) * 10.0 ** rng.integers(-3, 4, (n, 1))
         ).astype(np.float32)
    x[1] = 0.0                       # an all-zero row keeps scale 1
    x[2, :3] = [5.0, -5.0, 0.0]      # the +-127 edges of its row
    x[2, 3:] = rng.uniform(-5.0, 5.0, d - 3)
    return x


@pytest.mark.parametrize("codec_name", ["int8", "broken-compress-first"])
@pytest.mark.parametrize("n,d", [(4, 9), (6, 300)])
def test_int8_encode_bit_for_bit_on_the_references_uniforms(R, codec_name,
                                                            n, d):
    x = _wire_rows(np.random.default_rng(d), n, d)
    key = jax.random.fold_in(jax.random.PRNGKey(3), WIRE_SALT)
    want, _ = R.wire.parse_wire_spec(codec_name).encode(jnp.asarray(x), (),
                                                        key)
    u = np.array(jax.random.uniform(key, (n, d), jnp.float32))
    got, resid = parse_wire_spec(codec_name).encode(
        torch.from_numpy(x), (), draws=torch.from_numpy(u))
    assert resid == ()
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    # the dequantized grid: an integer multiple of each row's scale
    scale = np.abs(x).max(axis=1, keepdims=True) / np.float32(127.0)
    scale[scale == 0] = 1.0
    q = to_numpy(got) / scale
    assert np.all(np.abs(q - np.round(q)) < 1e-3)
    assert np.abs(np.round(q)).max() <= 127
    assert not to_numpy(got)[1].any()
    # out= writes the same values into the given buffer
    buf = torch.from_numpy(x.copy())
    parse_wire_spec(codec_name).encode(buf, (), draws=torch.from_numpy(u),
                                       out=buf)
    np.testing.assert_array_equal(to_numpy(buf), np.asarray(want))


@pytest.mark.parametrize("spec", ["topk:1", "topk:3", "topk:1/4", "topk:40"])
def test_topk_encode_and_residual_bit_for_bit_with_ties(R, spec):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(5, 32)).astype(np.float32)
    x[0, :6] = [2.0, -2.0, 2.0, 0.5, -0.5, 0.5]   # ties at the threshold
    x[0, 6:] = rng.uniform(-0.4, 0.4, 26)
    x[1] = 0.0
    resid = rng.normal(size=(5, 32)).astype(np.float32) * 0.1
    resid[0, :6] = 0.0
    want, want_r = R.wire.parse_wire_spec(spec).encode(
        jnp.asarray(x), jnp.asarray(resid), jax.random.PRNGKey(0))
    got, got_r = parse_wire_spec(spec).encode(torch.from_numpy(x),
                                              torch.from_numpy(resid))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    np.testing.assert_array_equal(to_numpy(got_r), np.asarray(want_r))
    k = parse_wire_spec(spec).effective_k(32)
    assert ((to_numpy(got) != 0).sum(axis=1)[2:] == k).all()
    if spec == "topk:1":
        assert (to_numpy(got)[0, :3] == [2.0, -2.0, 2.0]).all()  # ties kept
    np.testing.assert_array_equal(to_numpy(got) + to_numpy(got_r), x + resid)


def test_wire_uniforms_are_a_stream_of_seed_round_node_element(monkeypatch):
    """A window is the same slice of the row; the words share none with the
    noise bits; [0, 1); a windowed encode equals a one-pass one."""
    full = wire_uniforms(11, 5, 3, 0, 37)
    assert full.shape == (3, 37) and full.dtype == torch.float32
    torch.testing.assert_close(wire_uniforms(11, 5, 3, 6, 29),
                               full[:, 6:29], rtol=0, atol=0)
    assert not torch.equal(full, wire_uniforms(11, 6, 3, 0, 37))
    assert not torch.equal(full, wire_uniforms(12, 5, 3, 0, 37))
    assert float(full.min()) >= 0.0 and float(full.max()) < 1.0
    # another key: about as many shared words as two independent draws
    # of 12,288 uint32 share (the birthday count, ~0.04)
    words = kref.philox_bits(11, 5, 3, 0, 4096, salt=WIRE_SALT)
    noise = kref.philox_bits(11, 5, 3, 0, 4096)
    assert not (words == noise).any()
    assert len(set(words.reshape(-1).tolist())
               & set(noise.reshape(-1).tolist())) < 4
    u = wire_uniforms(2, 1, 4, 0, 1 << 16)
    assert abs(float(u.mean()) - 0.5) < 0.01
    x = torch.from_numpy(_wire_rows(np.random.default_rng(1), 4, 1000))
    one = Int8StochasticCodec().encode(x, (), seed=5, t=2)[0]
    monkeypatch.setattr(codecs_mod, "DRAW_COLUMNS", 96)
    torch.testing.assert_close(Int8StochasticCodec().encode(
        x, (), seed=5, t=2)[0], one, rtol=0, atol=0)


# -- the bf16 gossip -----------------------------------------------------------

@pytest.mark.parametrize("schedule", ["dense", "sparse", "circulant"])
def test_bf16_gossip_matches_reference(R, schedule):
    """The port's bf16 wire, the messages rounded once (``Bf16Codec.
    encode``) and mixed by the plain f32 mix, against the reference's bf16
    gossip (the cast at the mix boundary)."""
    rng = np.random.default_rng(4)
    topo = T.ExpGraph(N)
    buf = rng.normal(size=(N, 40)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, N).astype(np.float32)
    w = topo.weight_matrix(0).astype(np.float32)
    if schedule == "dense":
        kw = dict(w=w)
    elif schedule == "sparse":
        idx, vals = T.padded_csr(w, int((w > 0).sum(axis=1).max()))
        kw = dict(sparse_idx=idx, sparse_vals=vals)
    else:
        offs, wts = topo.mixing_weights(0)
        kw = dict(offsets=offs, weights=np.asarray(wts, np.float32))
    conv = lambda v, f: v if isinstance(v, tuple) else f(v)
    want = R.core.pushsum.gossip_packed(
        R.core.pushsum.PushSumState(s=jnp.asarray(buf), a=jnp.asarray(a)),
        wire_dtype="bf16", **{k: conv(v, jnp.asarray) for k, v in kw.items()})
    port_kw = {k: conv(v, torch.from_numpy) for k, v in kw.items()}
    rounded = Bf16Codec().encode(torch.from_numpy(buf), ())[0]
    got = P.gossip_packed(P.PushSumState(s=rounded, a=torch.from_numpy(a)),
                          use_kernels=False, **port_kw)
    assert got.s.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(got.s), np.asarray(want.s),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    # the messages were rounded: not the f32 mix
    f32 = P.gossip_packed(P.PushSumState(s=torch.from_numpy(buf),
                                         a=torch.from_numpy(a)), **port_kw)
    assert not torch.equal(f32.s, got.s)


def test_bf16_rounding_in_windows_equals_one_pass(monkeypatch):
    """``Bf16Codec.encode`` is the bf16 cast kept in f32, the same in column
    windows as in one pass, in place as out of place."""
    rng = np.random.default_rng(5)
    buf = torch.from_numpy(rng.normal(size=(5, 1000)).astype(np.float32))
    one = Bf16Codec().encode(buf, ())[0]
    torch.testing.assert_close(one, buf.to(torch.bfloat16).to(torch.float32),
                               rtol=0, atol=0)
    monkeypatch.setattr(codecs_mod, "DRAW_COLUMNS", 64)
    torch.testing.assert_close(Bf16Codec().encode(buf, ())[0], one, rtol=0,
                               atol=0)
    inplace = buf.clone()
    Bf16Codec().encode(inplace, (), out=inplace)
    torch.testing.assert_close(inplace, one, rtol=0, atol=0)


# -- sessions against the reference ---------------------------------------------

class _WireStats(RoundHook):
    needs_wire_stats = True


def _run_both(R, spec, schedule, noise, *, rounds=ROUNDS, sync=0,
              hooks=False):
    vals = _values(np.random.default_rng(2))
    deploy = dict(schedule=schedule, sync_interval=sync, chunk=rounds,
                  seed=SEED)
    privacy = dict(b=5.0, gamma_n=0.02, noise=noise)
    codec = parse_wire_spec(spec)
    broken = codec.compress_before_noise
    ref = R.api.Session.build(
        R.core.topology.DOutGraph(N, 2), privacy=R.api.PrivacySpec(**privacy),
        use_kernels=noise and not broken, wire=R.wire.parse_wire_spec(spec),
        **deploy)
    ref_hooks = [type("W", (R.api.hooks.RoundHook,),
                      {"needs_wire_stats": True})()] if hooks else []
    ref_rep = ref.run(rounds, values=[jnp.asarray(v) for v in vals],
                      hooks=ref_hooks)
    session = Session.build(T.DOutGraph(N, 2), privacy=PrivacySpec(**privacy),
                            device="cpu", wire=codec, **deploy)
    shapes = [v.shape for v in vals]
    seams = dict(
        bits_at=(lambda t: torch.from_numpy(reference_bits(SEED, t, N, D_S)))
        if noise and not broken else None,
        wire_draws_at=lambda t: torch.from_numpy(reference_wire_uniforms(
            SEED, t, N, D_S)),
        noise_draws_at=(lambda t: torch.from_numpy(reference_noise_draws(
            "laplace", reference_round_key(SEED, t), shapes)))
        if broken else None)
    rep = session.run(rounds, values=tree_from_numpy(vals, device="cpu"),
                      hooks=[_WireStats()] if hooks else [], **seams)
    return rep, ref_rep


def _reports_close(rep, ref_rep, rtol=1e-5):
    assert set(rep.trajectory) == set(ref_rep.trajectory)
    for k, v in ref_rep.trajectory.items():
        v = np.asarray(v)
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(rep.trajectory[k], v, err_msg=k)
        else:
            _close(rep.trajectory[k], v, rtol)
    _trees_close(rep.state.push, ref_rep.state.push, rtol)
    assert rep.wire_bytes == ref_rep.wire_bytes


@pytest.mark.parametrize("spec,schedule,noise", [
    ("int8", "dense", True), ("int8", "sparse", False),
    ("int8", "circulant", True), ("topk:1/4", "dense", True),
    ("topk:3", "sparse", True), ("topk:1/4", "circulant", False),
    ("bf16", "dense", False), ("bf16", "sparse", False),
    ("bf16", "circulant", False), ("broken-compress-first", "dense", True),
    ("broken-compress-first", "sparse", False)])
def test_session_run_matches_reference_under_codecs(R, spec, schedule, noise):
    rep, ref_rep = _run_both(R, spec, schedule, noise,
                             hooks=spec.startswith("topk"))
    _reports_close(rep, ref_rep)
    if spec.startswith("topk"):
        _close(rep.state.resid, ref_rep.state.resid, 1e-5)
        assert "wd_wire_resid" in rep.trajectory
        assert float(rep.state.resid.abs().sum()) > 0.0
    assert abs(float(rep.state.push.a.mean()) - 1.0) < 1e-5


def test_bf16_sync_rounds_match_reference(R):
    """Sync rounds under the bf16 wire average the f32 noised buffer (no
    rounding), the rounds between them mix the rounded messages, as the
    reference's."""
    rep, ref_rep = _run_both(R, "bf16", "dense", True, sync=2)
    _reports_close(rep, ref_rep)


def test_bf16_noise_on_round_matches_reference(R):
    """One noised round of the bf16 wire: the reference's bits, the messages
    rounded once, the mix to rtol 1e-5."""
    rep, ref_rep = _run_both(R, "bf16", "dense", True, rounds=1)
    _reports_close(rep, ref_rep)


def test_sync_rounds_average_the_encoded_wire(R):
    """Under int8 with a sync every 3 rounds the averaged buffer is the
    encoded one, as the reference's."""
    rep, ref_rep = _run_both(R, "int8", "dense", False, sync=3)
    _reports_close(rep, ref_rep)


def test_identity_codec_is_bit_for_bit_the_raw_wire():
    vals = tree_from_numpy(_values(np.random.default_rng(3)), device="cpu")
    reps = []
    for wire in (None, IdentityCodec(), parse_wire_spec("f32")):
        session = Session.build(T.DOutGraph(N, 2), privacy=PrivacySpec(
            b=5.0, gamma_n=0.02), schedule="dense", sync_interval=3,
            device="cpu", seed=SEED, wire=wire)
        assert session.plan.wire is None and session.cfg.wire is None
        reps.append(session.run(ROUNDS, values=vals))
    for rep in reps[1:]:
        for x, y in zip(reps[0].state.push.s, rep.state.push.s):
            assert torch.equal(x, y)
        for k, v in reps[0].trajectory.items():
            np.testing.assert_array_equal(v, rep.trajectory[k])
    assert DPPSConfig(wire=IdentityCodec()) == DPPSConfig()


def mlp_wire_sessions(R, spec, *, rounds=ROUNDS, noise=True):
    """The reference's and the port's PartPSP sessions of the paper MLP
    (partpsp-2) on 2-out(8) under the codec ``spec``, and the batches."""
    key = jax.random.PRNGKey(SEED)
    k1, k2, k3 = jax.random.split(key, 3)
    s = lambda k, shape: np.asarray(jax.random.normal(k, shape)
                                    / jnp.sqrt(shape[0]))
    params = {"l1": s(k1, (D_IN, HIDDEN)), "l2": s(k2, (HIDDEN, D_IN)),
              "l3": s(k3, (D_IN, N_CLASSES))}
    task = R.data.SyntheticClassification(d_in=D_IN, n_classes=N_CLASSES,
                                          seed=SEED)
    skew = R.data.dirichlet_partition(N, N_CLASSES, seed=SEED)
    batches = [jax.tree_util.tree_map(np.asarray, task.node_batches(
        jax.random.fold_in(jax.random.PRNGKey(SEED + 1), t), N, BATCH,
        skew)) for t in range(rounds)]
    deploy = dict(algorithm="partpsp", gamma_l=0.1, gamma_s=0.1, clip=100.0,
                  schedule="dense", sync_interval=3, chunk=4, seed=SEED,
                  partition=PARTITIONS["partpsp-2"])
    privacy = dict(b=1.0, gamma_n=GAMMA_N, noise=noise)
    ref_session = R.api.Session.build(
        R.core.topology.DOutGraph(N, 2),
        privacy=R.api.PrivacySpec(**privacy), model=_ref_mlp_loss,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        use_kernels=noise, wire=R.wire.parse_wire_spec(spec), **deploy)
    session = Session.build(
        T.DOutGraph(N, 2), privacy=PrivacySpec(**privacy), model=mlp_loss,
        params=tree_from_numpy(params, device="cpu"), device="cpu",
        wire=parse_wire_spec(spec), **deploy)
    return ref_session, session, batches


def _train_seams(session, d_s, noise=True):
    return dict(
        bits_at=(lambda t: torch.from_numpy(reference_bits(
            SEED, t, N, d_s, partpsp=True))) if noise else None,
        wire_draws_at=lambda t: torch.from_numpy(reference_wire_uniforms(
            SEED, t, N, d_s, partpsp=True)))


@pytest.mark.parametrize("spec", ["int8", "topk:1/8"])
def test_train_matches_reference_under_codecs(R, spec):
    """PartPSP under the codec with a LedgerHook and a NetworkStatsHook:
    the reports within the training tolerance, the ledger's accounting
    (``wire_codec``, ``wire_bytes_per_edge``) and the network summary
    (payload, compression ratio) equal."""
    ref_session, session, batches = mlp_wire_sessions(R, spec)
    hooks = [LedgerHook(), NetworkStatsHook(bus=MetricsBus())]
    ref_hooks = [R.api.LedgerHook(), R.net.NetworkStatsHook(
        bus=R.obs.MetricsBus())]
    ref_rep = ref_session.train(ROUNDS, lambda t: jax.tree_util.tree_map(
        jnp.asarray, batches[t]), hooks=ref_hooks)
    d_s = session.partition.d_shared()
    rep = session.train(ROUNDS, lambda t: tree_from_numpy(batches[t],
                                                          device="cpu"),
                        hooks=hooks, **_train_seams(session, d_s))
    reports_close(rep, ref_rep)
    ledgers_equal(hooks[0].ledger.entries, ref_hooks[0].ledger.entries)
    assert hooks[0].ledger.entries[0]["wire_codec"] == spec
    assert (hooks[0].ledger.entries[0]["wire_bytes_per_edge"]
            == ref_hooks[0].ledger.entries[0]["wire_bytes_per_edge"])
    got, want = hooks[0].summary(), ref_hooks[0].summary()
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-5), k
        else:
            assert got[k] == v, k
    assert rep.network.summary() == ref_rep.network.summary()
    assert rep.network.compression_ratio > 3.0
    assert rep.wire_bytes == ref_rep.wire_bytes


@pytest.mark.parametrize("spec", ["f32", "bf16", "int8", "topk:1/16"])
@pytest.mark.parametrize("schedule", ["dense", "sparse", "circulant"])
def test_estimate_wire_bytes_equals_the_references(R, spec, schedule):
    plan = ProtocolPlan.from_topology(T.ExpGraph(16), schedule=schedule,
                                      device="cpu",
                                      wire=parse_wire_spec(spec))
    ref_plan = R.engine.plan.ProtocolPlan.from_topology(
        R.core.topology.ExpGraph(16), schedule=schedule,
        wire=R.wire.parse_wire_spec(spec))
    for d_s in (17, 7840):
        assert estimate_wire_bytes(plan, 16, d_s, 5) == \
            R.api.results.estimate_wire_bytes(ref_plan, 16, d_s, 5)
    layout = PackedLayout.from_tree([torch.zeros((16, 7840))], lane=128)
    assert layout.wire_bytes_per_node(plan.wire_dtype, plan.wire) == \
        R.core.packing.PackedLayout.from_tree(
            [jnp.zeros((16, 7840))]).wire_bytes_per_node(
                ref_plan.wire_dtype, ref_plan.wire)


# -- refusals ------------------------------------------------------------------

def test_loop_driver_refuses_a_codec(R):
    for spec in ("int8", "bf16"):
        _, session, batches = mlp_wire_sessions(R, spec, rounds=1)
        with pytest.raises(ValueError, match="loop driver"):
            session.train(1, lambda t: tree_from_numpy(batches[t],
                                                       device="cpu"),
                          driver="loop")


def test_bf16_refuses_delays_and_the_pytree_runtime():
    topo = T.DOutGraph(N, 2)
    with pytest.raises(ValueError, match="bf16"):
        ProtocolPlan.from_topology(topo, device="cpu", wire=Bf16Codec(),
                                   delays=DelayModel(max_delay=2))
    with pytest.raises(ValueError, match="packed=True"):
        ProtocolPlan.from_topology(topo, device="cpu", wire=Bf16Codec(),
                                   packed=False)
    with pytest.raises(ValueError, match="packed=True"):
        ProtocolPlan.from_topology(topo, device="cpu",
                                   wire=Int8StochasticCodec(), packed=False)
    # a plan built by hand skips from_topology's check: the engine refuses
    plan = ProtocolPlan(schedule="dense", period=1, device=torch.device("cpu"),
                        ws=torch.eye(N)[None], wire=Bf16Codec(),
                        delays=DelayModel(max_delay=2), sync_interval=0)
    cfg = DPPSConfig(noise=False, gamma_n=0.0)
    with pytest.raises(NotImplementedError, match="mailbox"):
        run_dpps(dpps_init([torch.zeros((N, 4))], cfg), None, cfg=cfg,
                 plan=plan, rounds=1)
    cfg = DPPSConfig(wire_dtype="bf16")
    with pytest.raises(ValueError, match="packed runtime"):
        dpps_step(dpps_init([torch.zeros((N, 4))], cfg),
                  [torch.zeros((N, 4))], cfg, None, w=torch.eye(N))


def test_value_codec_composes_with_delays(R):
    """int8 under delays: the noised, encoded payload is enqueued; mass is
    conserved and the run is finite."""
    session = Session.build(T.DOutGraph(N, 2), privacy=PrivacySpec(
        b=5.0, gamma_n=0.02), schedule="dense", sync_interval=0,
        device="cpu", wire=Int8StochasticCodec(),
        delays=DelayModel(max_delay=2, timeout_rate=0.1))
    rep = session.run(ROUNDS, values=tree_from_numpy(
        _values(np.random.default_rng(1)), device="cpu"))
    assert np.isfinite(rep.trajectory["async_mass_mean"]).all()
    np.testing.assert_allclose(rep.trajectory["async_mass_mean"], 1.0,
                               atol=1e-5)


def test_orphaned_residual_and_codec_checks():
    topo = T.DOutGraph(N, 2)
    cfg = DPPSConfig(noise=False, gamma_n=0.0, sync_interval=0)
    vals = tree_from_numpy(_values(np.random.default_rng(0)), device="cpu")
    topk = ProtocolPlan.from_topology(topo, device="cpu", schedule="dense",
                                      wire=TopKCodec(frac=4))
    state, _ = run_dpps(dpps_init(vals, cfg), None, cfg=cfg, plan=topk,
                        rounds=2)
    assert isinstance(state.resid, torch.Tensor)
    assert tuple(state.resid.shape) == (N, D_S)
    state2, _ = run_dpps(state, None, cfg=cfg, plan=topk, rounds=1)
    assert state2.t == 3
    raw = ProtocolPlan.from_topology(topo, device="cpu", schedule="dense")
    with pytest.raises(ValueError, match=r"resid=\(\)"):
        run_dpps(state, None, cfg=cfg, plan=raw, rounds=1)
    layout = PackedLayout.from_tree(vals, lane=1)
    stepped = topk.resolve_dpps(cfg)
    with pytest.raises(ValueError, match="error-feedback"):
        dpps_step(dpps_init(vals, stepped)._replace(t=0),
                  layout.pack([torch.zeros_like(v) for v in vals]), stepped,
                  layout, w=topk.ws[0])
    # the compress-first codec runs on the kernel route too (here its plain
    # versions: the tensors are on the CPU), as on the plain one
    steps = {}
    for kernels in (True, False):
        broken = DPPSConfig(use_kernels=kernels,
                            wire=BrokenCompressFirstCodec())
        steps[kernels], _ = dpps_step(
            dpps_init(vals, broken)._replace(
                push=dpps_init(vals, broken).push._replace(
                    s=layout.pack(vals))),
            layout.pack([torch.zeros_like(v) for v in vals]), broken,
            layout, w=topk.ws[0], seed=3)
    assert torch.equal(steps[True].push.s, steps[False].push.s)
    assert torch.equal(steps[True].sens.prev_noise_l1,
                       steps[False].sens.prev_noise_l1)
    with pytest.raises(ValueError, match="uint16"):
        run_dpps(dpps_init([torch.zeros((N, 70000))], cfg), None, cfg=cfg,
                 plan=ProtocolPlan.from_topology(topo, device="cpu",
                                                 wire=TopKCodec(k=4)),
                 rounds=1)


def test_session_refuses_wire_beside_an_explicit_plan(R):
    topo = T.DOutGraph(N, 2)
    plan = ProtocolPlan.from_topology(topo, device="cpu")
    with pytest.raises(ValueError, match="wire="):
        Session.build(topo, plan=plan, wire=Int8StochasticCodec())
    Session.build(topo, plan=plan, wire=IdentityCodec())  # inactive: fine
    with pytest.raises(ValueError, match="wire="):
        R.api.Session.build(R.core.topology.DOutGraph(N, 2),
                            plan=R.engine.plan.ProtocolPlan.from_topology(
                                R.core.topology.DOutGraph(N, 2)),
                            wire=R.wire.Int8StochasticCodec())


def test_wire_dtype_bf16_warns_once_and_conflicts_raise(monkeypatch):
    monkeypatch.setattr(plan_mod, "_WARNED", set())
    topo = T.DOutGraph(N, 2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        a = ProtocolPlan.from_topology(topo, device="cpu", wire_dtype="bf16")
        b = ProtocolPlan.from_topology(topo, device="cpu", wire_dtype="bf16")
    assert [w.category for w in caught] == [DeprecationWarning]
    assert a.wire == b.wire == Bf16Codec() and a.wire_dtype == "bf16"
    assert a.resolve_dpps(DPPSConfig()).wire_dtype == "bf16"
    with pytest.raises(ValueError, match="conflicting"):
        ProtocolPlan.from_topology(topo, device="cpu", wire_dtype="bf16",
                                   wire=Int8StochasticCodec())
    with pytest.raises(ValueError, match="implies wire_dtype"):
        DPPSConfig(wire=Int8StochasticCodec(), wire_dtype="bf16")
    with pytest.raises(ValueError, match="unknown wire_dtype"):
        DPPSConfig(wire_dtype="fp8")


# -- the launcher ------------------------------------------------------------------

def _cli_args(argv):
    return train_cli._parser().parse_args(argv)


@pytest.mark.parametrize("argv,want", [
    ([], None), (["--wire", "f32"], None), (["--wire", "int8"], "int8"),
    (["--wire", "topk:1/16"], "topk:1/16"), (["--wire", "bf16"], "bf16"),
    (["--wire-dtype", "bf16"], "bf16"),
    (["--wire", "bf16", "--wire-dtype", "bf16"], "bf16"),
    (["--wire", "int8", "--max-delay", "2", "--sync-interval", "0"], "int8")])
def test_cli_wire_flags(R, argv, want, monkeypatch):
    monkeypatch.setattr(plan_mod, "_WARNED", set())
    ap = train_cli._parser()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        codec = _validated_codec(ap, ap.parse_args(argv))
        ref_ap = argparse.ArgumentParser()
        R.api.cli.add_protocol_arguments(ref_ap)
        R.api.cli.add_delay_arguments(ref_ap)
        ref_codec = R.api.cli.wire_from_args(ref_ap, ref_ap.parse_args(
            [a for a in argv if a != "--sync-interval" and a != "0"]))
    assert (codec.name if codec else None) == want
    assert (ref_codec.name if ref_codec else None) == want


@pytest.mark.parametrize("argv,match", [
    (["--wire", "int4"], "unknown wire spec"),
    (["--wire", "int8", "--wire-dtype", "bf16"], "conflicts"),
    (["--wire", "int8", "--no-packed"], "packed runtime"),
    (["--wire", "bf16", "--driver", "loop"], "--driver engine"),
    (["--wire", "bf16", "--max-delay", "2", "--sync-interval", "0"],
     "async mailbox"),
    (["--wire", "topk:1/4", "--driver", "loop"], "--driver engine")])
def test_cli_wire_refusals(argv, match, capsys):
    with pytest.raises(SystemExit):
        train_cli.main(argv + ["--device", "cpu", "--reduced"])
    assert match in capsys.readouterr().err


def test_cli_takes_compress_first_with_kernels():
    """The port's kernel route runs the compress-first codec (its encode
    before the down-scaled noise), so ``--use-kernels`` does not refuse it
    as the reference's launcher does."""
    ap = train_cli._parser()
    codec = _validated_codec(ap, ap.parse_args(
        ["--wire", "broken-compress-first", "--use-kernels"]))
    assert codec == BrokenCompressFirstCodec()


def test_cli_trains_under_int8(capsys):
    train_cli.main(["--reduced", "--device", "cpu", "--nodes", "4",
                    "--steps", "2", "--gamma-n", "1e-7", "--wire", "int8",
                    "--sync-interval", "0", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "wire=int8" in out
    summary = json.loads(out.split("privacy:", 1)[1].splitlines()[0])
    assert summary["wire_codec"] == "int8"
    assert summary["wire_bytes_per_edge"] > 0


# -- checkpoints -----------------------------------------------------------------

@pytest.mark.parametrize("reader", ["port", "reference"])
def test_topk_state_restores_across_packages_and_resumes(R, tmp_path, reader):
    """A top-k training state saves its residual as ``.dpps/.resid`` in
    both packages; the ``reader``'s restore of the other package's file
    resumes 3 rounds to the reference's uninterrupted 6."""
    ref_session, session, batches = mlp_wire_sessions(R, "topk:1/8")
    d_s = session.partition.d_shared()
    seams = _train_seams(session, d_s)
    port_batch = lambda t: tree_from_numpy(batches[t], device="cpu")
    ref_batch = lambda t: jax.tree_util.tree_map(jnp.asarray, batches[t])
    first = session.train(3, port_batch, **seams)
    session.save(str(tmp_path / "port"), first.state, step=3)
    ref_first = ref_session.train(3, ref_batch)
    ref_session.save(str(tmp_path / "reference"), ref_first.state, step=3)
    metas = [json.loads((tmp_path / d / "meta.json").read_text())
             for d in ("port", "reference")]
    for key in ("step", "names", "dtypes", "shapes"):
        assert metas[0][key] == metas[1][key], key
    assert ".dpps/.resid" in metas[0]["names"]
    whole = ref_session.train(6, ref_batch)
    if reader == "port":
        restored, _ = session.restore(str(tmp_path / "reference"))
        assert restored.dpps.t == 3
        rest = session.train(3, port_batch, state=restored, start=3, **seams)
    else:
        tmpl = ref_session.train_state()
        tmpl = tmpl._replace(dpps=tmpl.dpps._replace(
            resid=jnp.zeros((N, d_s), jnp.float32)))
        restored, _ = ref_session.restore(str(tmp_path / "port"), tmpl)
        rest = ref_session.train(3, ref_batch, state=restored, start=3)
    assert int(rest.state.dpps.t) == 6
    _trees_close(rest.state.dpps.push, whole.state.dpps.push, 1e-4, 1e-5)
    _close(rest.state.dpps.resid, whole.state.dpps.resid, 1e-4, 1e-5)
    np.testing.assert_allclose(rest.trajectory["loss_mean"],
                               np.asarray(whole.trajectory["loss_mean"])[3:],
                               rtol=1e-4, atol=1e-5)


def _validated_codec(ap, args):
    """The launcher's codec after the shared CLI's parse-time refusals."""
    cli_mod.validate_protocol_args(ap, args)
    return cli_mod.wire_from_args(ap, args)
