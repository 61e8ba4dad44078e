"""The port's checkpoints and optimizers against the reference, on the CPU.

* ``repro_torch.checkpoint`` writes the reference's files: a checkpoint
  either package writes (``save_checkpoint``, or ``Session.save_consensus``
  from a PartPSP state) loads in the other, value for value, with the same
  leaf names and order; shape and leaf-count mismatches raise with the
  reference's messages.
* ``launch.train --checkpoint`` then ``launch.serve --checkpoint`` on the
  CPU for the recurrent models.
* ``repro_torch.optim``: ``sgd`` (with and without momentum), ``adamw``
  (with weight decay) and ``global_norm`` against the reference over three
  updates.
* Full-state checkpoints (``Session.save`` / ``Session.restore``): a
  ``PartPSPState``'s ``names``, ``dtypes`` and ``shapes`` equal the
  reference's exactly (``.dpps/.push/.s/0``, ..., ``.dpps/.t`` an int32 0-d
  array, ``.local/0``, ...); a state either package writes restores in the
  other and resumes as the uninterrupted run does (rtol 1e-4 / atol 1e-5,
  the training tolerance), and within the port bit for bit (the restored
  round counter continues the same Philox stream).

Checkpoints round-trip exactly (the same f32 bits); the two packages'
consensus views of one state agree to rtol 1e-6 (s-bar is a mean over
the nodes, summed in another order). The optimizers agree
to rtol 1e-6 / atol 1e-7: the same elementwise f32 arithmetic, where XLA
may fuse a multiply-add that PyTorch rounds twice.
"""
from __future__ import annotations

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hooks import _sessions as mlp_sessions
from test_torch_models import cfg_to_reference
from test_torch_reference import load_reference, reference_bits, to_numpy

from repro_torch import convert
from repro_torch.convert import tree_from_numpy
from repro_torch.api import Session
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import topology as T
from repro_torch.core.tree_utils import tree_leaves, tree_map
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw, global_norm, sgd

ARCH = "zamba2-7b"
N = 3


@pytest.fixture(scope="module")
def R():
    ref = load_reference()
    for name in ("repro.checkpoint", "repro.optim"):
        importlib.import_module(name)
    return ref


def _ref_params(R, arch=ARCH, key=4):
    cfg = get_config(arch).smoke
    ref_model = R.models.Transformer(cfg_to_reference(R, cfg))
    return cfg, ref_model, jax.tree_util.tree_map(
        np.asarray, ref_model.init(jax.random.PRNGKey(key)))


def _trees_equal(got, want):
    """Leaf for leaf the same values (a tree of tensors or of arrays)."""
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        np.testing.assert_array_equal(to_numpy(x), np.asarray(y))


def _sessions(R, cfg, ref_model, params):
    """The port's and the reference's PartPSP sessions of the same params
    and the arch's rules, and each one's initial training state with its
    local leaves made to differ by node (so node 0's view is checked)."""
    rules = tuple(get_config(ARCH).shared_rules)
    port = Session.build(T.DOutGraph(N, 2), model=Transformer(cfg),
                         params=convert.transformer_params_from_reference(
                             params, cfg, device="cpu"),
                         partition=rules, device="cpu")
    ref = R.api.Session.build(R.core.topology.DOutGraph(N, 2),
                              model=ref_model,
                              params=jax.tree_util.tree_map(jnp.asarray,
                                                            params),
                              partition=rules)
    scale = np.arange(1, N + 1, dtype=np.float32)
    st = port.train_state()
    st = st._replace(local=[x * torch.tensor(scale).reshape(
        (N,) + (1,) * (x.dim() - 1)) for x in st.local])
    rst = ref.train_state()
    rst = rst._replace(local=[x * jnp.asarray(scale).reshape(
        (N,) + (1,) * (x.ndim - 1)) for x in rst.local])
    return port, st, ref, rst


def test_port_consensus_checkpoint_loads_in_the_reference(R, tmp_path):
    cfg, ref_model, params = _ref_params(R)
    port, st, ref, rst = _sessions(R, cfg, ref_model, params)
    port.save_consensus(str(tmp_path), st, step=5,
                        metadata={"arch": ARCH, "algorithm": "partpsp"})
    template = ref_model.init(jax.random.PRNGKey(0))
    got, meta = R.checkpoint.load_checkpoint(str(tmp_path), template)
    _trees_equal(port.consensus_view(st, 0), got)
    # s-bar is a mean over the nodes, summed in another order by XLA
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref.consensus_view(rst, 0))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert meta["step"] == 5
    assert meta["user"] == {"arch": ARCH, "algorithm": "partpsp"}
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(template)


@pytest.mark.parametrize("writer", ["save_checkpoint", "save_consensus"])
def test_reference_checkpoint_loads_in_the_port(R, tmp_path, writer):
    cfg, ref_model, params = _ref_params(R)
    if writer == "save_checkpoint":
        R.checkpoint.save_checkpoint(str(tmp_path), params, step=3)
        want = params
    else:
        _, _, ref, rst = _sessions(R, cfg, ref_model, params)
        ref.save_consensus(str(tmp_path), rst, step=3)
        want = ref.consensus_view(rst, 0)
    template = Transformer(cfg).init(torch.Generator().manual_seed(0),
                                     device="cpu")
    got, meta = load_checkpoint(str(tmp_path), template, device="cpu")
    assert meta["step"] == 3
    assert [tuple(x.shape) for x in tree_leaves(got)] == \
        [tuple(x.shape) for x in tree_leaves(template)]
    assert all(x.device.type == "cpu" and x.dtype == torch.float32
               for x in tree_leaves(got))
    _trees_equal(got, want)


def test_leaf_names_and_order_equal_the_references(R, tmp_path):
    """The same tree written by both packages: the same ``names``,
    ``dtypes``, ``shapes``, ``step`` and ``user``, and the same arrays under
    the same ``a<i>`` keys. A tree of dicts, lists and tuples, and a
    model's params."""
    rng = np.random.default_rng(0)
    mixed = {"b": [rng.normal(size=(2, 3)).astype(np.float32),
                   (np.arange(4, dtype=np.int32),
                    rng.normal(size=(5,)).astype(np.float32))],
             "a": {"z": np.float32(2.5) * np.ones((1,), np.float32),
                   "c": rng.normal(size=(3, 1)).astype(np.float32)}}
    for i, tree in enumerate((mixed, _ref_params(R)[2])):
        ours, theirs = tmp_path / f"port{i}", tmp_path / f"ref{i}"
        save_checkpoint(str(ours), tree_map(torch.tensor, tree), step=i,
                        metadata={"k": i})
        R.checkpoint.save_checkpoint(str(theirs), tree, step=i,
                                     metadata={"k": i})
        metas = [json.loads((d / "meta.json").read_text())
                 for d in (ours, theirs)]
        for key in ("step", "names", "dtypes", "shapes", "user"):
            assert metas[0][key] == metas[1][key], key
        with np.load(ours / "tensors.npz") as a, \
                np.load(theirs / "tensors.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype
    assert metas[0]["names"][:2] == ["embed", "final_ln/scale"]


@pytest.mark.parametrize("fault", ["shape", "leaf_count"])
def test_load_checkpoint_checks_the_template(tmp_path, fault):
    """The reference's checks and messages: the number of leaves, and
    every leaf's shape."""
    tree = {"w": torch.ones((2, 3)), "b": torch.zeros((3,))}
    save_checkpoint(str(tmp_path), tree)
    if fault == "shape":
        bad, match = {"w": torch.ones((3, 2)), "b": torch.zeros((3,))}, \
            r"leaf w: checkpoint shape \(2, 3\) != template shape \(3, 2\)"
    else:
        bad, match = {"w": torch.ones((2, 3))}, \
            "checkpoint has 2 leaves, template has 1"
    with pytest.raises(ValueError, match=match):
        load_checkpoint(str(tmp_path), bad, device="cpu")
    got, _ = load_checkpoint(str(tmp_path), tree, device="cpu")
    assert torch.equal(got["w"], tree["w"]) and torch.equal(got["b"],
                                                            tree["b"])


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-7b"])
def test_train_cli_checkpoint_then_serve_cli_restores_it(capsys, tmp_path,
                                                         arch):
    """``launch.train --checkpoint`` writes the trained consensus view,
    which ``launch.serve --checkpoint`` restores into a fresh model."""
    ckpt = str(tmp_path / "ckpt")
    train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--steps", "2", "--nodes", "3", "--per-node-batch", "2",
                    "--seq-len", "16", "--gamma-n", "1e-7",
                    "--checkpoint", ckpt])
    out = capsys.readouterr().out
    assert f"checkpoint written to {ckpt}" in out
    meta = json.loads(open(os.path.join(ckpt, "meta.json")).read())
    assert meta["step"] == 2
    assert meta["user"] == {"arch": arch, "algorithm": "partpsp"}
    template = Transformer(get_config(arch).smoke).init(
        torch.Generator().manual_seed(0), device="cpu")
    saved, _ = load_checkpoint(ckpt, template, device="cpu")
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(saved))
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(saved), tree_leaves(template)))
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--gen", "4",
                    "--checkpoint", ckpt])
    out = capsys.readouterr().out
    assert "restored checkpoint (step 2)" in out
    assert "decode: 3 steps" in out and "generated token ids" in out


# -- optimizers ----------------------------------------------------------------

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 6)).astype(np.float32),
            "layers": [rng.normal(size=(3,)).astype(np.float32),
                       rng.normal(size=(2, 2, 5)).astype(np.float32)]}


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", dict(lr=0.1)), ("sgd", dict(lr=0.1, momentum=0.9)),
    ("adamw", dict(lr=0.01, weight_decay=0.05))])
def test_optimizers_match_reference(R, name, kwargs):
    ours = {"sgd": sgd, "adamw": adamw}[name](**kwargs)
    theirs = getattr(R.optim, name)(**kwargs)
    params = _opt_tree(0)
    p, st = tree_map(torch.tensor, params), None
    rp, rst = jax.tree_util.tree_map(jnp.asarray, params), None
    st, rst = ours.init(p), theirs.init(rp)
    for t in range(3):
        grads = _opt_tree(10 + t)
        p, st = ours.update(tree_map(torch.tensor, grads), st, p)
        rp, rst = theirs.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                rst, rp)
    assert int(st.step) == int(rst.step) == 3
    for a, b in zip(tree_leaves(p), jax.tree_util.tree_leaves(rp)):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    for moment in ("mu", "nu"):
        mine, want = getattr(st, moment), getattr(rst, moment)
        assert (mine is None) == (want is None)
        if want is not None:
            for a, b in zip(tree_leaves(mine),
                            jax.tree_util.tree_leaves(want)):
                np.testing.assert_allclose(to_numpy(a), np.asarray(b),
                                           rtol=1e-6, atol=1e-7)


def test_global_norm_matches_reference(R):
    tree = _opt_tree(3)
    got = global_norm(tree_map(torch.tensor, tree))
    want = R.optim.global_norm(jax.tree_util.tree_map(jnp.asarray, tree))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(global_norm({})) == 0.0


# -- full-state checkpoints ---------------------------------------------------

def test_full_state_names_dtypes_and_shapes_equal_the_references(R, tmp_path):
    cfg, ref_model, params = _ref_params(R)
    port, st, ref, rst = _sessions(R, cfg, ref_model, params)
    st = st._replace(dpps=st.dpps._replace(t=3))
    rst = rst._replace(dpps=rst.dpps._replace(t=jnp.asarray(3, jnp.int32)))
    port.save(str(tmp_path / "port"), st, step=3, metadata={"k": 1})
    ref.save(str(tmp_path / "ref"), rst, step=3, metadata={"k": 1})
    metas = [json.loads((tmp_path / d / "meta.json").read_text())
             for d in ("port", "ref")]
    for key in ("step", "names", "dtypes", "shapes", "user"):
        assert metas[0][key] == metas[1][key], key
    names = metas[0]["names"]
    assert names[0] == ".dpps/.push/.s/0"
    assert [n for n in names if not n.startswith((".dpps/.push/.s/",
                                                  ".local/"))] == [
        ".dpps/.push/.a", ".dpps/.sens/.s_local",
        ".dpps/.sens/.prev_noise_l1", ".dpps/.sens/.c_prime",
        ".dpps/.sens/.lam", ".dpps/.t"]
    t_index = names.index(".dpps/.t")
    assert metas[0]["dtypes"][t_index] == "int32"
    assert metas[0]["shapes"][t_index] == []
    with np.load(tmp_path / "port" / "tensors.npz") as a, \
            np.load(tmp_path / "ref" / "tensors.npz") as b:
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])
    got, meta = port.restore(str(tmp_path / "ref"))
    assert got.dpps.t == 3 and isinstance(got.dpps.t, int)
    assert type(got).__name__ == "PartPSPState"
    _trees_equal(got.dpps.push.s, rst.dpps.push.s)
    _trees_equal(got.local, rst.local)


def _resume_runs(R, writer, tmp_path):
    """Three engine rounds in the writer's package, saved; restored in the
    other package (and in the writer's own) and run four more rounds."""
    ref_session, session, batches = mlp_sessions(R)
    d_s = session.partition.d_shared()
    bits_at = lambda t: torch.from_numpy(reference_bits(
        2024, t, session.n_nodes, d_s, partpsp=True))
    port_batch = lambda t: tree_from_numpy(batches[t], device="cpu")
    ref_batch = lambda t: jax.tree_util.tree_map(jnp.asarray, batches[t])
    path = str(tmp_path / "state")
    if writer == "port":
        first = session.train(3, port_batch, bits_at=bits_at)
        session.save(path, first.state, step=3)
    else:
        first = ref_session.train(3, ref_batch)
        ref_session.save(path, first.state, step=3)
    restored, meta = session.restore(path)
    ref_restored, ref_meta = ref_session.restore(path)
    assert meta["step"] == ref_meta["step"] == 3
    assert restored.dpps.t == int(ref_restored.dpps.t) == 3
    port_rest = session.train(4, port_batch, state=restored, bits_at=bits_at)
    ref_rest = ref_session.train(4, ref_batch, state=ref_restored, start=3)
    whole = ref_session.train(7, ref_batch)
    return port_rest, ref_rest, whole


def _close_states(got, want, rtol=1e-4, atol=1e-5):
    for x, y in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        if isinstance(x, int):
            assert x == int(y)
            continue
        want_np = np.asarray(y)
        np.testing.assert_allclose(to_numpy(x), want_np, rtol=rtol,
                                   atol=atol + 1e-6 * float(
                                       np.abs(want_np).max()))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_full_state_restores_across_packages_and_resumes(R, tmp_path,
                                                         writer):
    port_rest, ref_rest, whole = _resume_runs(R, writer, tmp_path)
    assert port_rest.state.dpps.t == int(ref_rest.state.dpps.t) == 7
    _close_states(port_rest.state, whole.state)
    _close_states(ref_rest.state, whole.state, rtol=1e-6, atol=1e-7)
    for k in ("loss_mean", "sensitivity_used", "noise_l1_mean"):
        np.testing.assert_allclose(port_rest.trajectory[k],
                                   np.asarray(whole.trajectory[k])[3:],
                                   rtol=1e-4, atol=1e-5)


def test_restored_run_continues_the_philox_stream_bit_for_bit(R, tmp_path):
    _, session, batches = mlp_sessions(R)
    batch_at = lambda t: tree_from_numpy(batches[t], device="cpu")
    whole = session.train(7, batch_at)
    first = session.train(3, batch_at)
    session.save(str(tmp_path), first.state, step=3)
    restored, _ = session.restore(str(tmp_path))
    rest = session.train(4, batch_at, state=restored)
    for x, y in zip(tree_leaves(rest.state), tree_leaves(whole.state)):
        if isinstance(x, int):
            assert x == y
        else:
            assert torch.equal(x, y)
    for k, v in rest.trajectory.items():
        np.testing.assert_array_equal(v, whole.trajectory[k][3:])


@pytest.mark.parametrize("reader", ["port", "reference"])
def test_async_state_restores_across_packages_and_resumes(R, tmp_path,
                                                          reader):
    """A state carrying a Mailbox (delays and faults on): both packages
    save 3 rounds under the same names, shapes and dtypes
    (``.dpps/.mail/.cal_s/0``, ...); the ``reader``'s restore of the other
    package's file resumes 3 rounds (``start=3``) to the reference's
    uninterrupted 6, within the training tolerance; a ``start`` that is not
    the restored counter raises."""
    from test_torch_net import mlp_sessions
    from test_torch_reference import (reference_delay_draws,
                                      reference_fault_draws)

    kw = dict(delays=dict(max_delay=2, timeout_rate=0.1, seed=3),
              faults=dict(drop_rate=0.2), sync_interval=0, noise=True)
    ref_session, session, batches = mlp_sessions(R, rounds=6, **kw)
    d_s, n, plan = session.partition.d_shared(), session.n_nodes, session.plan
    draws = dict(
        bits_at=lambda t: torch.from_numpy(reference_bits(
            2024, t, n, d_s, partpsp=True)),
        fault_draws_at=lambda t: reference_fault_draws(plan.faults, 2024, t,
                                                       (n, n)),
        delay_draws_at=lambda t: reference_delay_draws(plan.delays, 2024, t,
                                                       (n, n)))
    port_batch = lambda t: tree_from_numpy(batches[t], device="cpu")
    ref_batch = lambda t: jax.tree_util.tree_map(jnp.asarray, batches[t])
    first = session.train(3, port_batch, **draws)
    session.save(str(tmp_path / "port"), first.state, step=3)
    ref_first = ref_session.train(3, ref_batch)
    ref_session.save(str(tmp_path / "reference"), ref_first.state, step=3)
    metas = [json.loads((tmp_path / d / "meta.json").read_text())
             for d in ("port", "reference")]
    for key in ("step", "names", "dtypes", "shapes"):
        assert metas[0][key] == metas[1][key], key
    names = metas[0]["names"]
    assert [x for x in names if x.startswith(".dpps/.mail/")] == [
        ".dpps/.mail/.cal_s/0", ".dpps/.mail/.cal_s/1",
        ".dpps/.mail/.cal_a", ".dpps/.mail/.inbox_s/0",
        ".dpps/.mail/.inbox_s/1", ".dpps/.mail/.inbox_a"]
    path = str(tmp_path / ("reference" if reader == "port" else "port"))
    whole = ref_session.train(6, ref_batch)
    if reader == "port":
        restored, _ = session.restore(path)
        assert restored.dpps.t == 3
        with pytest.raises(ValueError, match="start=0"):
            session.train(1, port_batch, state=restored, start=0)
        rest = session.train(3, port_batch, state=restored, start=3, **draws)
    else:
        restored, _ = ref_session.restore(path)
        rest = ref_session.train(3, ref_batch, state=restored, start=3)
    assert int(rest.state.dpps.t) == 6
    _close_states(rest.state, whole.state)
    for k in ("loss_mean", "async_mass_mean", "noise_l1_mean"):
        np.testing.assert_allclose(rest.trajectory[k],
                                   np.asarray(whole.trajectory[k])[3:],
                                   rtol=1e-4, atol=1e-5)
    for k in ("async_delay_hist", "net_out_degree", "async_participated"):
        np.testing.assert_array_equal(rest.trajectory[k],
                                      np.asarray(whole.trajectory[k])[3:])
