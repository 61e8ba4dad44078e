"""The port's training path against the reference, on the CPU.

* ``Transformer.forward_train`` / ``loss_fn`` and the loss's gradients
  against the reference's ``jax.value_and_grad`` for all ten smoke configs
  (musicgen-large on embeddings; the MoE configs' aux loss and router
  gradient, with their top-1 routing margins asserted; the VLM with seeded
  image embeddings and its cross gates at 0.5), and for a plain Mamba2
  model;
* the sequence-chunked loss against one unchunked cross entropy, and the
  checkpointed gradients against gradients without checkpoint (an
  attention model and the recurrent zamba2 smoke model);
* ``Session.train(model=Transformer)`` against the reference's, 3 rounds,
  noise off and on (the port fed the reference's bits through
  ``bits_at``);
* ``SyntheticLMStream`` / ``NodeShardedLoader``, the train CLI (the VLM's
  missing image embeddings), and the plain mix at N = 64 against the
  reference's interpret-mode kernel.

``Session.train`` of the other group kinds and the checkpoint round trip
are in ``test_torch_group_train.py`` and ``test_torch_checkpoint.py``.

Tolerances (f32): loss and hidden states rtol 1e-4 / atol 1e-5 (matmuls and
softmax summed in another order); gradients rtol 1e-4 plus 1e-5 of the
leaf's largest reference gradient (entries near zero are differences of
much larger terms); training state and trajectory rtol 1e-4 / atol 1e-5
plus 1e-6 of the array's largest magnitude, as the MLP session test.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import cfg_to_reference, image_embeds
from test_torch_reference import load_reference, reference_bits, to_numpy
from test_torch_session import _close, _trees_close

from repro_torch import convert
from repro_torch.api import PrivacySpec, Session
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import topology as T
from repro_torch.core.partition import LayerParts, Partition, layer_list
from repro_torch.core.partpsp import node_stacked
from repro_torch.core.tree_utils import (tree_flatten, tree_leaves, tree_map,
                                         tree_unflatten)
from repro_torch.data import NodeShardedLoader, SyntheticLMStream
from repro_torch.kernels import ref
from repro_torch.api import cli as cli_mod
from repro_torch.launch import train as train_cli
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.attention import open_cross_gates
from repro_torch.models.config import MambaGroup
from repro_torch.models.transformer import Transformer

SEED, N, ROUNDS, SYNC, CHUNK = 2024, 4, 3, 2, 2
B, S = 2, 24
# Below the Remark-1 recursion's stability limit (1/lam - 1) b / (2 C' d_s)
# at d_s = 139,520: a larger rate grows the sensitivity tenfold a round and
# the training diverges in both packages.
GAMMA_N = 1e-7


@pytest.fixture(scope="module")
def R():
    return load_reference()


# the top-1 routing margin every MoE token must clear for the port's routing
# to be the reference's (a flip would change the token's output wholesale)
MARGIN = 1e-4


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s), dtype=np.int32)
    if cfg.input_mode == "embeddings":
        emb = (rng.normal(size=(b, s, cfg.d_model)) * 0.1).astype(np.float32)
        return {"embeds": emb, "labels": toks}
    batch = {"tokens": toks}
    enc = image_embeds(cfg, b, seed)
    if enc is not None:
        batch["image_embeds"] = enc
    return batch


def routing_margins(monkeypatch) -> list:
    """Record the gap between the largest and second router probability of
    every token each ``moe_route`` call sees."""
    margins, real = [], moe.moe_route

    def route(router, tokens, n_experts, cap):
        r = real(router, tokens, n_experts, cap)
        top2 = torch.topk(r["probs"].detach(), 2, dim=-1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        return r

    monkeypatch.setattr(moe, "moe_route", route)
    return margins


def _port_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


# -- the loss and its gradients, five configs ---------------------------------

def _mamba_cfg():
    """A model of one plain Mamba2 group (zamba2 runs Mamba2 in units)."""
    return dataclasses.replace(get_config("llama3.2-1b").smoke,
                               name="mamba-smoke",
                               groups=(MambaGroup(n_layers=2, d_state=16),))


def _reference_loss(R, cfg):
    """The reference's hidden states, aux, loss and gradients of ``cfg`` on
    seeded params (the VLM's gates at 0.5) and batch."""
    ref_model = R.models.Transformer(cfg_to_reference(R, cfg))
    params = open_cross_gates(jax.tree_util.tree_map(
        np.asarray, ref_model.init(jax.random.PRNGKey(1))))
    batch = _batch(cfg, B, S, seed=5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    h, aux = ref_model.forward_train(jp, jb)
    loss, grads = jax.value_and_grad(ref_model.loss_fn)(jp, jb)
    return (cfg, params, batch, np.asarray(h), float(aux), float(loss),
            jax.tree_util.tree_map(np.asarray, grads))


@pytest.fixture(scope="module")
def loss_runs(R):
    """For each smoke config: the reference's hidden states, loss and
    gradients on seeded params and batch, and the port's inputs."""
    return {arch: _reference_loss(R, get_config(arch).smoke)
            for arch in ARCH_NAMES}


def _check_loss_and_gradients(run, monkeypatch):
    """The port's forward, aux, loss and every leaf's gradient against the
    reference's; every MoE token's routing margin above :data:`MARGIN`."""
    cfg, params, batch, want_h, want_aux, want_loss, want_g = run
    model = Transformer(cfg)
    port = convert.transformer_params_from_reference(params, cfg, device="cpu")
    leaves = tree_leaves(port)
    for x in leaves:
        x.requires_grad_(True)
    pb = _port_batch(batch)
    margins = routing_margins(monkeypatch)
    with torch.no_grad():
        h, aux = model.forward_train(port, pb)
    _close(h, want_h, 1e-4, 1e-5)
    moe_blocks = sum(g.n_units for g in cfg.groups if g.kind == "moe")
    assert len(margins) == moe_blocks
    assert all(m > MARGIN for m in margins), margins
    if moe_blocks:
        assert want_aux > 0.0
        np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)
    else:
        assert float(aux) == want_aux == 0.0
    loss = model.loss_fn(port, pb)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-4, atol=1e-5)
    # musicgen-large reads embeddings: its token table is unused (zero
    # gradient in the reference)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = jax.tree_util.tree_flatten_with_path(want_g)[0]
    assert len(grads) == len(want)
    for g, (path, w), x in zip(grads, want, leaves):
        g = torch.zeros_like(x) if g is None else g
        assert tuple(g.shape) == w.shape
        _grad_close(g, w)
    return dict(zip((jax.tree_util.keystr(p) for p, _ in want), grads))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_gradients_match_reference(loss_runs, arch, monkeypatch):
    grads = _check_loss_and_gradients(loss_runs[arch], monkeypatch)
    routers = [g for p, g in grads.items() if "router" in p]
    assert bool(routers) == (get_config(arch).family == "moe")
    for g in routers:  # the router learns through the gate and the aux
        assert float(g.abs().max()) > 0.0


def test_mamba_group_loss_and_gradients_match_reference(R, monkeypatch):
    """A model of plain Mamba2 layers (no zamba units around them)."""
    _check_loss_and_gradients(_reference_loss(R, _mamba_cfg()), monkeypatch)


def _tiny_model(arch="llama3.2-1b"):
    cfg = get_config(arch).smoke
    model = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    return cfg, model, params


def test_chunked_loss_equals_one_cross_entropy():
    """S = 1,100: two chunks of 512 and a remainder of 75, against one
    cross entropy over all (B, S - 1) positions; rtol 1e-5 (f32 sums of
    1,099 terms in another grouping)."""
    cfg, model, params = _tiny_model()
    toks = torch.randint(0, cfg.vocab_size, (1, 1100),
                         generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        loss = model.loss_fn(params, {"tokens": toks})
        h, _ = model.forward_train(params, {"tokens": toks})
        logits = model._head(params, h[:, :-1])
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab_size), toks[:, 1:].reshape(-1))
    assert (1100 - 1) // model.LOSS_CHUNK == 2
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)


def test_checkpointed_gradients_equal_plain_ones(monkeypatch):
    """The layers and loss chunks under ``torch.utils.checkpoint`` give the
    gradients of the same forward without it, bit for bit (the recompute
    repeats the same operations on the CPU)."""
    cfg, model, params = _tiny_model("gemma3-1b")
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(5))
    monkeypatch.setattr(model, "LOSS_CHUNK", 16)  # two chunks + remainder

    def grads():
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        p = tree_unflatten(tree_flatten(params)[1], leaves)
        loss = model.loss_fn(p, {"tokens": toks})
        return loss, torch.autograd.grad(loss, leaves)

    calls = []
    real = tf.checkpoint
    monkeypatch.setattr(tf, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loss_ck, g_ck = grads()
    assert len(calls) == cfg.total_layers + 3
    monkeypatch.setattr(tf, "_remat", lambda fn, *args: fn(*args))
    loss, g = grads()
    assert torch.equal(loss_ck, loss)
    for a, b in zip(g_ck, g):
        assert torch.equal(a, b)


def test_checkpointed_recurrent_gradients_equal_plain_ones(monkeypatch):
    """zamba2's smoke model: each unit checkpointed with its Mamba2 layers
    checkpointed again inside it (the reference's nesting), bit for bit the
    gradients without checkpoint."""
    cfg = get_config("zamba2-7b").smoke
    model = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(5))

    def grads():
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        p = tree_unflatten(tree_flatten(params)[1], leaves)
        loss = model.loss_fn(p, {"tokens": toks})
        return loss, torch.autograd.grad(loss, leaves)

    calls = []
    real = tf.checkpoint
    monkeypatch.setattr(tf, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loss_ck, g_ck = grads()
    (group,) = cfg.groups
    # the units, their Mamba2 layers (in the forward, and again in each
    # unit's recompute) and the one loss chunk
    assert len(calls) == group.n_units + 2 * group.n_units \
        * group.mamba_per_unit + 1
    monkeypatch.setattr(tf, "_remat", lambda fn, *args: fn(*args))
    loss, g = grads()
    assert torch.equal(loss_ck, loss)
    for a, b in zip(g_ck, g):
        assert torch.equal(a, b)


def test_node_stacked_loss_with_layer_parts_equals_the_concatenated_one():
    """``node_stacked`` over PartPSP's uncopied layer parts: the same
    per-node losses and gradients as the single-node loss on each node's
    concatenated params."""
    cfg, model, params = _tiny_model()
    n = 3
    stacked = tree_map(lambda x: x[None].repeat((n,) + (1,) * x.dim())
                       * torch.linspace(0.9, 1.1, n).reshape(
                           (n,) + (1,) * x.dim()), params)
    part = Partition.from_rules(stacked, (("group_0/.*", ("split_layers", 1)),),
                                default="local")
    shared, local = part.split(stacked)
    merged = part.merge(shared, local, layer_parts=True)
    wq = merged["group_0"]["attn"]["wq"]
    assert isinstance(wq, LayerParts) and len(wq.parts) == 2
    assert [p.shape[1] for p in wq.parts] == [1, 1]
    toks = torch.randint(0, cfg.vocab_size, (n, 2, 16),
                         generator=torch.Generator().manual_seed(6))
    wrt = [x.requires_grad_(True) for x in shared + local]
    losses = node_stacked(model.loss_fn)(merged, {"tokens": toks})
    got = torch.autograd.grad(losses.sum(), wrt)
    for i in range(n):
        node = tree_map(lambda x: x[i].detach().requires_grad_(True),
                        part.merge(shared, local))
        want = model.loss_fn(node, {"tokens": toks[i]})
        assert torch.equal(losses[i], want)
    want = torch.autograd.grad(
        node_stacked(model.loss_fn)(part.merge(shared, local),
                                    {"tokens": toks}).sum(), wrt)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    node1 = merged["group_0"]["mlp"]["w_up"].unbind(0)[1]
    layers = layer_list(node1)
    want = stacked["group_0"]["mlp"]["w_up"][1]
    assert len(layers) == 2
    assert torch.equal(layers[0], want[0]) and torch.equal(layers[1], want[1])


# -- Session.train with a Transformer ------------------------------------------

@pytest.fixture(scope="module")
def train_runs(R):
    """The reference's ``Session.train`` of the llama3.2-1b smoke model
    (split_layers clamped to 1) on N = 4, noise off and on, with its
    params, batches and rules."""
    arch = get_config("llama3.2-1b")
    cfg = arch.smoke
    rules = tuple((pat, ("split_layers", 1) if isinstance(act, tuple) else act)
                  for pat, act in arch.shared_rules)
    ref_model = R.models.Transformer(cfg_to_reference(R, cfg))
    params = jax.tree_util.tree_map(np.asarray,
                                    ref_model.init(jax.random.PRNGKey(SEED)))
    stream = R.data.SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=S,
                                      n_nodes=N, seed=SEED)
    loader = R.data.NodeShardedLoader(stream, per_node_batch=B, seed=SEED)
    batches = [jax.tree_util.tree_map(np.asarray, loader.batch_at(t))
               for t in range(ROUNDS)]
    runs = {}
    for noise in (False, True):
        ref_session = R.api.Session.build(
            R.core.topology.DOutGraph(N, 2),
            privacy=R.api.PrivacySpec(b=1.0, gamma_n=GAMMA_N, noise=noise),
            model=ref_model, params=jax.tree_util.tree_map(jnp.asarray, params),
            partition=rules, algorithm="partpsp", gamma_l=0.05, gamma_s=0.05,
            clip=100.0, schedule="dense", sync_interval=SYNC, chunk=CHUNK,
            seed=SEED, use_kernels=noise)
        rep = ref_session.train(ROUNDS, lambda t: jax.tree_util.tree_map(
            jnp.asarray, batches[t]))
        runs[noise] = (ref_session, rep)
    return cfg, rules, params, batches, runs


@pytest.mark.parametrize("noise", [False, True])
def test_session_train_with_a_transformer_matches_reference(train_runs, noise):
    cfg, rules, params, batches, runs = train_runs
    ref_session, ref_rep = runs[noise]
    session = Session.build(
        T.DOutGraph(N, 2), privacy=PrivacySpec(b=1.0, gamma_n=GAMMA_N,
                                               noise=noise),
        model=Transformer(cfg),
        params=convert.transformer_params_from_reference(params, cfg,
                                                         device="cpu"),
        partition=rules, algorithm="partpsp", gamma_l=0.05, gamma_s=0.05,
        clip=100.0, schedule="dense", sync_interval=SYNC, chunk=CHUNK,
        seed=SEED, device="cpu")
    d_s = session.partition.d_shared()
    assert d_s == ref_session.partition.d_shared()
    assert session.partition.d_local() == ref_session.partition.d_local()
    bits_at = ((lambda t: torch.from_numpy(reference_bits(
        SEED, t, N, d_s, partpsp=True))) if noise else None)
    rep = session.train(ROUNDS, lambda t: _port_batch(batches[t]),
                        bits_at=bits_at)
    assert rep.rounds == ref_rep.rounds == ROUNDS
    assert set(rep.trajectory) == set(ref_rep.trajectory)
    for k, v in ref_rep.trajectory.items():
        _close(rep.trajectory[k], v, 1e-4, 1e-5)
    st, want = rep.state, ref_rep.state
    assert st.dpps.t == int(want.dpps.t) == ROUNDS
    _trees_close(st.dpps.push.s, want.dpps.push.s, 1e-4, 1e-5)
    _close(st.dpps.push.a, want.dpps.push.a, 1e-4, 1e-5)
    _trees_close(st.local, want.local, 1e-4, 1e-5)
    # the reference's final state carried across, leaf for leaf
    carried = convert.partpsp_state_from_reference(
        jax.tree_util.tree_map(np.asarray, want), device="cpu")
    _trees_close(st.local, carried.local, 1e-4, 1e-5)
    view = session.consensus_view(rep.state, 1)
    _trees_close(view, ref_session.consensus_view(ref_rep.state, 1), 1e-4,
                 1e-5)
    stacked = jax.tree_util.tree_map(
        np.asarray, ref_session.init_params)
    conv = convert.transformer_params_from_reference(stacked, cfg,
                                                     device="cpu", nodes=N)
    _trees_close(conv, session.init_params, 0, 0)
    assert np.all(np.isfinite(rep.trajectory["loss_mean"]))
    if noise:
        assert rep.trajectory["noise_l1_mean"].min() > 0


def test_session_builds_the_model_init_on_every_node_and_serves():
    """Without params a trainable model's init is broadcast to every node
    (one copy of the values: a stride-0 view); the session also serves."""
    cfg, model, _ = _tiny_model()
    session = Session.build(T.DOutGraph(3, 2), model=model, device="cpu",
                            seed=11, schedule="dense")
    want = model.init(torch.Generator().manual_seed(11), device="cpu")
    for x, w in zip(tree_leaves(session.init_params), tree_leaves(want)):
        assert x.shape == (3,) + tuple(w.shape) and x.stride(0) == 0
        assert torch.equal(x[2], w)
    rep = session.serve(want, {"tokens": torch.zeros((1, 5), dtype=torch.long)},
                        gen=2)
    assert rep.tokens.shape == (1, 2)


# -- data --------------------------------------------------------------------

def test_synthetic_lm_stream_matches_reference_arrays(R):
    want = R.data.SyntheticLMStream(vocab_size=300, seq_len=9, n_nodes=5,
                                    seed=3)
    got = SyntheticLMStream(vocab_size=300, seq_len=9, n_nodes=5, seed=3,
                            device="cpu")
    np.testing.assert_array_equal(got.emit.numpy(), np.asarray(want._emit))
    np.testing.assert_array_equal(got.ctx.numpy(), np.asarray(want._ctx))
    np.testing.assert_array_equal(got.node_temp.numpy(),
                                  np.asarray(want._node_temp))


def test_node_sharded_loader_is_deterministic_and_node_stacked():
    stream = SyntheticLMStream(vocab_size=50, seq_len=12, n_nodes=3, seed=1,
                               device="cpu")
    loader = NodeShardedLoader(stream, per_node_batch=2, seed=9)
    a, b = loader.batch_at(4)["tokens"], loader.batch_at(4)["tokens"]
    assert a.shape == (3, 2, 12) and a.dtype == torch.int32
    assert torch.equal(a, b)
    assert not torch.equal(a, loader.batch_at(5)["tokens"])
    assert int(a.min()) >= 0 and int(a.max()) < 50
    assert torch.equal(next(iter(loader))["tokens"],
                       loader.batch_at(0)["tokens"])


# -- the train CLI -------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["partpsp", "sgp"])
def test_train_cli_runs_reduced_on_the_cpu(capsys, algorithm):
    """PartPSP under the arch's rules, and SGP, which shares every leaf (no
    local leaves to update)."""
    train_cli.main(["--reduced", "--device", "cpu", "--steps", "3",
                    "--nodes", "4", "--gamma-n", "1e-6", "--log-every", "2",
                    "--algorithm", algorithm])
    out = capsys.readouterr().out
    steps = [line for line in out.splitlines() if line.startswith("step")]
    assert len(steps) == 2 and steps[-1].split()[1] == "2"
    losses = [float(line.split("loss=")[1].split()[0]) for line in steps]
    assert all(np.isfinite(losses)) and "privacy:" in out


def test_train_cli_needs_the_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("flag,item", [
    ("--wire=int8", "int8"), ("--wire-dtype=bf16", "bf16")])
def test_train_cli_unported_flags_name_their_roadmap_item(flag, item):
    """The last flags that raised naming their ROADMAP item (item 8's) are
    ported: they select their codec, and no flag is left unported."""
    import warnings

    ap = train_cli._parser()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        codec = _validated_codec(ap, ap.parse_args([flag]))
    assert codec.name == item
    assert not hasattr(train_cli, "_UNPORTED")


def test_train_cli_of_the_vlm_needs_image_embeddings():
    """The launcher's batches carry tokens only, as the reference's
    ``batch_at`` does, so the VLM fails as the reference's ``assert enc is
    not None`` does."""
    with pytest.raises(ValueError, match="image_embeds"):
        train_cli.main(["--arch", "llama-3.2-vision-11b", "--reduced",
                        "--device", "cpu", "--steps", "1", "--nodes", "2"])


# -- the mix at N = 64 ---------------------------------------------------------

def test_plain_mix_at_64_nodes_matches_the_interpret_kernel(R):
    """rtol 1e-5 / atol 1e-6: f32 sums of 64 products in another order."""
    from repro.kernels.pushsum_mix import pushsum_mix

    rng = np.random.default_rng(8)
    w = rng.random((64, 64)).astype(np.float32)
    w /= w.sum(axis=0, keepdims=True)
    x = rng.normal(size=(64, 1024)).astype(np.float32)
    want = np.asarray(pushsum_mix(jnp.asarray(w), jnp.asarray(x),
                                  interpret=True))
    got = ref.pushsum_mix(torch.tensor(w), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _validated_codec(ap, args):
    """The launcher's codec after the shared CLI's parse-time refusals."""
    cli_mod.validate_protocol_args(ap, args)
    return cli_mod.wire_from_args(ap, args)
