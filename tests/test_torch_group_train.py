"""PartPSP training of the other group kinds against the reference, on the
CPU: ``Session.train(model=Transformer(cfg))`` for 3 rounds, noise off and
on, of one smoke config of each kind the attention-only family lacks:

* MoE: llama4-maverick's (``moe_every = 2``: dense units beside the MoE
  ones, whose aux loss reaches each node's loss);
* xLSTM: xlstm-125m's (mLSTM shared, sLSTM local);
* Mamba2/Zamba2: zamba2-7b's (the shared attention block shared);
* cross-attention: llama-3.2-vision-11b's, with seeded image embeddings
  (N, B, M, d_model) cut per node and its cross gates at 0.5 (at their
  init of zero the cross weights would get no gradient).

Each arch's own PartPSP rules. The reference runs its kernel path for the
noise (interpret mode on the CPU) and the port is fed the same bits
through ``bits_at``. Tolerances as ``test_torch_train.py``'s session
test: rtol 1e-4 / atol 1e-5 plus 1e-6 of each array's largest magnitude
(f32 matmuls and recurrences summed in other orders, carried through
three rounds of mixing). Every MoE token's top-1 routing margin is
asserted above 1e-4 in every pass, so the routing is the reference's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import cfg_to_reference
from test_torch_reference import load_reference, reference_bits
from test_torch_session import _close, _trees_close
from test_torch_train import MARGIN, routing_margins

from repro_torch import convert
from repro_torch.api import PrivacySpec, Session
from repro_torch.configs import get_config
from repro_torch.core import topology as T
from repro_torch.core.partpsp import node_stacked
from repro_torch.core.tree_utils import tree_map
from repro_torch.models.attention import open_cross_gates
from repro_torch.models.transformer import Transformer

SEED, N, ROUNDS, SYNC, CHUNK = 2024, 4, 3, 2, 2
B, S = 2, 16
# Below the Remark-1 stability limit (1/lam - 1) b / (2 C' d_s) of every
# arch here at b = 1 on DOutGraph(4, 2): the smallest is xlstm's, 8.0e-7
# at d_s = 297,096.
GAMMA_N = 1e-7
# The reference's init key of the params. Routing is discrete: at this key
# every MoE token's top-1 margin clears MARGIN in every pass of the three
# rounds, noise off and on (at key 2024 one token of 768 sits at 2.2e-5,
# where an ulp of difference between the packages could flip it).
PARAMS_KEY = 2034
ARCHS = ("llama4-maverick-400b-a17b", "xlstm-125m", "zamba2-7b",
         "llama-3.2-vision-11b")


@pytest.fixture(scope="module")
def R():
    return load_reference()


def _batches(R, cfg):
    """The reference's synthetic token batches (N, B, S) for ROUNDS rounds;
    for a VLM, seeded image embeddings (N, B, M, d_model) beside them."""
    stream = R.data.SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=S,
                                      n_nodes=N, seed=SEED)
    loader = R.data.NodeShardedLoader(stream, per_node_batch=B, seed=SEED)
    rng = np.random.default_rng(SEED)
    out = []
    for t in range(ROUNDS):
        batch = jax.tree_util.tree_map(np.asarray, loader.batch_at(t))
        if cfg.groups[0].kind == "cross_self":
            m = cfg.groups[0].n_image_tokens
            batch["image_embeds"] = (rng.normal(size=(N, B, m, cfg.d_model))
                                     * 0.1).astype(np.float32)
        out.append(batch)
    return out


@pytest.fixture(scope="module")
def group_runs(R):
    """arch -> (cfg, rules, params, batches, {noise: (session, report)}) of
    the reference."""
    runs = {}
    for arch in ARCHS:
        spec = get_config(arch)
        cfg = spec.smoke
        rules = tuple(spec.shared_rules)
        ref_model = R.models.Transformer(cfg_to_reference(R, cfg))
        params = open_cross_gates(jax.tree_util.tree_map(
            np.asarray, ref_model.init(jax.random.PRNGKey(PARAMS_KEY))))
        batches = _batches(R, cfg)
        by_noise = {}
        for noise in (False, True):
            ref_session = R.api.Session.build(
                R.core.topology.DOutGraph(N, 2),
                privacy=R.api.PrivacySpec(b=1.0, gamma_n=GAMMA_N, noise=noise),
                model=ref_model,
                params=jax.tree_util.tree_map(jnp.asarray, params),
                partition=rules, algorithm="partpsp", gamma_l=0.05,
                gamma_s=0.05, clip=100.0, schedule="dense",
                sync_interval=SYNC, chunk=CHUNK, seed=SEED, use_kernels=noise)
            rep = ref_session.train(ROUNDS, lambda t: jax.tree_util.tree_map(
                jnp.asarray, batches[t]))
            by_noise[noise] = (ref_session, rep)
        runs[arch] = (cfg, rules, params, batches, by_noise)
    return runs


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_session_train_of_the_other_group_kinds_matches_reference(
        group_runs, arch, noise, monkeypatch):
    cfg, rules, params, batches, by_noise = group_runs[arch]
    ref_session, ref_rep = by_noise[noise]
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
    margins = routing_margins(monkeypatch)
    rep = session.train(
        ROUNDS, lambda t: {k: torch.tensor(v) for k, v in batches[t].items()},
        bits_at=bits_at)
    moe_units = sum(g.n_units for g in cfg.groups if g.kind == "moe")
    # two gradient passes a round, each forward and its recompute, a node
    assert len(margins) == ROUNDS * 2 * 2 * N * moe_units
    assert all(m > MARGIN for m in margins), min(margins)
    assert rep.rounds == ref_rep.rounds == ROUNDS
    assert set(rep.trajectory) == set(ref_rep.trajectory)
    for k, v in ref_rep.trajectory.items():
        _close(rep.trajectory[k], v, 1e-4, 1e-5)
    st, want = rep.state, ref_rep.state
    assert st.dpps.t == int(want.dpps.t) == ROUNDS
    _trees_close(st.dpps.push.s, want.dpps.push.s, 1e-4, 1e-5)
    _close(st.dpps.push.a, want.dpps.push.a, 1e-4, 1e-5)
    _trees_close(st.local, want.local, 1e-4, 1e-5)
    _trees_close(session.consensus_view(st, 0),
                 ref_session.consensus_view(want, 0), 1e-4, 1e-5)
    assert np.all(np.isfinite(rep.trajectory["loss_mean"]))
    if noise:
        assert rep.trajectory["noise_l1_mean"].min() > 0


def test_node_stacked_cuts_image_embeds_and_keeps_each_nodes_aux():
    """``node_stacked`` hands node i its own slice of every batch leaf (the
    VLM's image embeddings too), and each node's loss includes its MoE aux:
    the stacked losses equal the single-node losses node by node."""
    for arch in ("llama-3.2-vision-11b", "llama4-scout-17b-a16e"):
        cfg = get_config(arch).smoke
        model = Transformer(cfg)
        params = open_cross_gates(model.init(torch.Generator().manual_seed(0),
                                             device="cpu"))
        n = 3
        stacked = tree_map(lambda x: x[None].expand((n,) + tuple(x.shape)),
                           params)
        gen = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (n, 2, 12),
                                         generator=gen)}
        if cfg.groups[0].kind == "cross_self":
            batch["image_embeds"] = torch.randn(
                (n, 2, cfg.groups[0].n_image_tokens, cfg.d_model),
                generator=gen) * 0.1
        with torch.no_grad():
            losses = node_stacked(model.loss_fn)(stacked, batch)
            for i in range(n):
                node_batch = {k: v[i] for k, v in batch.items()}
                want = model.loss_fn(params, node_batch)
                assert torch.equal(losses[i], want)
                _, aux = model.forward_train(params, node_batch)
                assert (float(aux) > 0.0) == (arch != "llama-3.2-vision-11b")
        assert len(set(losses.tolist())) == n  # each node saw its own slice
