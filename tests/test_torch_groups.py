"""The port's MoE, recurrent and cross-attention modules against the
reference, on the CPU.

Same inputs, made with numpy from a seed, and the reference's own
parameters (``init_*`` with a JAX key, copied across) go through
``repro.models.{moe,ssm,attention}`` and ``repro_torch.models.{moe,ssm,
attention}``.

Tolerances: MoE routing (``expert_idx``, ``keep``) exactly, with the top-1
margin at these seeds asserted far above f32 noise (a flip would change a
token's output wholesale); the MoE output and aux loss to rtol 1e-5 / atol
1e-6. The recurrent mixers' outputs and states to rtol 1e-5 / atol 1e-5
(the same f32 cell, in the same order; XLA and PyTorch round exp and the
projections' sums differently by an ulp, carried through 12 steps); a
sequence split in two halves with its state carried to rtol 1e-6 / atol
1e-6 of one whole call (the projections' matmuls may block differently by
length). Cross-attention to rtol 1e-5 / atol 1e-6, with its gate at 0.5:
the reference starts it at zero, which would make the layer add zeros and
check nothing.
"""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import attention, moe, ssm
from test_torch_reference import load_reference, to_numpy

MOE_TOL = dict(rtol=1e-5, atol=1e-6)
SSM_TOL = dict(rtol=1e-5, atol=1e-5)
SPLIT_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def M():
    load_reference()
    return {name: importlib.import_module(f"repro.models.{name}")
            for name in ("moe", "ssm", "attention")}


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _close(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **tol)


# -- MoE ----------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor,drops", [(0.5, True), (4.0, False)])
def test_moe_apply_matches_reference(M, capacity_factor, drops):
    """Routing exactly (every token's expert and whether it is kept), at a
    capacity that drops tokens and at one that drops none; the output and
    the Switch aux loss within MOE_TOL."""
    d, d_ff, n_exp, b, s = 32, 64, 4, 2, 20
    p = M["moe"].init_moe(jax.random.PRNGKey(3), d, d_ff, n_exp,
                          shared_expert=True)
    x = np.random.default_rng(3).normal(size=(b, s, d)).astype(np.float32)
    kw = dict(n_experts=n_exp, capacity_factor=capacity_factor,
              router_aux_weight=0.01)
    want, want_aux = M["moe"].moe_apply(p, jnp.asarray(x), **kw)
    got, aux = moe.moe_apply(_t(p), torch.tensor(x), **kw)

    # the reference's routing, as moe_apply forms it
    tokens = jnp.asarray(x.reshape(b * s, d))
    probs = jax.nn.softmax((tokens @ p["router"]).astype(jnp.float32), axis=-1)
    idx = jnp.argmax(probs, axis=-1)
    pos = jnp.take_along_axis(
        jnp.cumsum(jax.nn.one_hot(idx, n_exp, dtype=jnp.int32), axis=0) - 1,
        idx[:, None], axis=1)[:, 0]
    cap = max(1, int(capacity_factor * b * s / n_exp))
    r = moe.moe_route(_t(p)["router"], torch.tensor(x.reshape(b * s, d)),
                      n_exp, moe.moe_capacity(capacity_factor, b * s, n_exp))
    np.testing.assert_array_equal(r["expert_idx"].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(r["keep"].numpy(), np.asarray(pos < cap))
    top2 = np.sort(np.asarray(probs), axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-4  # f32 noise is ~1e-7
    assert bool((~r["keep"]).any()) == drops

    _close(got, want, MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MOE_TOL)


def test_moe_dropped_tokens_get_only_the_shared_expert():
    """A token past its expert's capacity adds nothing routed: with the
    shared expert's output weights at zero its output is exactly zero."""
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, 16, 32, 2, shared_expert=True)
    p["shared"]["w_down"].zero_()
    x = torch.randn((1, 12, 16), generator=gen)
    out, _ = moe.moe_apply(p, x, n_experts=2, capacity_factor=0.25,
                           router_aux_weight=0.01)
    r = moe.moe_route(p["router"], x[0], 2, moe.moe_capacity(0.25, 12, 2))
    assert int(r["keep"].sum()) == 2 * 1  # cap 1 for each of 2 experts
    dropped = ~r["keep"]
    assert bool((out[0][dropped] == 0).all())
    assert bool((out[0][r["keep"]] != 0).any())


# -- recurrent mixers ---------------------------------------------------------

D, B, S = 32, 2, 12


def _mixer(M, name):
    """(reference params, seq kwargs, the reference's seq and step, the
    port's seq and step) of one mixer at width D."""
    key = jax.random.PRNGKey(7)
    S_ref = M["ssm"]
    if name == "mlstm":
        p = S_ref.init_mlstm(key, D, 4, 2.0)
        kw = dict(n_heads=4)
    elif name == "slstm":
        p = S_ref.init_slstm(key, D)
        kw = {}
    else:
        p = S_ref.init_mamba2(key, D, d_state=16, expand=2, head_dim=16)
        kw = dict(head_dim=16)
    return (p, kw, getattr(S_ref, f"{name}_seq"), getattr(S_ref, f"{name}_step"),
            getattr(ssm, f"{name}_seq"), getattr(ssm, f"{name}_step"))


@pytest.mark.parametrize("name", ["mlstm", "slstm", "mamba2"])
def test_recurrent_seq_and_step_match_reference(M, name):
    """``*_seq`` from the zero state over S positions (outputs and final
    state), then three ``*_step`` calls from that state, each output and
    state against the reference's."""
    p, kw, ref_seq, ref_step, seq, step = _mixer(M, name)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    pt = _t(p)
    want_y, want_st = ref_seq(p, jnp.asarray(x), **kw)
    got_y, got_st = seq(pt, torch.tensor(x), **kw)
    _close(got_y, want_y, SSM_TOL)
    _close(got_st, want_st, SSM_TOL)
    for _ in range(3):
        xt = rng.normal(size=(B, 1, D)).astype(np.float32)
        want_y, want_st = ref_step(p, jnp.asarray(xt), want_st, **kw)
        got_y, got_st = step(pt, torch.tensor(xt), got_st, **kw)
        assert got_y.shape == (B, 1, D)
        _close(got_y, want_y, SSM_TOL)
        _close(got_st, want_st, SSM_TOL)


@pytest.mark.parametrize("name", ["mlstm", "slstm", "mamba2"])
def test_recurrent_seq_in_two_halves_equals_one_call(M, name):
    """The first half, then the second from the state it leaves, gives
    one whole call's outputs and final state (SPLIT_TOL); the reference's
    halves agree with the port's (SSM_TOL). The state handed in is not
    written."""
    p, kw, ref_seq, _, seq, _ = _mixer(M, name)
    x = np.random.default_rng(12).normal(size=(B, S, D)).astype(np.float32)
    pt, xt = _t(p), torch.tensor(x)
    whole_y, whole_st = seq(pt, xt, **kw)
    y1, st1 = seq(pt, xt[:, :S // 2], **kw)
    kept = {k: v.clone() for k, v in st1.items()}
    y2, st2 = seq(pt, xt[:, S // 2:], state=st1, **kw)
    for k in kept:
        assert torch.equal(st1[k], kept[k])
    _close(torch.cat([y1, y2], dim=1), whole_y.numpy(), SPLIT_TOL)
    _close(st2, {k: v.numpy() for k, v in whole_st.items()}, SPLIT_TOL)
    r1, rst1 = ref_seq(p, jnp.asarray(x[:, :S // 2]), **kw)
    r2, rst2 = ref_seq(p, jnp.asarray(x[:, S // 2:]), state=rst1, **kw)
    _close(y2, r2, SSM_TOL)
    _close(st2, rst2, SSM_TOL)


def test_recurrent_states_start_as_the_references(M):
    ref = M["ssm"]
    _close(ssm.mlstm_state(2, 32, 4, 2.0), ref.mlstm_state(2, 32, 4, 2.0),
           dict(rtol=0, atol=0))
    _close(ssm.slstm_state(2, 32), ref.slstm_state(2, 32), dict(rtol=0, atol=0))
    _close(ssm.mamba2_state(2, 32, 16, 2, 16), ref.mamba2_state(2, 32, 16, 2, 16),
           dict(rtol=0, atol=0))


# -- cross-attention ----------------------------------------------------------

def test_cross_attention_with_an_open_gate_matches_reference(M):
    d, h, kh, hd = 32, 8, 2, 8
    p = dict(M["attention"].init_cross_attention(jax.random.PRNGKey(5), d, h,
                                                 kh, hd))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, d)).astype(np.float32)
    enc = (rng.normal(size=(2, 9, d)) * 0.1).astype(np.float32)
    kw = dict(n_heads=h, n_kv_heads=kh, head_dim=hd)
    closed = attention.cross_attention(_t(p), torch.tensor(x),
                                       torch.tensor(enc), **kw)
    assert bool((closed == 0).all())  # tanh(0): the fresh layer adds zero
    p["gate"] = jnp.full((1,), 0.5, jnp.float32)
    want = M["attention"].cross_attention(p, jnp.asarray(x), jnp.asarray(enc),
                                          **kw)
    got = attention.cross_attention(_t(p), torch.tensor(x), torch.tensor(enc),
                                    **kw)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    _close(got, want, MOE_TOL)
