"""The port's model zoo (all ten architectures) against the reference.

Same inputs, made with numpy from a seed, go through ``repro`` and
``repro_torch`` on the CPU; parameters come from the reference's own
``Transformer.init`` through ``convert.transformer_params_from_reference``.
The VLM's cross-attention gates are set to 0.5 in the parameters both
packages get (the reference starts them at zero, which would make every
cross layer add zeros), and it gets seeded image embeddings.

Tolerances: the layers to rtol 1e-6 / atol 1e-6 (the same f32 arithmetic,
one op at a time); flash attention to rtol 1e-5 / atol 1e-5 (softmax over
blocks in the Pallas kernel, over the whole row in the plain version);
prefill and decode logits and caches to rtol 1e-4 / atol 1e-4, the
reference's own tolerance for its flash and plain prefill paths
(``tests/test_models.py``), since matmuls through layers sum in other
orders in XLA and PyTorch. Caches are compared leaf by leaf: KV leaves
over the filled slots, recurrent states whole.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.tree_utils import tree_flatten_with_path
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.attention import open_cross_gates
from repro_torch.models.config import AttnGroup, MambaGroup
from repro_torch.models.transformer import Transformer
from test_torch_reference import load_reference, to_numpy

RTOL = ATOL = 1e-4


@pytest.fixture(scope="module")
def R():
    return load_reference()


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


# -- (i) layers --------------------------------------------------------------

def test_rms_norm_and_softcap_match_reference(R):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    scale = rng.normal(size=(48,)).astype(np.float32)
    want = R.models.layers.rms_norm({"scale": jnp.asarray(scale)},
                                    jnp.asarray(x), 1e-6)
    got = layers.rms_norm({"scale": _t(scale)}, _t(x), 1e-6)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    logits = rng.normal(size=(3, 40)).astype(np.float32) * 50
    for cap in (0.0, 30.0):
        np.testing.assert_allclose(
            to_numpy(layers.softcap(_t(logits), cap)),
            np.asarray(R.models.layers.softcap(jnp.asarray(logits), cap)),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_matches_reference(R, theta):
    """XLA's and PyTorch's f32 ``exp`` differ by up to an ulp on the
    inverse frequencies (measured: 6e-8 at theta = 5e5), and the angle is
    position x inv_freq, so at position p the rotation may differ by
    p ulp(1) = p 2^-23 radians: the tolerance is 1e-6 plus that times
    |x|, position by position. The frequencies themselves agree to an ulp."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 300, 3, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(300, dtype=np.int32), (2, 300))
    want = np.asarray(R.models.layers.rope(jnp.asarray(x), jnp.asarray(pos),
                                           theta))
    got = to_numpy(layers.rope(_t(x), _t(pos.copy()), theta))
    x_max = np.abs(x).max(axis=(2, 3), keepdims=True)
    tol = 1e-6 + 1e-6 * np.abs(want) + pos[..., None, None] * 2.0 ** -23 * x_max
    assert np.all(np.abs(got - want) <= tol)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6, atol=1e-6)
    unit = np.zeros((1, 2, 1, 64), np.float32)
    unit[..., :32] = 1.0  # position 1: the first half is cos(inv_freq)
    one = np.array([[0, 1]], np.int32)
    np.testing.assert_allclose(
        to_numpy(layers.rope(_t(unit), _t(one), theta))[0, 1, 0, :32],
        np.asarray(R.models.layers.rope(jnp.asarray(unit), jnp.asarray(one),
                                        theta))[0, 1, 0, :32],
        rtol=0, atol=2.0 ** -23)


@pytest.mark.parametrize("activation", ["silu", "geglu", "gelu"])
def test_mlp_apply_matches_reference(R, activation):
    p = R.models.layers.mlp_init(jax.random.PRNGKey(2), 32, 64, activation)
    x = np.random.default_rng(2).normal(size=(2, 7, 32)).astype(np.float32)
    want = R.models.layers.mlp_apply(p, jnp.asarray(x), activation)
    got = layers.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), activation)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_dense_init_is_a_truncated_normal_over_sqrt_fan_in():
    w = layers.dense_init(torch.Generator().manual_seed(0), (400, 300))
    assert w.shape == (400, 300) and w.dtype == torch.float32
    z = w * 20.0  # fan_in 400
    assert float(z.abs().max()) <= 2.0
    assert abs(float(z.std()) - 0.88) < 0.02  # std of N(0,1) cut at +-2


# -- (ii) flash attention ----------------------------------------------------

def _qkv(b, s, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for shape in
                 ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))


@pytest.mark.parametrize("s", [128, 200, 256])
@pytest.mark.parametrize("window", [None, 8, 100])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("group", [1, 4])
def test_flash_attention_matches_reference(R, group, d, window, s):
    """The (H, S, D) wrapper against the Pallas kernel in interpret mode
    (which takes S a multiple of 128 only), and the model-layout wrapper
    against the reference's, which pads S to 128."""
    kh = 2
    q, k, v = _qkv(2, s, kh * group, kh, d, seed=s + d + group)
    want = R.kernels.ops.flash_attention_bshd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        interpret=True)
    got = ops.flash_attention_bshd(_t(q), _t(k), _t(v), window=window)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if s % 128 == 0:
        hsd = [np.ascontiguousarray(x[0].transpose(1, 0, 2)) for x in (q, k, v)]
        want = R.kernels.flash_attention.flash_attention(
            *map(jnp.asarray, hsd), group=group, window=window, interpret=True)
        got = ops.flash_attention(*map(_t, hsd), group=group, window=window)
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_flash_attention_rows_in_windows_equal_the_whole():
    """``ref.flash_attention(q_start=r0)`` over row windows against keys
    [0, r1) gives the rows of the whole call (how chip_smoke.py checks the
    kernel at 32k)."""
    from repro_torch.kernels import ref

    q, k, v = (_t(x).transpose(1, 2) for x in _qkv(1, 150, 4, 2, 16, 9))
    for window in (None, 20):
        whole = ref.flash_attention(q, k, v, group=2, window=window)
        for r0, r1 in ((0, 40), (40, 97), (97, 150)):
            part = ref.flash_attention(q[:, :, r0:r1], k[:, :, :r1],
                                       v[:, :, :r1], group=2, window=window,
                                       q_start=r0)
            torch.testing.assert_close(part, whole[:, :, r0:r1], rtol=1e-6,
                                       atol=1e-6)


def test_flash_attention_rejects_a_zero_window():
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_bshd(q, q, q, window=0)


# -- (iii) prefill of the SMOKE configs --------------------------------------

def _models(R, cfg):
    ref_model = R.models.Transformer(cfg_to_reference(R, cfg))
    params = open_cross_gates(jax.tree_util.tree_map(
        np.asarray, ref_model.init(jax.random.PRNGKey(0))))
    port = convert.transformer_params_from_reference(params, cfg,
                                                     device="cpu")
    return ref_model, Transformer(cfg), params, port


def cfg_to_reference(R, cfg):
    """The reference's ModelConfig with the port's fields (the dataclasses
    are field-for-field copies, group kinds included)."""
    def group(g):
        return getattr(R.models, type(g).__name__)(**{
            f.name: getattr(g, f.name) for f in dataclasses.fields(g) if f.init})

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["groups"] = tuple(group(g) for g in cfg.groups)
    return R.models.ModelConfig(**fields)


def image_embeds(cfg, b, seed):
    """Seeded (B, n_image_tokens, d_model) image embeddings for a VLM, else
    None."""
    g = cfg.groups[0]
    if g.kind != "cross_self":
        return None
    rng = np.random.default_rng(seed + 1000)
    return (rng.normal(size=(b, g.n_image_tokens, cfg.d_model))
            * 0.1).astype(np.float32)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        emb = (rng.normal(size=(b, s, cfg.d_model)) * 0.1).astype(np.float32)
        return {"embeds": emb}
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s),
                                   dtype=np.int32)}


def _to_port(batch):
    return {k: torch.tensor(v) if v.dtype != np.int32 else
            torch.tensor(v.astype(np.int64)) for k, v in batch.items()}


def cache_leaves(tree) -> dict:
    """{"group_0/attn/k": array, ...} of a cache tree (dicts of arrays)."""
    return dict(tree_flatten_with_path(tree)[0])


def _assert_cache_close(got, want, s, rtol=RTOL, atol=ATOL):
    """Every leaf: KV caches (..., B, T, K, D) over their first ``s`` slots,
    recurrent states whole."""
    got, want = cache_leaves(got), cache_leaves(want)
    assert set(got) == set(want)
    for path, w in want.items():
        w, g = np.asarray(w), to_numpy(got[path])
        if path.rsplit("/", 1)[-1] in ("k", "v"):
            w, g = w[..., :s, :, :], g[..., :s, :, :]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=path)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_matches_reference(R, arch, flash):
    cfg = dataclasses.replace(get_config(arch).smoke, flash_prefill=flash)
    ref_model, model, params, port = _models(R, cfg)
    batch = _batch(cfg, 2, 20, seed=3)
    enc = image_embeds(cfg, 2, seed=3)
    if enc is not None:
        batch["image_embeds"] = enc
    want_logits, want_cache = ref_model.prefill(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, batch))
    ops.reset_launch_counts()
    logits, cache = model.prefill(port, _to_port(batch))
    assert ops.launch_counts()["flash_attention"] == 0  # plain on the CPU
    assert logits.shape == (2, cfg.vocab_size) and logits.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(logits), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)
    assert {p: tuple(x.shape) for p, x in cache_leaves(cache).items()} == {
        p: tuple(x.shape) for p, x in cache_leaves(want_cache).items()}
    _assert_cache_close(cache, want_cache, 20)


def test_prefill_writes_a_larger_cache_and_a_ring_buffer():
    """``capacity`` past the prompt leaves the tail zero; a uniform-window
    group keeps the last ``window`` positions at their slots ``p % window``."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").smoke,
                              groups=(AttnGroup(n_layers=1, windows=(8,)),))
    model = Transformer(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = {"tokens": torch.randint(0, cfg.vocab_size, (1, 13))}
    _, full = model.prefill(params, toks, capacity=20)  # ring: 8 slots
    wide = Transformer(dataclasses.replace(cfg, groups=(AttnGroup(n_layers=1),)))
    _, flat = wide.prefill(params, toks, capacity=20)
    k_ring, k_flat = full["group_0"]["k"][0], flat["group_0"]["k"][0]
    assert k_ring.shape[1] == 8 and k_flat.shape[1] == 20
    assert bool((k_flat[:, 13:] == 0).all())
    for p in range(5, 13):
        torch.testing.assert_close(k_ring[:, p % 8], k_flat[:, p], rtol=0,
                                   atol=0)


# -- (iv) decode -------------------------------------------------------------

DECODE_CFGS = list(ARCH_NAMES) + ["ring", "mamba"]


def _decode_cfg(name):
    if name == "ring":  # every layer one window: the ring-buffer cache
        return dataclasses.replace(get_config("llama3.2-1b").smoke,
                                   groups=(AttnGroup(n_layers=2, windows=(8,)),))
    if name == "mamba":  # a plain Mamba2 group (zamba2 runs it in units)
        return dataclasses.replace(get_config("llama3.2-1b").smoke,
                                   groups=(MambaGroup(n_layers=2, d_state=16),))
    return get_config(name).smoke


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("name", DECODE_CFGS)
def test_decode_step_matches_reference(R, name, carry):
    """Prefill 5 tokens, then 6 teacher-forced decode steps (positions 5-10,
    past the ring's 8 slots); logits at every step and the final caches
    (KV slots and recurrent states)."""
    cfg = dataclasses.replace(_decode_cfg(name), decode_cache_in_carry=carry)
    ref_model, model, params, port = _models(R, cfg)
    b, s, steps = 2, 5, 6
    batch = _batch(cfg, b, s + steps, seed=4)
    first = {k: v[:, :s] for k, v in batch.items()}
    enc = image_embeds(cfg, b, seed=4)
    if enc is not None:
        first["image_embeds"] = enc
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    _, pre = ref_model.prefill(jp, jax.tree_util.tree_map(jnp.asarray, first))
    ref_cache = jax.tree_util.tree_map(
        lambda dst, src: dst.at[tuple(slice(0, n) for n in src.shape)].set(src),
        ref_model.init_cache(b, s + steps), pre)
    _, cache = model.prefill(port, _to_port(first), capacity=s + steps)
    key = "embeds" if cfg.input_mode == "embeddings" else "tokens"
    for t in range(steps):
        step_in = batch[key][:, s + t]
        want, ref_cache = ref_model.decode_step(
            jp, ref_cache, jnp.asarray(step_in), jnp.asarray(s + t, jnp.int32),
            None if enc is None else jnp.asarray(enc))
        got, cache = model.decode_step(
            port, cache, _to_port({key: step_in})[key], s + t,
            enc=None if enc is None else torch.tensor(enc))
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    _assert_cache_close(cache, ref_cache, s + steps)


def test_decode_against_a_long_cache_matches_reference(R):
    """A cache of 1,103 slots: decode splits its P V contraction into
    512-slot chunks plus a tail (``transformer._probs_v``)."""
    cfg = get_config("llama3.2-1b").smoke
    ref_model, model, params, port = _models(R, cfg)
    b, s, steps = 1, 1100, 3
    batch = _batch(cfg, b, s + steps, seed=5)
    first = {"tokens": batch["tokens"][:, :s]}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    _, pre = ref_model.prefill(jp, jax.tree_util.tree_map(jnp.asarray, first))
    ref_cache = jax.tree_util.tree_map(
        lambda dst, src: dst.at[:, :, :s].set(src),
        ref_model.init_cache(b, s + steps), pre)
    _, cache = model.prefill(port, _to_port(first), capacity=s + steps)
    for t in range(steps):
        tok = batch["tokens"][:, s + t]
        want, ref_cache = ref_model.decode_step(
            jp, ref_cache, jnp.asarray(tok), jnp.asarray(s + t, jnp.int32))
        got, cache = model.decode_step(port, cache,
                                       torch.tensor(tok.astype(np.int64)), s + t)
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


# -- configs and conversion --------------------------------------------------

def test_configs_are_the_references(R):
    """All ten configs, full and smoke, and their PartPSP rules, equal the
    reference's."""
    for name in ARCH_NAMES:
        spec, ref_spec = get_config(name), R.configs.get_config(name)
        for mine, theirs in ((spec.model, ref_spec.model),
                             (spec.smoke, ref_spec.smoke)):
            assert mine == dataclasses.replace(
                mine) and cfg_to_reference(R, mine) == theirs
        assert tuple(spec.shared_rules) == tuple(ref_spec.shared_rules)
        assert (spec.name, spec.family) == (ref_spec.name, ref_spec.family)
    assert ARCH_NAMES == tuple(R.configs.ARCH_NAMES)


def test_transformer_params_from_reference_checks_every_path(R):
    cfg = get_config("minitron-4b").smoke  # untied: has lm_head
    params = jax.tree_util.tree_map(
        np.asarray, R.models.Transformer(cfg_to_reference(R, cfg)).init(
            jax.random.PRNGKey(0)))
    port = convert.transformer_params_from_reference(params, cfg, device="cpu")
    assert port["group_0"]["attn"]["wq"].shape == (2, 192, 192)
    assert "lm_head" in port
    bad = dict(params, head=params.pop("lm_head"))
    with pytest.raises(ValueError, match="lm_head"):
        convert.transformer_params_from_reference(bad, cfg, device="cpu")
    params["lm_head"] = bad["head"]
    params["embed"] = params["embed"][:-1]
    with pytest.raises(ValueError, match="wrong shape"):
        convert.transformer_params_from_reference(params, cfg, device="cpu")
