"""JAX-side helpers for the port's conformance tests, and their own tests.

Other ``tests/test_torch_*.py`` files import from here
(``from test_torch_reference import ...``; ``tests/`` has no
``__init__.py``, so it is on ``sys.path``).

* :func:`load_reference` imports the reference package ``repro``. On jax
  0.9 ``jax.interpreters.batching.primitive_batchers`` is a proxy without
  ``__contains__``, so the membership test in ``repro/core/tree_utils.py``
  raises ``TypeError`` at import. The helper gives the proxy class the
  missing ``__contains__`` (membership in the batcher table the proxy
  writes to) before importing. It is called from fixtures at test time,
  never at module import, so collecting the suite does not change which
  reference test files import.
* :func:`reference_bits` rebuilds the exact uint32 noise bits the
  reference's kernel path consumed in round ``t``, so the port can be fed
  the same bits through its ``bits_at`` seam.
* :func:`reference_tree_bits` rebuilds the bits ``repro.kernels.ops.
  laplace_noise_tree`` feeds its Laplace kernel, leaf by leaf.
* :func:`reference_gumbel` rebuilds the Gumbel noise the reference's
  ``run_decode`` adds to the logits at each decode step, so the port's
  ``run_decode`` can be fed the same draws through its ``noise_at`` seam.
* :func:`reference_fault_draws` / :func:`reference_delay_draws` rebuild the
  masks and delays ``repro.net.faults.FaultModel`` and ``repro.net.delays.
  DelayModel`` drew in round ``t`` (their salted key folds of
  ``fold_in(PRNGKey(seed), t)`` and the split into two keys), for the
  port's ``draws=`` / ``fault_draws_at`` / ``delay_draws_at`` seams.
* :func:`reference_wire_uniforms` rebuilds the stochastic-rounding
  uniforms of the reference's int8 codecs in round ``t`` (``uniform(
  fold_in(round key, WIRE_SALT), (N, d_s))``), for the port's
  ``wire_draws_at`` seam; :func:`reference_noise_draws` the unit draws a
  reference mechanism (or the plain Laplace row) takes from a round key,
  for ``noise_draws_at``.
"""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

__all__ = ["load_reference", "reference_bits", "reference_tree_bits",
           "reference_gumbel", "reference_fault_draws",
           "reference_delay_draws", "reference_round_key",
           "reference_wire_uniforms", "reference_noise_draws", "to_numpy"]

# the salts of repro/net/faults.py, repro/net/delays.py, repro/wire/codecs.py
_FAULT_SALT, _DELAY_SALT = 0x4E455446, 0x4E455444
_WIRE_SALT = 0x57495245


def _install_batchers_contains() -> None:
    from jax._src.interpreters import batching as batching_internal
    from jax.interpreters import batching

    proxy_cls = type(batching.primitive_batchers)
    if not hasattr(proxy_cls, "__contains__"):
        table = batching_internal.fancy_primitive_batchers
        proxy_cls.__contains__ = lambda self, prim: prim in table


def load_reference():
    """The reference package ``repro`` with the modules the tests use
    (``repro.api``, ``repro.kernels.ops``, ``repro.net.graphs``, ...)
    imported."""
    _install_batchers_contains()
    repro = importlib.import_module("repro")
    for name in ("repro.api", "repro.core.packing", "repro.core.pushsum",
                 "repro.data", "repro.engine.plan", "repro.kernels.ops",
                 "repro.kernels.ref", "repro.net.graphs",
                 "repro.kernels.flash_attention", "repro.models",
                 "repro.models.layers", "repro.configs"):
        importlib.import_module(name)
    return repro


def reference_bits(seed: int, t: int, n_nodes: int, d_s: int, *,
                   partpsp: bool = False) -> np.ndarray:
    """The (N, d_s) uint32 bits the reference kernel path drew in round t.

    ``run_dpps`` folds the round into the base key (``rounds.py``), and
    ``ops.dpps_perturb_packed`` splits that key over the nodes and draws
    ``jax.random.bits(node_key, (d_s,), uint32)`` for each, under ``vmap``.
    ``run_partpsp`` first splits the round key in three and hands the
    third to the DPPS round (``partpsp.py``).
    """
    key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
    if partpsp:
        key = jax.random.split(key, 3)[2]
    node_keys = jax.random.split(key, n_nodes)
    bits = jax.vmap(lambda k: jax.random.bits(k, (d_s,), jnp.uint32))(node_keys)
    return np.array(bits)  # a writable copy: torch.from_numpy shares it


def reference_tree_bits(key, tree) -> list[np.ndarray]:
    """The uint32 bits ``repro.kernels.ops.laplace_noise_tree(key, tree,
    scale)`` draws: ``split(key, n_leaves)``, then ``split(., N)`` per leaf,
    then ``bits(node_key, (leaf_size,))`` per node. One (N, *leaf shape)
    array per leaf, in tree-flatten order."""
    leaves = jax.tree_util.tree_leaves(tree)
    out = []
    for k, leaf in zip(jax.random.split(key, len(leaves)), leaves):
        n, size = leaf.shape[0], int(np.prod(leaf.shape[1:]))
        bits = jax.vmap(lambda kk: jax.random.bits(kk, (size,), jnp.uint32))(
            jax.random.split(k, n))
        out.append(np.array(bits).reshape(leaf.shape))
    return out


def reference_gumbel(key, steps: int, batch: int, vocab: int) -> np.ndarray:
    """The (steps, B, V) Gumbel noise ``repro.engine.run_decode`` adds at
    each step: it carries ``k``, takes ``k, sub = split(k)`` a step and
    samples ``categorical(sub, logits / T)``, which is
    ``argmax(gumbel(sub, (B, V)) + logits / T)``."""
    out, k = [], key
    for _ in range(steps):
        k, sub = jax.random.split(k)
        out.append(np.array(jax.random.gumbel(sub, (batch, vocab),
                                              jnp.float32)))
    return np.stack(out) if out else np.zeros((0, batch, vocab), np.float32)


def _salted_keys(seed: int, t: int, salt: int, model_seed: int):
    """``split(fold_in(fold_in(fold_in(PRNGKey(seed), t), salt),
    model_seed))``: the reference's two keys of a fault or delay round."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
    return jax.random.split(jax.random.fold_in(
        jax.random.fold_in(key, salt), model_seed))


def reference_fault_draws(fm, seed: int, t: int, shape: tuple[int, int]):
    """The keep masks the reference's ``FaultModel.realize`` (``shape`` (N,
    N)) or ``realize_sparse`` ((N, K)) drew in round t under the session
    seed ``seed``, as a :class:`repro_torch.net.FaultDraws`. ``fm`` is
    either package's FaultModel (its rates and seed are read)."""
    from repro_torch.net import FaultDraws

    k_drop, k_strag = _salted_keys(seed, t, _FAULT_SALT, fm.seed)
    drop = sends = None
    if fm.drop_rate > 0.0:
        drop = torch.from_numpy(np.array(jax.random.bernoulli(
            k_drop, 1.0 - fm.drop_rate, shape)))
    if fm.straggler_rate > 0.0:
        sends = torch.from_numpy(np.array(jax.random.bernoulli(
            k_strag, 1.0 - fm.straggler_rate, (shape[0],))))
    return FaultDraws(drop=drop, sends=sends)


def reference_delay_draws(dm, seed: int, t: int, shape: tuple[int, int]):
    """The timeouts (before masking with the sent messages) and delays the
    reference's ``DelayModel.open_round`` drew in round t, as a
    :class:`repro_torch.net.DelayDraws`."""
    from repro_torch.net import DelayDraws

    k_to, k_dly = _salted_keys(seed, t, _DELAY_SALT, dm.seed)
    timeout = delay = None
    if dm.timeout_rate > 0.0:
        timeout = torch.from_numpy(np.array(jax.random.bernoulli(
            k_to, dm.timeout_rate, shape)))
    if dm.max_delay > 0:
        delay = torch.from_numpy(np.array(jax.random.randint(
            k_dly, shape, 0, dm.max_delay + 1)).astype(np.int64))
    return DelayDraws(timeout=timeout, delay=delay)


def reference_round_key(seed: int, t: int, *, partpsp: bool = False):
    """The key the reference's ``dpps_step`` gets in round t of a session
    seeded ``seed``: ``fold_in(PRNGKey(seed), t)``, whose third split under
    ``run_partpsp``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
    return jax.random.split(key, 3)[2] if partpsp else key


def reference_wire_uniforms(seed: int, t: int, n_nodes: int, d_s: int, *,
                            partpsp: bool = False) -> np.ndarray:
    """The (N, d_s) f32 uniforms the reference's int8 codecs drew in round
    t: ``jax.random.uniform(fold_in(round key, WIRE_SALT), (N, d_s))``
    (``repro/core/dpps.py`` folds the salt, ``repro/wire/codecs.py`` draws)."""
    key = jax.random.fold_in(reference_round_key(seed, t, partpsp=partpsp),
                             _WIRE_SALT)
    return np.array(jax.random.uniform(key, (n_nodes, d_s), jnp.float32))


def reference_noise_draws(name: str, key, shapes) -> np.ndarray:
    """The (N, d_s) unit draws the reference's noise row ``name`` takes from
    the round key ``key`` over leaves of ``shapes`` ((N, ...) each):
    "laplace" / "broken_laplace" and the plain row of the compress-first
    codec are one flat ``jax.random.laplace(key, (N, d_s))``
    (``privacy.flat_wire_draw``); "gaussian" and "graph_homomorphic" draw
    each leaf from ``split(key, n_leaves)`` (``privacy.noise_tree``), with
    ``jax.random.normal`` / ``jax.random.laplace``, concatenated in wire
    order."""
    n = shapes[0][0]
    sizes = [int(np.prod(s[1:])) for s in shapes]
    if name in ("laplace", "broken_laplace"):
        return np.array(jax.random.laplace(key, (n, sum(sizes)), jnp.float32))
    sampler = {"gaussian": jax.random.normal,
               "graph_homomorphic": jax.random.laplace}[name]
    rows = [np.array(sampler(k, tuple(shape), jnp.float32)).reshape(n, -1)
            for k, shape in zip(jax.random.split(key, len(shapes)), shapes)]
    return np.concatenate(rows, axis=1)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- the helpers' own tests --------------------------------------------------

@pytest.fixture(scope="module")
def R():
    return load_reference()


def test_load_reference_imports_the_protocol_front_door(R):
    assert hasattr(R.api, "Session")
    assert hasattr(R.kernels.ops, "dpps_perturb_packed")
    # A second call is a no-op: the shim is installed once.
    assert load_reference() is R


@pytest.mark.parametrize("n_nodes,d_s", [(4, 3), (3, 200)])
def test_reference_bits_are_the_bits_the_kernel_path_consumes(R, n_nodes, d_s):
    """The fused Pallas round with the round key equals the plain oracle
    fed :func:`reference_bits`, bit for bit."""
    seed, t = 7, 3
    rng = np.random.default_rng(0)
    s = rng.normal(size=(n_nodes, d_s)).astype(np.float32)
    eps = rng.normal(size=(n_nodes, d_s)).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
    s_noise, eps_l1, noise_l1 = R.kernels.ops.dpps_perturb_packed(
        jnp.asarray(s), jnp.asarray(eps), key, 0.5, 0.25, d_s)
    bits = reference_bits(seed, t, n_nodes, d_s)
    assert bits.dtype == np.uint32 and bits.shape == (n_nodes, d_s)
    for i in range(n_nodes):
        want, _, want_l1 = R.kernels.ref.dpps_perturb(
            jnp.asarray(s[i]), jnp.asarray(eps[i]), jnp.asarray(bits[i]),
            0.5, 0.25)
        np.testing.assert_array_equal(np.asarray(s_noise[i]), np.asarray(want))
        np.testing.assert_allclose(float(noise_l1[i]), float(want_l1),
                                   rtol=1e-6)  # tile partials vs one sum


def test_reference_bits_partpsp_uses_the_third_split():
    a = reference_bits(0, 2, 3, 16)
    b = reference_bits(0, 2, 3, 16, partpsp=True)
    assert not np.array_equal(a, b)
    key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 2), 3)[2]
    first = jax.random.bits(jax.random.split(key, 3)[0], (16,), jnp.uint32)
    np.testing.assert_array_equal(b[0], np.asarray(first))


def test_reference_gumbel_is_the_noise_run_decode_samples_with(R):
    """The reference's run_decode with fixed logits picks argmax(logits / T
    + g) with g from :func:`reference_gumbel`, step by step."""
    b, v, steps, temp = 3, 11, 4, 0.7
    logits = jax.random.normal(jax.random.PRNGKey(3), (b, v))
    key = jax.random.PRNGKey(5)
    toks, _ = R.engine.rounds.run_decode(
        lambda c, tok, pos: (logits, c), jnp.zeros(()), jnp.zeros(b, jnp.int32),
        key, start_pos=0, steps=steps, temperature=temp)
    g = reference_gumbel(key, steps, b, v)
    want = np.argmax(np.asarray(logits)[None] / temp + g, axis=-1)
    np.testing.assert_array_equal(np.asarray(toks), want)
