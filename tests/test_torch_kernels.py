"""The port's kernel modules against the reference's.

Each plain version in ``repro_torch.kernels.ref`` is held against the
reference oracle in ``repro.kernels.ref`` and against the Pallas kernel
itself, run in interpret mode through ``repro.kernels.ops``, on the same
numpy inputs. The CUDA kernels run only on the card; they are held
against their plain versions in ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``.

Tolerances: elementwise results agree to rtol 1e-6 (the log of the Laplace
transform may differ by an ulp between XLA and PyTorch); sums over up to
8192 f32 terms to rtol 1e-5, since the Pallas kernels add per-tile
partials and the plain versions add in one reduction, in another order.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import load_reference, reference_bits, to_numpy

from repro_torch.kernels import ops, ref

SHAPES = [(n, d_s) for n in (4, 10) for d_s in (7840, 8192, 3)]


@pytest.fixture(scope="module")
def R():
    return load_reference()


def _d_pad(d_s: int) -> int:
    return -(-d_s // 128) * 128


def _rows(rng, n, d_s, *, pad_value=0.0):
    """(n, d_pad) f32 rows with ``pad_value`` in the pad lanes."""
    x = np.full((n, _d_pad(d_s)), pad_value, np.float32)
    x[:, :d_s] = rng.normal(size=(n, d_s)).astype(np.float32)
    return x


# -- Philox and the Laplace transform ----------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Philox4x32-10's published known-answer vectors (Random123)."""
    words = ref.philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
    assert tuple(int(w) for w in words) == want


def test_philox_bits_are_a_function_of_seed_round_node_element():
    full = ref.philox_bits(11, 5, 3, 0, 37)
    assert full.shape == (3, 37)
    # Any column window is the same slice of the row (the counter is the
    # element index), so a kernel block may start anywhere.
    np.testing.assert_array_equal(ref.philox_bits(11, 5, 3, 6, 29),
                                  full[:, 6:29])
    assert not torch.equal(full, ref.philox_bits(11, 6, 3, 0, 37))
    assert not torch.equal(full, ref.philox_bits(12, 5, 3, 0, 37))
    assert not torch.equal(full[0], full[1])
    assert int(full.min()) >= 0 and int(full.max()) < 2 ** 32


def test_laplace_from_bits_matches_reference(R):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, size=(4, 1000), dtype=np.uint32)
    bits[0, :4] = [1 << 31, 0, 0xFFFFFFFF, (1 << 31) + 256]
    scale = 0.37
    got = ref.laplace_from_bits(torch.from_numpy(bits), scale)
    want = np.asarray(R.kernels.ref.laplace_from_bits(jnp.asarray(bits), scale))
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-6, atol=0)
    assert got[0, 0].item() == 0.0  # padding bits give exactly zero noise
    # a 0-d scale tensor (the kernel path's device scalar) works the same
    got_t = ref.laplace_from_bits(torch.from_numpy(bits), torch.tensor(scale))
    torch.testing.assert_close(got_t, got, rtol=0, atol=0)


# -- l1_norm -----------------------------------------------------------------

@pytest.mark.parametrize("n,d_s", SHAPES)
def test_l1_norm_rows_matches_reference(R, n, d_s):
    rng = np.random.default_rng(d_s + n)
    buf = _rows(rng, n, d_s, pad_value=5.0)  # pad lanes must be ignored
    got = to_numpy(ops.l1_norm_rows(torch.from_numpy(buf), d_s))
    oracle = np.array([float(R.kernels.ref.l1_norm(jnp.asarray(buf[i, :d_s])))
                       for i in range(n)])
    pallas = np.asarray(R.kernels.ops.l1_norm_packed(jnp.asarray(buf), d_s))
    assert got.shape == (n,)
    np.testing.assert_allclose(got, oracle, rtol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5)


# -- dpps_perturb ------------------------------------------------------------

@pytest.mark.parametrize("n,d_s", SHAPES)
def test_dpps_perturb_rows_matches_reference(R, n, d_s):
    seed, t, scale, gamma_n = 3, 2, 0.8, 0.05
    rng = np.random.default_rng(d_s * n)
    s, eps = _rows(rng, n, d_s), _rows(rng, n, d_s)
    bits = reference_bits(seed, t, n, d_s)
    got_s, got_e, got_n = ops.dpps_perturb_rows(
        torch.from_numpy(s), torch.from_numpy(eps), torch.tensor(scale),
        gamma_n, d_s, bits=torch.from_numpy(bits))
    got_s = to_numpy(got_s)
    assert got_s.shape == s.shape
    np.testing.assert_array_equal(got_s[:, d_s:], 0.0)  # pad lanes zero
    # the interpret-mode Pallas round, keyed as the reference keys it
    key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
    p_s, p_e, p_n = R.kernels.ops.dpps_perturb_packed(
        jnp.asarray(s), jnp.asarray(eps), key, scale, gamma_n, d_s)
    np.testing.assert_allclose(got_s, np.asarray(p_s), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_numpy(got_e), np.asarray(p_e), rtol=1e-5)
    np.testing.assert_allclose(to_numpy(got_n), np.asarray(p_n), rtol=1e-5)
    # the plain oracle, node by node
    for i in range(n):
        o_s, o_e, o_n = R.kernels.ref.dpps_perturb(
            jnp.asarray(s[i, :d_s]), jnp.asarray(eps[i, :d_s]),
            jnp.asarray(bits[i]), scale, gamma_n)
        np.testing.assert_allclose(got_s[i, :d_s], np.asarray(o_s),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(got_e[i]), float(o_e), rtol=1e-5)
        np.testing.assert_allclose(float(got_n[i]), float(o_n), rtol=1e-5)


def test_dpps_perturb_rows_padding_bits_give_no_noise():
    rng = np.random.default_rng(1)
    n, d_s = 3, 300
    s, eps = _rows(rng, n, d_s), _rows(rng, n, d_s)
    bits = np.full((n, d_s), 1 << 31, np.uint32)
    out, eps_l1, noise_l1 = ops.dpps_perturb_rows(
        torch.from_numpy(s), torch.from_numpy(eps), 4.0, 1.0, d_s,
        bits=torch.from_numpy(bits))
    np.testing.assert_array_equal(to_numpy(out)[:, :d_s],
                                  s[:, :d_s] + eps[:, :d_s])
    np.testing.assert_array_equal(to_numpy(noise_l1), 0.0)
    np.testing.assert_allclose(to_numpy(eps_l1), np.abs(eps).sum(1), rtol=1e-5)


def test_dpps_perturb_rows_philox_variant_is_the_seeded_stream():
    rng = np.random.default_rng(2)
    n, d_s = 4, 130
    s, eps = torch.from_numpy(_rows(rng, n, d_s)), torch.from_numpy(
        _rows(rng, n, d_s))
    a = ops.dpps_perturb_rows(s, eps, 1.0, 0.5, d_s, seed=9, t=4)
    b = ops.dpps_perturb_rows(s, eps, 1.0, 0.5, d_s,
                              bits=ref.philox_bits(9, 4, n, 0, d_s).to(
                                  torch.uint32))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError):
        ops.dpps_perturb_rows(s, eps, 1.0, 0.5, d_s)  # no bits, no seed


# -- pushsum_mix -------------------------------------------------------------

@pytest.mark.parametrize("n,d", SHAPES)
def test_pushsum_mix_matches_reference(R, n, d):
    rng = np.random.default_rng(n + d)
    w = rng.dirichlet(np.ones(n), size=n).T.astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    got = to_numpy(ops.pushsum_mix(torch.from_numpy(w), torch.from_numpy(x)))
    np.testing.assert_allclose(
        got, np.asarray(R.kernels.ref.pushsum_mix(jnp.asarray(w),
                                                  jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(R.kernels.ops.pushsum_mix(jnp.asarray(w),
                                                  jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)


# -- the wrappers' routing ---------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    buf = torch.ones((2, 128))
    ops.l1_norm_rows(buf, 100)
    ops.dpps_perturb_rows(buf, buf, 1.0, 1.0, 100, seed=0, t=0)
    ops.pushsum_mix(torch.eye(2), buf)
    ops.spmm(torch.tensor([[0, 1], [0, 1]], dtype=torch.int32),
             torch.full((2, 2), 0.5), buf)
    ops.clip_scale_rows(buf, 100, torch.ones(2))
    ops.laplace_from_bits(torch.zeros(8, dtype=torch.uint32), 1.0)
    ops.l1_clip_tree({"x": buf}, 1.0)
    ops.laplace_noise_tree({"x": torch.zeros((2, 3), dtype=torch.uint32)},
                           1.0)
    q = torch.ones((1, 5, 2, 16))
    ops.flash_attention_bshd(q, q, q)
    ops.flash_attention(q[0].transpose(0, 1).contiguous(),
                        q[0].transpose(0, 1).contiguous(),
                        q[0].transpose(0, 1).contiguous(), window=3)
    assert ops.launch_counts() == {
        "l1_norm_rows": 0, "dpps_perturb_rows": 0, "pushsum_mix": 0,
        "spmm": 0, "clip_scale_rows": 0, "laplace_from_bits": 0,
        "flash_attention": 0}
