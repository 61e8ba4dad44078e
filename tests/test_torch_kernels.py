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

import math

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
    """The plain transform against the reference's, and each of them
    against the float64 transform of the same f32 magnitudes (so a
    mismatch names the side that moved), all to rtol 1e-6."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, size=(4, 1000), dtype=np.uint32)
    bits[0, :4] = [1 << 31, 0, 0xFFFFFFFF, (1 << 31) + 256]
    scale = 0.37
    got = ref.laplace_from_bits(torch.from_numpy(bits), scale)
    want = np.asarray(R.kernels.ref.laplace_from_bits(jnp.asarray(bits), scale))
    c = (bits >> 8).astype(np.float32) * np.float32(2.0 ** -24) - np.float32(
        0.5)
    mag = np.maximum(np.float32(1.0) - np.float32(2.0) * np.abs(c),
                     np.float32(1e-30))
    truth = (-np.float64(np.float32(scale)) * np.sign(c).astype(np.float64)
             * np.log(mag.astype(np.float64)))
    np.testing.assert_allclose(to_numpy(got), truth, rtol=1e-6, atol=0,
                               err_msg="the port's transform moved")
    np.testing.assert_allclose(want, truth, rtol=1e-6, atol=0,
                               err_msg="the reference's transform moved")
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


# -- row blocks: a rank's launches in the sharded engine ----------------------

ROW_BLOCKS = [(1, 0), (1, 7), (3, 2), (7, 1)]  # (B, first row) of N = 8


@pytest.mark.parametrize("b,r0", ROW_BLOCKS)
def test_row_block_mixes_match_the_reference_rows(R, b, r0):
    """A (B, N) block of W, and a (B, K) block of the padded CSR, against
    the rows of the reference's whole mix (its oracle and its
    interpret-mode Pallas kernel)."""
    from repro_torch.core.topology import DOutGraph, padded_csr

    n, d = 8, 260
    rows = slice(r0, r0 + b)
    rng = np.random.default_rng(b * 10 + r0)
    w = rng.dirichlet(np.ones(n), size=n).T.astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    got = to_numpy(ops.pushsum_mix(torch.from_numpy(w[rows]).contiguous(),
                                   torch.from_numpy(x)))
    assert got.shape == (b, d)
    for want in (R.kernels.ref.pushsum_mix(jnp.asarray(w), jnp.asarray(x)),
                 R.kernels.ops.pushsum_mix(jnp.asarray(w), jnp.asarray(x))):
        np.testing.assert_allclose(got, np.asarray(want)[rows], rtol=1e-5,
                                   atol=1e-6)
    idx, vals = padded_csr(DOutGraph(n, 3).weight_matrix(0))
    vals = vals.astype(np.float32)
    got = to_numpy(ops.spmm(torch.from_numpy(idx[rows]).contiguous(),
                            torch.from_numpy(vals[rows]).contiguous(),
                            torch.from_numpy(x)))
    want = np.asarray(R.kernels.ref.spmm(jnp.asarray(idx), jnp.asarray(vals),
                                         jnp.asarray(x)))[rows]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,r0", ROW_BLOCKS)
def test_row_block_perturbation_matches_the_reference_rows(R, b, r0):
    """The block's rows fed their own reference bits against the
    reference oracle's rows; its Philox draw keyed at ``node0 = r0`` equal
    bit for bit to the same rows of the whole draw."""
    n, d_s, seed, t, scale, gamma_n = 8, 300, 3, 2, 0.8, 0.05
    rows = slice(r0, r0 + b)
    rng = np.random.default_rng(b * 10 + r0)
    s, eps = _rows(rng, n, d_s), _rows(rng, n, d_s)
    bits = reference_bits(seed, t, n, d_s)
    got_s, got_e, got_n = ops.dpps_perturb_rows(
        torch.from_numpy(s[rows]), torch.from_numpy(eps[rows]),
        torch.tensor(scale), gamma_n, d_s,
        bits=torch.from_numpy(bits[rows]), node0=r0)
    for i, node in enumerate(range(r0, r0 + b)):
        o_s, o_e, o_n = R.kernels.ref.dpps_perturb(
            jnp.asarray(s[node, :d_s]), jnp.asarray(eps[node, :d_s]),
            jnp.asarray(bits[node]), scale, gamma_n)
        np.testing.assert_allclose(to_numpy(got_s)[i, :d_s], np.asarray(o_s),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(got_e[i]), float(o_e), rtol=1e-5)
        np.testing.assert_allclose(float(got_n[i]), float(o_n), rtol=1e-5)
    full = ops.dpps_perturb_rows(torch.from_numpy(s), torch.from_numpy(eps),
                                 scale, gamma_n, d_s, seed=seed, t=t)
    block = ops.dpps_perturb_rows(torch.from_numpy(s[rows]),
                                  torch.from_numpy(eps[rows]), scale, gamma_n,
                                  d_s, seed=seed, t=t, node0=r0)
    for whole, part in zip(full, block):
        assert torch.equal(whole[rows], part)
    assert torch.equal(ref.philox_bits(seed, t, b, 5, d_s, node0=r0),
                       ref.philox_bits(seed, t, n, 5, d_s)[rows])


# -- the wrappers' routing ---------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    buf = torch.ones((2, 128))
    ops.l1_norm_rows(buf, 100)
    ops.dpps_perturb_rows(buf, buf, 1.0, 1.0, 100, seed=0, t=0)
    torch.testing.assert_close(ops.noise_l1_rows(buf, 100),
                               torch.full((2,), 100.0), rtol=0, atol=0)
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
        "l1_norm_rows": 0, "dpps_perturb_rows": 0, "noise_l1_rows": 0,
        "pushsum_mix": 0, "spmm": 0, "clip_scale_rows": 0,
        "laplace_from_bits": 0, "flash_attention": 0}


# -- the CUDA kernels' launch geometry (stated in ops.py, checked here) -----

def _chip_smoke():
    """``chip_smoke.py``'s module (its shapes; it imports no torch at load)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("layout", ["bshd", "hsd"])
@pytest.mark.parametrize("d", ops.FLASH_HEAD_DIMS)
def test_flash_geometry_covers_every_head_dim_and_layout(d, layout):
    """Each head dim has a tile whose warps, shared memory and grid the card
    takes, the grid covers every query row once, and the strides handed to
    the kernel address each element of the contiguous tensor of that layout."""
    for s in (1, 63, 64, 65, 1000, 32_768):
        b = 1 if layout == "hsd" else 2
        geo = ops.flash_geometry(b, s, 8, d)
        bq, bk, dsplit = ops.FLASH_TILES[d]
        assert (geo["bq"], geo["bk"], geo["dsplit"]) == (bq, bk, dsplit)
        assert bq % 16 == 0 and bk % 8 == 0 and (d // dsplit) % 8 == 0
        assert geo["threads"] == 32 * (bq // 16) * dsplit <= 1024
        assert geo["smem_bytes"] <= 232_448  # 227 KB, the opt-in limit
        nq, h, gb = geo["grid"]
        assert (nq - 1) * bq < s <= nq * bq and (h, gb) == (8, b)
    b, s, h = (1, 5, 3) if layout == "hsd" else (2, 5, 3)
    shape = (h, s, d) if layout == "hsd" else (b, s, h, d)
    flat = torch.arange(math.prod(shape)).reshape(shape)
    sb, ss, sh = ops.flash_strides(layout, s, h, d)
    for bi in range(b):
        for p in range(s):
            for hi in range(h):
                row = flat[hi, p] if layout == "hsd" else flat[bi, p, hi]
                assert int(row[0]) == bi * sb + p * ss + hi * sh
                assert torch.equal(row, row[0] + torch.arange(d))


def test_flash_tiles_serve_every_ported_architecture():
    """The head dims of every config with attention (all but xlstm-125m's,
    zamba2-7b's 112 among them), and the tiles the serving shapes of
    chip_smoke.py launch: 4 row groups of 16 a block, D = 112, 128 and 256
    split over two warps a row group (one warp's accumulator and Q
    fragments would spill, or take 254 registers at D = 112)."""
    from repro_torch.configs import ARCH_NAMES, get_config

    for arch in ARCH_NAMES:
        cfg = get_config(arch).model
        if {g.kind for g in cfg.groups} != {"xlstm"}:
            assert cfg.head_dim in ops.FLASH_HEAD_DIMS, arch
    assert get_config("zamba2-7b").model.head_dim == 112
    smoke = _chip_smoke()
    want = {64: (64, 32, 1, 128, 34_816), 112: (64, 32, 2, 256, 75_776),
            128: (64, 64, 2, 256, 167_936), 256: (64, 16, 2, 256, 74_752)}
    for b, s, h, _, d, _ in smoke.FLASH_SHAPES.values():
        geo = ops.flash_geometry(b, s, h, d)
        assert (geo["bq"], geo["bk"], geo["dsplit"], geo["threads"],
                geo["smem_bytes"]) == want[d]
        assert geo["grid"] == (-(-s // 64), h, b)


def test_spmm_plan_at_the_shapes_of_the_sparse_paths():
    """The regime and tile at each shape chip_smoke.py runs, on an H100
    (132 SMs): column tiles at the sparse full width and the sparse
    training shape (K = 14 and 21 on their ER graphs), rows at the widest
    sweep point (N = 4096: no 4-column tile of all rows fits a slot)."""
    from repro_torch.net import ErdosRenyiGraph

    smoke = _chip_smoke()
    sms = 132
    n, d = smoke.SPARSE_FULL["n"], smoke.d_pad_of(smoke.SPARSE_FULL["d_s"])
    k = ErdosRenyiGraph(n, p=8.0 / n, seed=0).max_in_degree(0)
    assert k == 14
    # ring 3 x 24 x 128 x 4 bytes, slot table 24 rows of 16 slots x 8 bytes;
    # 5 blocks an SM fit in 228 KB
    assert ops.spmm_plan(n, k, d, sms) == dict(
        regime="tiles", tile=128, stages=3, threads=256, blocks=5 * sms,
        smem_bytes=36_864 + 3_072)
    n, d = smoke.SPARSE_TRAIN["n"], smoke.d_pad_of(smoke.SPARSE_TRAIN["d_s"])
    k = ErdosRenyiGraph(n, p=8.0 / n, seed=0).max_in_degree(0)
    assert k == 21
    assert ops.spmm_plan(n, k, d, sms) == dict(
        regime="tiles", tile=32, stages=3, threads=256, blocks=7936 // 32,
        smem_bytes=49_152 + 24_576)
    assert ops.spmm_plan(smoke.SPARSE_SWEEP["n"], 24, smoke.SPARSE_SWEEP["d"],
                         sms) == dict(regime="rows", tile=0, stages=0,
                                      threads=32, blocks=4096 * 2 // 32,
                                      smem_bytes=0)


@pytest.mark.parametrize("n,k", [(1, 1), (24, 14), (128, 21), (1024, 4),
                                 (1024, 20), (4096, 24)])
@pytest.mark.parametrize("d", [8, 7936, 16_900, 95_669_120])
def test_spmm_plan_is_a_launch_the_kernel_takes(n, k, d):
    """Either regime covers every (row, 4 columns) once: column tiles only
    where a ring slot and the slot table fit and every SM gets a tile, with
    no more blocks than tiles or than the SMs' shared memory holds; rows
    with one thread an output quad."""
    sms = 132
    plan = ops.spmm_plan(n, k, d, sms)
    table = 8 * n * (-(-k // 4) * 4)
    if plan["regime"] == "tiles":
        tile = plan["tile"]
        assert 4 <= tile <= 512 and tile & (tile - 1) == 0
        assert n * tile * 4 <= ops.SPMM_STAGE_BYTES
        assert tile == 512 or n * tile * 8 > ops.SPMM_STAGE_BYTES
        assert table <= ops.SPMM_TABLE_BYTES
        assert plan["smem_bytes"] == plan["stages"] * n * tile * 4 + table
        n_tiles = -(-d // tile)
        per_sm = -(-plan["blocks"] // sms)
        assert n_tiles >= sms and plan["blocks"] <= n_tiles
        assert per_sm * (plan["smem_bytes"] + 1024) <= 233_472
    else:
        assert plan["tile"] == 0 and plan["threads"] in (32, 64, 128, 256)
        items = n * d // 4
        assert (plan["blocks"] - 1) * plan["threads"] < items
        assert plan["blocks"] * plan["threads"] >= items
        assert (n > 1024 or table > ops.SPMM_TABLE_BYTES
                or -(-d // 512) < sms)


# -- l1_norm.cu launch plan and scratch -----------------------------------------

@pytest.mark.parametrize("quads_per_block", [None, 1024, 4096])
@pytest.mark.parametrize("d_s", [3, 7840, 8192, 300_001, 95_669_064])
def test_l1_plan_reads_every_quad_once_and_the_tail_in_the_last_block(
        monkeypatch, d_s, quads_per_block):
    """Block b of a row reads quads [b q, min((b + 1) q, d_s // 4)): together
    every whole quad once, no block empty, the d_s % 4 tail columns in the
    last block, for N = 1..32; the table's q and the sweep's others."""
    if quads_per_block is not None:
        monkeypatch.setattr(ops, "L1_QUADS_PER_BLOCK", quads_per_block)
    n_quads, tail = divmod(d_s, 4)
    for n in range(1, 33):
        plan = ops.l1_plan(n, d_s)
        q, bpr = plan["quads_per_block"], plan["blocks_per_row"]
        assert q == ops.L1_QUADS_PER_BLOCK and q % plan["threads"] == 0
        assert plan["threads"] % 32 == 0
        starts = [b * q for b in range(bpr)]
        ends = [min(s + q, n_quads) for s in starts]
        assert starts[0] == 0 and ends[-1] == n_quads
        assert all(e == s for e, s in zip(ends[:-1], starts[1:]))
        assert all(e > s for s, e in zip(starts, ends)) or (
            n_quads == 0 and bpr == 1)
        assert 4 * ends[-1] + tail == d_s and tail < 4
        # the C function's own check of the plan
        assert bpr * q >= n_quads and (bpr - 1) * q < max(n_quads, 1)


def test_l1_plans_at_the_shapes_of_the_paths():
    """The grids chip_smoke.py's paths launch: 2048 quads a block (the
    paper and sparse-train rows fit one block)."""
    smoke = _chip_smoke()
    for shape, bpr in ((smoke.PAPER, 1), (smoke.SPARSE_TRAIN, 1),
                       (smoke.SPARSE_FULL, 11_679), (smoke.FULL, 61_763)):
        assert ops.l1_plan(shape["n"], shape["d_s"]) == dict(
            threads=256, quads_per_block=2048, blocks_per_row=bpr)


@pytest.mark.parametrize("capturing", [False, True])
def test_l1_scratch_is_kept_per_stream_and_never_for_a_graph_capture(
        monkeypatch, capturing):
    """The row kernels' scratch (``ops._row_scratch``, for csrc/l1_norm.cu
    and csrc/dpps_perturb.cu): eager launches reuse one set of counters for
    each (kernel, device, stream), grown when a launch needs more, and the
    two kernels never share one; a launch captured into a CUDA graph gets
    fresh zeroed counters, kept nowhere, so replays share them with no
    other launch."""
    monkeypatch.setattr(ops, "_ROW_SCRATCH", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    buf = torch.zeros((4, 128))
    first = ops._row_scratch("l1_norm", buf, 11, 8, 4)
    again = ops._row_scratch("l1_norm", buf, 11, 6, 3)
    other = ops._row_scratch("l1_norm", buf, 12, 8, 4)
    perturb = ops._row_scratch("dpps_perturb", buf, 11, 8, 4)
    grown = ops._row_scratch("l1_norm", buf, 11, 20, 4)
    for partials, tickets in (first, again, other, perturb, grown):
        assert partials.dtype == torch.float32 and tickets.dtype == torch.int32
        assert int(tickets.count_nonzero()) == 0
    assert grown[0].numel() >= 20 and grown[1].numel() >= 4
    if capturing:
        assert ops._ROW_SCRATCH == {}
        assert first[1].data_ptr() != again[1].data_ptr()
        assert (first[0].numel(), first[1].numel()) == (8, 4)
    else:
        assert set(ops._ROW_SCRATCH) == {("l1_norm", -1, 11),
                                         ("l1_norm", -1, 12),
                                         ("dpps_perturb", -1, 11)}
        assert again[1] is first[1] and other[1] is not first[1]
        assert perturb[1] is not first[1]
        assert ops._ROW_SCRATCH[("l1_norm", -1, 11)] == grown
        assert ops._ROW_SCRATCH[("dpps_perturb", -1, 11)] == perturb


def _block_sum(v: np.ndarray) -> np.float32:
    """common.cuh block_sum in f32: a shuffle-down tree in each warp (lane
    0's sum), then the warp totals added in warp order from 0."""
    v = v.astype(np.float32).reshape(-1, 32)
    for off in (16, 8, 4, 2, 1):
        v = np.concatenate([v[:, :32 - off] + v[:, off:], v[:, 32 - off:]],
                           axis=1)
    total = np.float32(0)
    for w in v[:, 0]:
        total = np.float32(total + w)
    return total


def _l1_kernel_order(row: np.ndarray, d_s: int, plan: dict) -> np.float32:
    """csrc/l1_norm.cu's sum of one row, in its order: thread t of block b
    adds |x| over each quad (x + y + z + w, left to right) into accumulator
    k % 8 for its k-th quad b q + t + k T; the last block's threads add the
    tail columns into accumulator 0; each thread adds its 8 accumulators in
    index order; block_sum; then the row's last block sums the partials,
    thread t adding partials t, t + T, ..., and block_sum."""
    threads, unroll = plan["threads"], 8
    q, bpr = plan["quads_per_block"], plan["blocks_per_row"]
    n_quads = d_s // 4
    a = np.abs(row[:4 * n_quads].astype(np.float32)).reshape(-1, 4)
    quad = ((a[:, 0] + a[:, 1]) + a[:, 2]) + a[:, 3]
    partials = []
    for b in range(bpr):
        seg = quad[b * q:min((b + 1) * q, n_quads)]
        acc = np.zeros((unroll, threads), np.float32)
        for k in range(-(-len(seg) // threads)):
            part = seg[k * threads:(k + 1) * threads]
            acc[k % unroll, :len(part)] += part
        if b == bpr - 1:
            tail = np.abs(row[4 * n_quads:d_s].astype(np.float32))
            acc[0, :len(tail)] += tail
        total = acc[0].copy()
        for u in range(1, unroll):
            total += acc[u]
        partials.append(_block_sum(total))
    p = np.array(partials, np.float32)
    acc = np.zeros(threads, np.float32)
    for k in range(-(-len(p) // threads)):
        part = p[k * threads:(k + 1) * threads]
        acc[:len(part)] += part
    return _block_sum(acc)


@pytest.mark.parametrize("plan", [None, (128, 1024), (512, 4096)])
@pytest.mark.parametrize("n,d_s", [(3, 3), (10, 7840), (4, 8192),
                                   (2, 300_001), (1, 1_048_579)])
def test_l1_kernel_sum_order_stays_within_the_tolerance(monkeypatch, n, d_s,
                                                        plan):
    """An f32 emulation of the kernel's sum order (the table's plan and two
    of the sweep's) agrees with the plain version and the exact sum to rtol
    1e-5, the tolerance the card is held to; pad lanes of 1e4 are never
    read."""
    if plan is not None:
        monkeypatch.setattr(ops, "L1_THREADS", plan[0])
        monkeypatch.setattr(ops, "L1_QUADS_PER_BLOCK", plan[1])
    rng = np.random.default_rng(n + d_s)
    buf = _rows(rng, n, d_s, pad_value=1e4)
    launch = ops.l1_plan(n, d_s)
    got = np.array([_l1_kernel_order(buf[i], d_s, launch) for i in range(n)])
    want = to_numpy(ref.l1_norm_rows(torch.from_numpy(buf), d_s))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, np.abs(buf[:, :d_s].astype(np.float64))
                               .sum(1), rtol=1e-5)


def _bad_inputs():
    """(wrapper call, exception) pairs: the inputs the wrappers refuse
    before any launch, as tests/test_torch_cuda.py asserts them on the card."""
    s = torch.zeros((3, 256))
    q = torch.zeros((1, 5, 2, 64))
    idx = torch.tensor([[0, 1], [1, 2], [0, 2]], dtype=torch.int32)
    return {
        "l1_dtype": (lambda: ops.l1_norm_rows(s.double(), 200), TypeError),
        "l1_not_contiguous": (lambda: ops.l1_norm_rows(
            s.t().contiguous().t(), 2), ValueError),
        "l1_unaligned": (lambda: ops.l1_norm_rows(
            torch.zeros(3 * 256 + 1)[1:].view(3, 256), 200), ValueError),
        "l1_d_s": (lambda: ops.l1_norm_rows(s, 300), ValueError),
        "perturb_d_s": (lambda: ops.dpps_perturb_rows(
            s, s, 1.0, 1.0, 300, seed=0, t=0), ValueError),
        # 33 nodes take the tiled kernel; W (33, 32) is not (N, N)
        "mix_33_nodes": (lambda: ops.pushsum_mix(
            torch.eye(33)[:, :32].contiguous(), torch.zeros((33, 128))),
            ValueError),
        "mix_w_shape": (lambda: ops.pushsum_mix(torch.eye(4), s), ValueError),
        # a row block of more receivers than senders
        "mix_rows": (lambda: ops.pushsum_mix(torch.ones((4, 3)), s),
                     ValueError),
        "spmm_rows": (lambda: ops.spmm(torch.zeros((4, 2), dtype=torch.int32),
                                       torch.ones((4, 2)), s), ValueError),
        "perturb_node0": (lambda: ops.dpps_perturb_rows(
            s, s, 1.0, 1.0, 200, seed=0, t=0, node0=-1), ValueError),
        "mix_dtype": (lambda: ops.pushsum_mix(torch.eye(3), s.double()),
                      TypeError),
        "spmm_d": (lambda: ops.spmm(idx, torch.ones((3, 2)), s[:, :126]
                                    .contiguous()), ValueError),
        "spmm_idx_dtype": (lambda: ops.spmm(idx.long(), torch.ones((3, 2)), s),
                           TypeError),
        "flash_d": (lambda: ops.flash_attention_bshd(
            q[..., :32], q[..., :32], q[..., :32]), ValueError),
        "flash_window": (lambda: ops.flash_attention_bshd(q, q, q, window=0),
                         ValueError),
        "flash_dtype": (lambda: ops.flash_attention_bshd(
            q.double(), q.double(), q.double()), TypeError),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch, case):
    """The kernel branch of each wrapper (entered here for CPU tensors by
    routing them as if on the card) raises before it builds or launches
    anything; no launch is counted."""
    monkeypatch.setattr(ops, "_is_cpu", lambda *tensors: False)
    monkeypatch.setattr(ops.build, "function", lambda name: pytest.fail(
        f"{case} reached the {name} launch"))
    ops.reset_launch_counts()
    call, error = _bad_inputs()[case]
    with pytest.raises(error):
        call()
    assert sum(ops.launch_counts().values()) == 0


# meta alone takes the wrappers' meta path (tests/test_torch_meta_ops.py)
@pytest.mark.parametrize("devices", [("cpu", "meta"), ("meta", "cpu"),
                                     ("cpu", "cpu", "meta")])
def test_wrappers_refuse_mixed_or_unsupported_devices(devices):
    tensors = [torch.zeros((2, 128), device=d) for d in devices]
    with pytest.raises(ValueError, match="mixed or unsupported"):
        ops.l1_norm_rows(tensors[0], 100) if len(tensors) == 1 else \
            ops.pushsum_mix(torch.eye(2, device=devices[0]), tensors[-1])


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, ties away from
    zero (finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the tensor cores form it from TF32 operands (exact products,
    f32 sums): one pass (hi hi), or 3xTF32 (lo hi + hi lo + hi hi)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


@pytest.mark.parametrize("d", ops.FLASH_HEAD_DIMS)
def test_three_tf32_products_keep_the_flash_tolerance(d):
    """The arithmetic of csrc/flash_attention.cu: Q K^T and P V in 3xTF32
    agree with the plain version at the kernel's atol 1e-5 / rtol 1e-4;
    a single TF32 pass (10 mantissa bits) does not, which is why the kernel
    never takes one."""
    rng = np.random.default_rng(d)
    s = 256
    q, k, v = (torch.from_numpy(rng.normal(size=(s, d)).astype(np.float32))
               for _ in range(3))
    want = ref.flash_attention(q[None], k[None], v[None])[0]
    pos = torch.arange(s)
    seen = pos[:, None] >= pos[None, :]
    out = {}
    for passes in (1, 3):
        scores = _mm_tf32(q, k.T.contiguous(), passes) * (1.0 / math.sqrt(d))
        p = torch.softmax(scores.masked_fill(~seen, -math.inf), dim=-1)
        out[passes] = _mm_tf32(p, v, passes)
    torch.testing.assert_close(out[3], want, rtol=1e-4, atol=1e-5)
    assert not bool(((out[1] - want).abs()
                     <= 1e-5 + 1e-4 * want.abs()).all())


@pytest.mark.parametrize("n,d,kernel,tile", [
    (1, 7936, "template", None), (32, 1 << 20, "template", None),
    (33, 1 << 20, "tiles", "64x128"), (64, 1 << 20, "tiles", "64x128"),
    (256, 1 << 20, "tiles", "128x128"), (4096, 8, "tiles", "16x8"),
    (128, 7936, "tiles", "32x64"), (4096, 128, "tiles", "32x64"),
    (64, 300, "tiles", "64x128"), (33, 1, "tiles", "16x8"),
    (100, 20, "tiles", "32x64"), (1024, 1 << 16, "tiles", "128x128")])
def test_mix_plan_takes_the_template_to_32_nodes_and_tiles_above(n, d, kernel,
                                                                 tile):
    """N <= 32: one column a thread; above, D <= 8 the 16 x 8 tile, N <= 64
    one row tile of 64, else the first of 128 x 128, 64 x 128, 32 x 64 with
    a tile for each SM of a 132-SM card, or 32 x 64."""
    plan = ops.mix_plan(n, d, 132)
    assert (plan["kernel"], plan["tile"]) == (kernel, tile)
    if kernel == "template":
        assert plan["args"] == (0,) * 7
        return
    bm, bn, tm, tn, bk, stages = ops.MIX_TILES[tile]
    assert plan["tiles"] == -(-n // bm) * -(-d // bn) < 2 ** 31
    assert plan["threads"] == (bm // tm) * (bn // tn) <= 1024
    assert plan["args"] == (bm, bn, tm, tn, bk, stages, plan["smem_bytes"])


@pytest.mark.parametrize("n,d", [(33, 1), (33, 1 << 20), (64, 300),
                                 (256, 129), (4096, 8), (4096, 128),
                                 (100_003, 7), (5000, 1 << 20)])
@pytest.mark.parametrize("tile", list(ops.MIX_TILES))
def test_mix_plan_covers_every_output_once(n, d, tile):
    """Under every tile, the tiles and thread t of a tile (rows ty + k
    BM/TM, columns v BN/(TN/V) + V tx + c for V = min(TN, 4) neighbours) own
    each output (i, c) of the (N, D) result exactly once, no tile is empty,
    the grid is under 2^31 blocks, the threads fit a block and the ring
    fits an SM's shared memory."""
    plan = ops.mix_plan(n, d, 132, tile)
    bm, bn, tm, tn, bk, stages = ops.MIX_TILES[tile]
    assert bk % 8 == 0 and bn % tn == 0 and bm % tm == 0
    assert tn in (1, 2) or tn % 4 == 0
    assert plan["threads"] <= 1024 and plan["smem_bytes"] <= 227 * 1024
    row_tiles, col_tiles = -(-n // bm), -(-d // bn)
    assert plan["tiles"] == row_tiles * col_tiles < 2 ** 31
    # one block's ownership of its BM x BN tile, then the tiles of the grid
    vec = min(tn, 4)
    groups = bn // tn
    owned = np.zeros((bm, bn), np.int64)
    for t in range(plan["threads"]):
        tx, ty = t % groups, t // groups
        for k in range(tm):
            for m in range(tn // vec):
                for c in range(vec):
                    owned[ty + k * (bm // tm),
                          m * (bn // (tn // vec)) + vec * tx + c] += 1
    assert (owned == 1).all()
    # the grid's tiles [BM r, + BM) and [BN c, + BN): the last of each holds
    # a real row and a real column
    assert (row_tiles - 1) * bm < n <= row_tiles * bm
    assert (col_tiles - 1) * bn < d <= col_tiles * bn


# -- csrc/dpps_perturb.cu launch plan and its sum order ---------------------

@pytest.mark.parametrize("tables", [
    {}, {"PERTURB_QUADS_PER_BLOCK": 512}, {"PERTURB_ROW_LANES": 32},
    {"PERTURB_ROW_LANES": 8, "PERTURB_THREADS": 64},
    {"PERTURB_SHORT_QUADS": 0}, {"PERTURB_SHORT_QUADS": 1 << 20}])
@pytest.mark.parametrize("n,d_s", [(1, 3), (10, 7840), (100_003, 300),
                                   (4096, 8), (5, 505_956_352),
                                   (24, 300_001)])
def test_perturb_plan_writes_every_quad_once(monkeypatch, tables, n, d_s):
    """Long rows: block b of a row writes quads [b q, min((b + 1) q, d_pad /
    4)), together every quad of the row once, no block empty. Short rows:
    rows_per_block rows a block, a power of two <= 32 lanes a row, lane l
    writing quads l, l + lanes, ...: every quad once. Either way every real
    quad (a column < d_s) is read by the thread that writes it and no pad
    quad is read, the grid is under 2^31 blocks (65,535 rows a launch of
    long rows) and the plan is one the C function takes."""
    for k, v in tables.items():
        monkeypatch.setattr(ops, k, v)
    d_pad = _d_pad(d_s)
    quads, real = d_pad // 4, -(-d_s // 4)
    plan = ops.perturb_plan(n, d_pad)
    threads, rpb = plan["threads"], plan["rows_per_block"]
    q, bpr = plan["quads_per_block"], plan["blocks_per_row"]
    assert threads % 32 == 0 and 32 <= threads <= 256 and threads % rpb == 0
    if rpb > 1:
        lanes = threads // rpb
        assert lanes <= 32 and lanes & (lanes - 1) == 0
        assert bpr == 1 and q >= quads
        assert plan["blocks"] == -(-n // rpb) < 2 ** 31
        written = np.zeros(quads, np.int64)
        for lane in range(lanes):
            written[lane::lanes] += 1
        assert (written == 1).all()
        return
    assert plan["blocks"] == n * bpr and bpr < 2 ** 31
    starts = [b * q for b in range(bpr)]
    ends = [min(s + q, quads) for s in starts]
    assert starts[0] == 0 and ends[-1] == quads
    assert all(e == s for e, s in zip(ends[:-1], starts[1:]))
    assert all(e > s for s, e in zip(starts, ends))
    assert bpr * q >= quads and (bpr - 1) * q < quads
    assert real <= quads


def _perturb_kernel_order(v: np.ndarray, d_s: int, plan: dict) -> np.float32:
    """csrc/dpps_perturb.cu's sum of |v| over one row's first d_s columns,
    in its order: each thread adds |v| of its quads' real elements (quad
    by quad in its order, element by element) into one f32 sum. Short rows:
    lane l of the row takes quads l, l + lanes, ...; the lanes' sums meet
    in a shuffle-down tree over the row's lanes. Long rows: thread t of
    block b takes quads b q + t, + T, ...; block_sum; with more than one
    block a row, the row's last block adds the partials, thread t adding
    partials t, t + T, ..., then block_sum."""
    d_pad = _d_pad(d_s)
    quads, threads = d_pad // 4, plan["threads"]
    a = np.zeros(d_pad, np.float32)
    a[:d_s] = np.abs(v[:d_s].astype(np.float32))
    a = a.reshape(quads, 4)

    def thread_sum(qs):
        acc = np.float32(0)
        for qq in qs:
            for k in range(4):
                if 4 * qq + k < d_s:
                    acc = np.float32(acc + a[qq, k])
        return acc

    if plan["rows_per_block"] > 1:
        lanes = threads // plan["rows_per_block"]
        sums = np.array([thread_sum(range(l, quads, lanes))
                         for l in range(lanes)], np.float32)
        off = lanes // 2
        while off:
            sums[:lanes - off] = sums[:lanes - off] + sums[off:lanes]
            off //= 2
        return sums[0]
    q, bpr = plan["quads_per_block"], plan["blocks_per_row"]
    partials = []
    for b in range(bpr):
        hi = min((b + 1) * q, quads)
        partials.append(_block_sum(np.array(
            [thread_sum(range(b * q + t, hi, threads))
             for t in range(threads)], np.float32)))
    if bpr == 1:
        return partials[0]
    p = np.array(partials, np.float32)
    acc = np.zeros(threads, np.float32)
    for k in range(-(-len(p) // threads)):
        part = p[k * threads:(k + 1) * threads]
        acc[:len(part)] += part
    return _block_sum(acc)


@pytest.mark.parametrize("tables", [
    {}, {"PERTURB_QUADS_PER_BLOCK": 512}, {"PERTURB_ROW_LANES": 32},
    {"PERTURB_ROW_LANES": 8}, {"PERTURB_SHORT_QUADS": 1 << 20}])
@pytest.mark.parametrize("n,d_s", [(3, 3), (4, 300), (2, 7840),
                                   (2, 8192 + 5), (1, 300_001)])
def test_perturb_kernel_sum_order_stays_within_the_tolerance(monkeypatch,
                                                             tables, n, d_s):
    """An f32 emulation of the kernel's order for eps_l1 and noise_l1 (the
    table's plan and others, short rows and long, one block a row and
    many) agrees with the plain version and the exact sum to rtol 1e-5,
    the tolerance the card is held to; pad lanes of 1e4 are never read."""
    for k, v in tables.items():
        monkeypatch.setattr(ops, k, v)
    rng = np.random.default_rng(n + d_s)
    s, eps = _rows(rng, n, d_s, pad_value=1e4), _rows(rng, n, d_s,
                                                      pad_value=1e4)
    plan = ops.perturb_plan(n, _d_pad(d_s))
    _, eps_l1, noise_l1 = ref.dpps_perturb_rows(
        torch.from_numpy(s), torch.from_numpy(eps), 0.7, 0.1, d_s, seed=5,
        t=3)
    noise = to_numpy(ref.laplace_from_bits(
        ref.philox_bits(5, 3, n, 0, d_s), 0.7))
    for i in range(n):
        got = [_perturb_kernel_order(eps[i], d_s, plan),
               _perturb_kernel_order(noise[i], d_s, plan)]
        want = [float(eps_l1[i]), float(noise_l1[i])]
        exact = [np.abs(eps[i, :d_s].astype(np.float64)).sum(),
                 np.abs(noise[i].astype(np.float64)).sum()]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(got, exact, rtol=1e-5)
