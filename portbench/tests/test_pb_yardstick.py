"""The yardstick's counts against numbers worked out by hand."""
import pytest

from portbench.harness import yardstick as y


def test_model_flops_by_hand():
    # one layer, d = 4, 2 heads of 2, d_ff 8, plain GELU, vocab 3, S = 3:
    # projections 2 * 3 * (4 * 4 * 4) = 384; MLP 2 * 3 * (2 * 4 * 8) = 384;
    # attention 2 products * 2 * 6 pairs * 4 = 96; head 2 * 2 * 4 * 3 = 48
    m = dict(d_model=4, n_heads=2, n_kv_heads=2, head_dim=2, d_ff=8,
             activation="gelu", vocab_size=3, n_layers=1)
    assert y.model_flops_per_sequence(m, 3) == 3 * (384 + 384 + 96 + 48)
    # a gated MLP carries a third matrix
    g = dict(m, activation="silu")
    assert y.model_flops_per_sequence(g, 3) == 3 * (384 + 576 + 96 + 48)


def test_musicgen_step_flops():
    m = dict(d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
             d_ff=8192, activation="gelu", vocab_size=2048, n_layers=24)
    per_frame = y.model_flops_per_sequence(m, 1500) / 1500
    # 6 x 50.3M parameters a layer x 24 layers, plus attention and head
    assert 7.6e9 < per_frame < 7.9e9


def test_round_floor_by_hand():
    # (2, 100) state read and written, a 2 x 2 W: 1600 + 16 bytes
    assert y.round_floor_s(2, 100, 16) == pytest.approx(1616 / 3.35e12)
    # the xlstm cell: 24 x 95,669,064 f32 read and written
    assert y.round_floor_s(24, 95_669_064, 0) * 1e3 == pytest.approx(
        5.4826, abs=1e-3)


def test_kernel_bounds_by_hand():
    assert y.d_pad(95_669_064) == 95_669_120
    # perturb at (1, 128): 8 * 128 + 4 * 128 + 8 + 4 bytes
    assert y.perturb_bound_s(1, 128) == pytest.approx(
        max(1548 / 3.35e12, 17 * 128 / 67e12 + 25 * 128 / 33.5e12))
    assert y.l1_bound_s(2, 128) == pytest.approx(1032 / 3.35e12)
    assert y.mix_bound_s(4, 128) == pytest.approx(
        max((8 * 4 * 128 + 64) / 3.35e12, 2 * 16 * 128 / 67e12))
    assert y.spmm_bound_s(4, 3, 10, 128) == pytest.approx(
        max((8 * 4 * 128 + 96) / 3.35e12, 2 * 10 * 128 / 67e12))
