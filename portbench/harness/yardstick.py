"""The yardstick: the card's published peaks, the least time a kernel or a
round could take, and the model FLOPs of a training step.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), at
its full 700 W power limit. A byte count takes each input read once and
each output written once, whatever a kernel reads again.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12        # float32 outside the tensor cores
INT32_OPS_PER_S = 33.5e12    # half the f32 lanes of an SM are int32 lanes
TF32_OPS_PER_S = 495e12      # dense TF32 on the tensor cores
LANE = 128                   # the packed wire buffer's column alignment


def d_pad(d_s: int) -> int:
    return -(-d_s // LANE) * LANE


def bound_s(nbytes: float, f32_ops: float = 0.0, int_ops: float = 0.0,
            tf32_ops: float = 0.0) -> float:
    """The larger of the bytes over the memory rate and the operations
    over their peak rates, in seconds."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (f32_ops / F32_OPS_PER_S + int_ops / INT32_OPS_PER_S
             + tf32_ops / TF32_OPS_PER_S)
    return max(t_bytes, t_ops)


def perturb_bound_s(n: int, d_s: int) -> float:
    """``dpps_perturb``: s and eps read, s_noise written (pad columns
    too), the two per-node norms written and the scale read; 25 int32 and
    17 f32 operations an element (Philox and the Laplace transform)."""
    return bound_s(8.0 * n * d_s + 4.0 * n * d_pad(d_s) + 8 * n + 4,
                   f32_ops=17.0 * n * d_s, int_ops=25.0 * n * d_s)


def l1_bound_s(n: int, d_s: int) -> float:
    """``l1_norm``: the rows read once, one norm a row written."""
    return bound_s(4.0 * n * d_s + 4 * n, f32_ops=2.0 * n * d_s)


def mix_bound_s(n: int, d_s: int) -> float:
    """``pushsum_mix`` (dense W @ x): x read and the result written over
    the padded width, W read; 2 N^2 operations a column."""
    dp = d_pad(d_s)
    return bound_s(8.0 * n * dp + 4.0 * n * n, f32_ops=2.0 * n * n * dp)


def spmm_bound_s(n: int, k: int, nnz: int, d_s: int) -> float:
    """``spmm`` (padded CSR, K slots a row): x read and the result written
    over the padded width, the (N, K) index and value tables read; 2
    operations a stored edge and column."""
    dp = d_pad(d_s)
    return bound_s(8.0 * n * dp + 8.0 * n * k, f32_ops=2.0 * nnz * dp)


def round_floor_s(n: int, d_s: int, w_entries: int) -> float:
    """The least time any implementation of a pure-consensus DPPS round
    could take: the (N, d_s) f32 state read once and written once, and
    W's stored entries read once (4 bytes each; a padded-CSR entry also
    its 4-byte index). It is not the sum of today's kernels' bounds, so a
    round that fuses them still reads under 100 %."""
    return bound_s(8.0 * n * d_s + w_entries)


def model_flops_per_sequence(m: dict, seq: int) -> float:
    """Model FLOPs of one training sequence of the decoder sized by ``m``:
    3 x the forward's matmul FLOPs (the held layers' projections and MLP,
    the head) plus causal attention's two products over the lower
    triangle of the scores; nothing recomputed is counted."""
    d, f = m["d_model"], m["d_ff"]
    hd = m["n_heads"] * m["head_dim"]
    kd = m["n_kv_heads"] * m["head_dim"]
    mlp = (3 if m["activation"] in ("silu", "geglu") else 2) * d * f
    proj = 2 * d * hd + 2 * d * kd
    pairs = seq * (seq + 1) / 2
    per_layer = 2.0 * seq * (proj + mlp) + 2.0 * 2.0 * pairs * hd
    head = 2.0 * (seq - 1) * d * m["vocab_size"]
    return 3.0 * (m["n_layers"] * per_layer + head)
