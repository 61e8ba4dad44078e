"""Recurrent sequence mixers: mLSTM and sLSTM (xLSTM) and Mamba2 (port of
``repro.models.ssm``).

Each mixer has
  init_*(gen, d_model, ...)            -> params
  *_state(batch, ...)                  -> the zero state (f32)
  *_seq(params, x, state=None)         -> (y, final state)   # prefill
  *_step(params, x_t, state)           -> (y_t, new state)   # decode

The reference scans time with ``lax.scan``; here ``*_seq`` is a Python
loop over the positions (``_mlstm_scan``, ``_slstm_scan``,
``_mamba2_scan``), one step of a few small launches each on the card,
through :func:`repro_torch.core.loops.time_loop` (a plain loop; under a
dry run's cost count, its loop rule).
Whatever does not depend on the carried state is computed for the whole
sequence before the loop: the projections, the gate activations that take
no state (the forget gate's log-sigmoid, Mamba2's decay and ``dt B``), and
Mamba2's skip term after it. The cell keeps the reference's exp-gate
stabiliser and its order of operations, so f32 results agree. States are
f32 whatever the parameters' dtype, as in the reference; no input state is
written in place.

As the reference, the short causal conv of Mamba2 and the mLSTM block's
depthwise conv are left out, and the gate biases start at small constants.

Over a model axis (``axis=``, :mod:`repro_torch.models.parallel`) the
mLSTM and Mamba2 run on the rank's heads: its column blocks of the split
projections, its heads' columns of the whole gate leaves (each through
:meth:`~repro_torch.models.parallel.ModelAxis.copy`, so its gradient is
summed over the ranks), the mLSTM's ``u`` gathered whole; the output is
the rank's partial sum of ``w_down`` / ``w_out``, which the caller
reduces. Every size comes from the caller (the config) or from a whole
leaf's unsplit dim, never from a split dim of a shard. The sLSTM has no
axis: it runs whole on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.loops import time_loop
from repro_torch.models.layers import dense_init
from repro_torch.models.parallel import NO_AXIS, ModelAxis

__all__ = [
    "init_mlstm", "mlstm_seq", "mlstm_step", "mlstm_state",
    "init_slstm", "slstm_seq", "slstm_step", "slstm_state",
    "init_mamba2", "mamba2_seq", "mamba2_step", "mamba2_state",
]


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM; xLSTM arXiv:2405.04517 Eq. 19-27)
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, d_model: int, n_heads: int,
               proj_factor: float = 2.0, dtype=torch.float32,
               device=None) -> dict:
    d_inner = int(d_model * proj_factor)
    assert d_inner % n_heads == 0
    return {
        "w_up": dense_init(gen, (d_model, d_inner), dtype, device),
        "w_q": dense_init(gen, (d_inner, d_inner), dtype, device),
        "w_k": dense_init(gen, (d_inner, d_inner), dtype, device),
        "w_v": dense_init(gen, (d_inner, d_inner), dtype, device),
        # scalar i/f gates per head + vector o gate
        "w_if": dense_init(gen, (d_inner, 2 * n_heads), dtype, device),
        "b_if": torch.cat([  # input gate starts small, forget gate open
            torch.full((n_heads,), -3.0, dtype=dtype, device=device),
            torch.full((n_heads,), 3.0, dtype=dtype, device=device)]),
        "w_o": dense_init(gen, (d_model, d_inner), dtype, device),
        "w_down": dense_init(gen, (d_inner, d_model), dtype, device),
    }


def mlstm_state(batch: int, d_model: int, n_heads: int,
                proj_factor: float = 2.0, device=None, *,
                local_heads: int | None = None) -> dict:
    """The zero state of ``local_heads`` (default all ``n_heads``) of the
    mLSTM's heads, each of ``d_model proj_factor / n_heads`` dims."""
    hd = int(d_model * proj_factor) // n_heads
    h = n_heads if local_heads is None else local_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, hd, hd), **f32),
            "n": torch.zeros((batch, h, hd), **f32),
            "m": torch.full((batch, h), -1e30, **f32)}


def _head_cols(w: torch.Tensor, cols) -> torch.Tensor:
    """``w``'s last-dim ``cols`` (a slice or an index tensor), or ``w``
    itself for None (every column: the op the whole model runs)."""
    return w if cols is None else w[..., cols]


def _mlstm_gate_cols(heads: slice | None, n_heads: int, device):
    """The columns of ``w_if`` / ``b_if`` that ``heads`` read: their input
    gates ``[a, b)``, then their forget gates ``H + [a, b)``."""
    if heads is None:
        return None
    idx = torch.arange(heads.start, heads.stop, device=device)
    return torch.cat([idx, idx + n_heads])


def _mlstm_gates_qkv(params: dict, x: torch.Tensor, n_heads: int,
                     head_dim: int, axis: ModelAxis = NO_AXIS):
    """x (B, S, d_model) -> q, k, v (B, S, h, hd), i/f pre-activations
    (B, S, h) f32, o (B, S, h hd), for the rank's h of the ``n_heads``
    heads (all without an axis)."""
    heads = axis.heads(n_heads)
    h = n_heads if heads is None else heads.stop - heads.start
    hd = head_dim
    u = axis.gather(x @ params["w_up"])
    q = (u @ params["w_q"]).reshape(u.shape[:-1] + (h, hd))
    k = (u @ params["w_k"]).reshape(u.shape[:-1] + (h, hd)) / \
        float(torch.sqrt(torch.tensor(hd, dtype=torch.float32)))
    v = (u @ params["w_v"]).reshape(u.shape[:-1] + (h, hd))
    cols = _mlstm_gate_cols(heads, n_heads, x.device)
    gif = (u @ _head_cols(axis.copy(params["w_if"]), cols)
           + _head_cols(axis.copy(params["b_if"]), cols)).float()
    o = torch.sigmoid((x @ params["w_o"]).float()).to(x.dtype)
    return q, k, v, gif[..., :h], gif[..., h:], o


def _mlstm_cell(C, n, m, q, k, v, i_pre, f_log):
    """One stabilised mLSTM step on f32 tensors: C (B, H, hd_v, hd_k), n
    (B, H, hd), m (B, H); q, k, v (B, H, hd); i_pre, f_log (B, H), the
    forget gate already as its log-sigmoid. -> (C, n, m, h_t (B, H, hd))."""
    fm = f_log + m
    m_new = torch.maximum(fm, i_pre)
    f_act = torch.exp(fm - m_new)[..., None]
    i_act = torch.exp(i_pre - m_new)[..., None]
    C_new = f_act[..., None] * C + i_act[..., None] * (v[..., :, None]
                                                        * k[..., None, :])
    n_new = f_act * n + i_act * k
    num = torch.matmul(C_new, q[..., None])[..., 0]             # (B, H, hd_v)
    den = torch.clamp_min((n_new * q).sum(dim=-1).abs(), 1.0)   # (B, H)
    return C_new, n_new, m_new, num / den[..., None]


def _mlstm_scan(state, q, k, v, i_pre, f_log):
    """The mLSTM recurrence over S positions of (B, S, ...) f32 inputs ->
    ((B, S, H, hd) outputs, final (C, n, m))."""
    def step(carry, inp):
        C, n, m, h_t = _mlstm_cell(*carry, *inp)
        return (C, n, m), h_t

    return time_loop(step, tuple(state), (q, k, v, i_pre, f_log))


def _mlstm_carry(state: dict):
    return tuple(state[k].float() for k in ("C", "n", "m"))


def _mlstm_head_dim(params: dict, n_heads: int, head_dim: int | None) -> int:
    """``head_dim``, or d_inner / H from ``w_q``'s rows (a dim no axis
    splits)."""
    return params["w_q"].shape[0] // n_heads if head_dim is None else head_dim


def mlstm_seq(params: dict, x: torch.Tensor, *, n_heads: int,
              state: dict | None = None, head_dim: int | None = None,
              axis: ModelAxis = NO_AXIS):
    """The mLSTM over the S positions of x (B, S, d_model) -> (the rank's
    partial output (B, S, d_model), final state). ``n_heads``: the whole
    model's heads; ``head_dim`` (default d_inner / n_heads); ``axis``: the
    rank's heads only (its output a partial sum over "model")."""
    b, s, d = x.shape
    hd = _mlstm_head_dim(params, n_heads, head_dim)
    heads = axis.heads(n_heads)
    if state is None:
        state = mlstm_state(b, d, n_heads, n_heads * hd / d, device=x.device,
                            local_heads=None if heads is None
                            else heads.stop - heads.start)
    q, k, v, i_pre, f_pre, o = _mlstm_gates_qkv(params, x, n_heads, hd, axis)
    hs, (C, n, m) = _mlstm_scan(_mlstm_carry(state), q.float(), k.float(),
                                v.float(), i_pre, F.logsigmoid(f_pre))
    h = hs.reshape(b, s, -1).to(x.dtype)                  # (B, S, d_inner)
    return (o * h) @ params["w_down"], {"C": C, "n": n, "m": m}


def mlstm_step(params: dict, x: torch.Tensor, state: dict, *, n_heads: int,
               head_dim: int | None = None, axis: ModelAxis = NO_AXIS):
    """x: (B, 1, d_model)."""
    hd = _mlstm_head_dim(params, n_heads, head_dim)
    q, k, v, i_pre, f_pre, o = _mlstm_gates_qkv(params, x, n_heads, hd, axis)
    C, n, m = _mlstm_carry(state)
    C, n, m, h = _mlstm_cell(C, n, m, q[:, 0].float(), k[:, 0].float(),
                             v[:, 0].float(), i_pre[:, 0],
                             F.logsigmoid(f_pre[:, 0]))
    h = h.reshape(x.shape[0], 1, -1).to(x.dtype)
    return (o * h) @ params["w_down"], {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with recurrent gate connections)
# ---------------------------------------------------------------------------

_SLSTM_KEYS = ("c", "n", "m", "h")


def init_slstm(gen: torch.Generator, d_model: int, dtype=torch.float32,
               device=None) -> dict:
    full = lambda v: torch.full((d_model,), v, dtype=dtype, device=device)
    return {
        "w": dense_init(gen, (d_model, 4 * d_model), dtype, device),  # z,i,f,o
        "r": dense_init(gen, (d_model, 4 * d_model), dtype, device),  # h -> gates
        "b": torch.cat([full(0.0), full(-3.0), full(3.0), full(0.0)]),
    }


def slstm_state(batch: int, d_model: int, device=None) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d_model), **f32),
            "n": torch.zeros((batch, d_model), **f32),
            "m": torch.full((batch, d_model), -1e30, **f32),
            "h": torch.zeros((batch, d_model), **f32)}


def _slstm_cell(r, carry, wx_t):
    c, n, m, h = carry
    pre = (wx_t + h @ r).float()
    z_pre, i_pre, f_pre, o_pre = pre.chunk(4, dim=-1)
    z = torch.tanh(z_pre)
    f_log = F.logsigmoid(f_pre)
    m_new = torch.maximum(f_log + m, i_pre)
    f_act = torch.exp(f_log + m - m_new)
    i_act = torch.exp(i_pre - m_new)
    c_new = f_act * c + i_act * z
    n_new = f_act * n + i_act
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp_min(n_new, 1.0)
    return c_new, n_new, m_new, h_new


def _slstm_scan(r, carry, wx):
    """The sLSTM recurrence over the S positions of ``wx`` (B, S, 4d) f32
    -> ((B, S, d) outputs, final (c, n, m, h))."""
    def step(carry, inp):
        carry = _slstm_cell(r, carry, inp[0])
        return carry, carry[3]

    return time_loop(step, tuple(carry), (wx,))


def slstm_seq(params: dict, x: torch.Tensor, state: dict | None = None):
    b, s, d = x.shape
    if state is None:
        state = slstm_state(b, d, device=x.device)
    wx = (x @ params["w"] + params["b"]).float()
    hs, carry = _slstm_scan(params["r"].float(),
                            tuple(state[k].float() for k in _SLSTM_KEYS), wx)
    return hs.to(x.dtype), dict(zip(_SLSTM_KEYS, carry))


def slstm_step(params: dict, x: torch.Tensor, state: dict):
    wx = (x[:, 0] @ params["w"] + params["b"]).float()
    carry = _slstm_cell(params["r"].float(),
                        tuple(state[k].float() for k in _SLSTM_KEYS), wx)
    return carry[3][:, None].to(x.dtype), dict(zip(_SLSTM_KEYS, carry))


# ---------------------------------------------------------------------------
# Mamba2 (state-space duality layer, recurrent form; arXiv:2405.21060)
# ---------------------------------------------------------------------------

def init_mamba2(gen: torch.Generator, d_model: int, d_state: int = 64,
                expand: int = 2, head_dim: int = 64, dtype=torch.float32,
                device=None) -> dict:
    d_inner = expand * d_model
    assert d_inner % head_dim == 0
    nh = d_inner // head_dim
    return {
        "w_in": dense_init(gen, (d_model, 2 * d_inner), dtype, device),  # x, z
        "w_b": dense_init(gen, (d_model, d_state), dtype, device),
        "w_c": dense_init(gen, (d_model, d_state), dtype, device),
        "w_dt": dense_init(gen, (d_model, nh), dtype, device),
        "b_dt": torch.full((nh,), -2.0, dtype=dtype, device=device),
        "a_log": torch.zeros((nh,), dtype=dtype, device=device),  # A = -1
        "d_skip": torch.ones((nh,), dtype=dtype, device=device),
        "w_out": dense_init(gen, (d_inner, d_model), dtype, device),
    }


def mamba2_state(batch: int, d_model: int, d_state: int = 64,
                 expand: int = 2, head_dim: int = 64, device=None, *,
                 local_heads: int | None = None) -> dict:
    """The zero state of ``local_heads`` (default all ``expand d_model /
    head_dim``) of the Mamba2 heads."""
    nh = expand * d_model // head_dim if local_heads is None else local_heads
    return {"h": torch.zeros((batch, nh, d_state, head_dim),
                             dtype=torch.float32, device=device)}


def _mamba2_heads(params, n_heads: int | None, axis: ModelAxis):
    """(the whole layer's heads, the rank's slice of them or None): ``n_heads``
    or ``w_dt``'s columns (a whole leaf)."""
    nh = params["w_dt"].shape[1] if n_heads is None else n_heads
    return nh, axis.heads(nh)


def _mamba2_proj(params, x, head_dim: int, nh: int, heads,
                 axis: ModelAxis):
    """x (B, S, d_model) -> xh (B, S, h, hd), z (B, S, h hd), B and C (B, S,
    n), dt (B, S, h) f32, for the rank's h of the ``nh`` heads (``heads``;
    None: all). The rank's ``w_in`` is its heads' ``x`` columns, then
    their ``z`` columns."""
    h = nh if heads is None else heads.stop - heads.start
    d_inner = h * head_dim
    xz = x @ params["w_in"]
    xi, z = xz[..., :d_inner], xz[..., d_inner:]
    xh = xi.reshape(xi.shape[:-1] + (h, head_dim))
    bmat = x @ axis.copy(params["w_b"])
    cmat = x @ axis.copy(params["w_c"])
    dt = F.softplus((x @ _head_cols(axis.copy(params["w_dt"]), heads)
                     + _head_cols(axis.copy(params["b_dt"]), heads)).float())
    return xh, z, bmat, cmat, dt


def _mamba2_gates(params, bmat, dt, heads, axis: ModelAxis):
    """The state-free factors of the cell: decay = exp(dt A) (..., h) and
    dt B (..., h, n), f32, the first factor of the reference's
    ``dt * B * x``."""
    a_log = _head_cols(axis.copy(params["a_log"]), heads)
    a_neg = -torch.exp(a_log.float())
    return torch.exp(dt * a_neg), dt[..., None] * bmat[..., None, :].float()


def _mamba2_scan(h, decay, dtb, xh, cmat):
    """The Mamba2 recurrence h = decay h + (dt B) x and its readout C h over
    the S positions of decay (B, S, nh), dtb (B, S, nh, n), xh (B, S, nh,
    hd), cmat (B, S, n), all f32, from h (B, nh, n, hd) -> ((B, S, nh, hd)
    readouts, final h). The skip term D x is the caller's. Each input is
    cut into its steps once, shaped to broadcast as the reference's cell
    does: decay (B, nh, 1, 1), dt B (B, nh, n, 1), x (B, nh, 1, hd), C
    (B, 1, 1, n)."""
    def step(h, inp):
        dec_t, dtb_t, x_t, c_t = inp
        h = dec_t * h + dtb_t * x_t
        return h, torch.matmul(c_t, h)                       # (B, nh, 1, hd)

    ys, h = time_loop(step, h, (decay[..., None, None], dtb[..., None],
                                xh[..., None, :], cmat[:, :, None, None, :]),
                      out_dim=2, cat=True)
    return ys.transpose(1, 2), h


def _mamba2_out(params, y, xh, z, x, heads, axis: ModelAxis):
    """y (B, S, h, hd) f32 readouts + D x, gated by silu(z), projected (the
    rank's partial sum over its heads' rows of ``w_out``)."""
    d_skip = _head_cols(axis.copy(params["d_skip"]), heads)
    y = y + d_skip.float()[:, None] * xh.float()
    y = y.reshape(x.shape[0], x.shape[1], -1).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    return y @ params["w_out"]


def _mamba2(params, x, state, head_dim: int, n_heads, axis: ModelAxis):
    nh, heads = _mamba2_heads(params, n_heads, axis)
    xh, z, bmat, cmat, dt = _mamba2_proj(params, x, head_dim, nh, heads,
                                         axis)
    decay, dtb = _mamba2_gates(params, bmat, dt, heads, axis)
    if state is None:
        b, _, d = x.shape
        state = mamba2_state(b, d, params["w_b"].shape[1],
                             nh * head_dim // d, head_dim, device=x.device,
                             local_heads=None if heads is None
                             else heads.stop - heads.start)
    ys, h = _mamba2_scan(state["h"].float(), decay, dtb, xh.float(),
                         cmat.float())
    return _mamba2_out(params, ys, xh, z, x, heads, axis), {"h": h}


def mamba2_seq(params: dict, x: torch.Tensor, *, head_dim: int = 64,
               state: dict | None = None, n_heads: int | None = None,
               axis: ModelAxis = NO_AXIS):
    """Mamba2 over the S positions of x (B, S, d_model) -> (the rank's
    partial output, final state). ``n_heads``: the layer's heads nh
    (default ``w_dt``'s columns); ``axis``: the rank's heads only."""
    return _mamba2(params, x, state, head_dim, n_heads, axis)


def mamba2_step(params: dict, x: torch.Tensor, state: dict, *,
                head_dim: int = 64, n_heads: int | None = None,
                axis: ModelAxis = NO_AXIS):
    return _mamba2(params, x, state, head_dim, n_heads, axis)
