"""Perturbed Push-Sum runtime (paper Alg. 1 lines 6-8), port of
``repro.core.pushsum``.

State: gossiped values ``s`` (a tree of node-stacked leaves, or the packed
(N, d_pad) buffer) and the push-sum weights ``a`` (N,). With the paper's
doubly-stochastic W, ``a`` stays 1 (Eq. 16).

Schedules ported here: dense (``W @ s``), circulant (a weighted sum of
rolls along the node axis) and sparse (a padded receiver-major CSR edge
list, ``core.topology.padded_csr``: O(edges d) a round instead of
O(N^2 d)). With ``use_kernels`` the contraction goes through the
``pushsum_mix`` kernel (dense) or the ``spmm`` kernel (sparse): once over
the packed buffer, or once a leaf of a tree state (``gossip_dense`` /
``gossip_sparse``, as ``repro/core/pushsum.py:141-215``). The (N,) weights
``a`` stay on the plain path, as the reference left them to XLA, and the
circulant schedule's rolls have no kernel, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core.tree_utils import PyTree, tree_leaves, tree_map
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.obs.trace import PHASE_PUSHSUM_MIX, phase

__all__ = [
    "PushSumState",
    "init_push_sum",
    "gossip_dense",
    "gossip_circulant",
    "gossip_sparse",
    "gossip_packed",
    "gossip",
    "sparse_mix",
    "correct",
    "consensus_error",
]


class PushSumState(NamedTuple):
    s: PyTree            # gossiped values, leaves (N, ...), or (N, d_pad)
    a: torch.Tensor      # push-sum normalizing weights, (N,)

    @property
    def y(self) -> PyTree:
        """The corrected values s / a (Eq. 10)."""
        return correct(self.s, self.a)


def init_push_sum(s: PyTree, n_nodes: int, device) -> PushSumState:
    return PushSumState(s=s, a=torch.ones((n_nodes,), dtype=torch.float32,
                                          device=device))


def _mix_dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j w[i, j] x[j] over the leading node axis."""
    flat = x.reshape(x.shape[0], -1)
    return (w.to(x.dtype) @ flat).reshape(x.shape)


def _mix_circulant(offsets: Sequence[int], weights: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Receiver i sums w_k x[(i - k) mod N]: roll(+k) brings i-k to slot i."""
    out = weights[0].to(x.dtype) * torch.roll(x, offsets[0], dims=0)
    for k, off in enumerate(offsets[1:], start=1):
        out = out + weights[k].to(x.dtype) * torch.roll(x, off, dims=0)
    return out


def sparse_mix(idx: torch.Tensor, vals: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """Padded-CSR mix ``out[i] = sum_k vals[i, k] x[idx[i, k]]`` over the
    leading node axis of ``x`` (any trailing shape); the output takes its
    leading dim from ``idx``. The slots are added in storage order
    (ascending senders, zero-weight pads), one gather-and-add a slot."""
    flat = x.reshape(x.shape[0], -1)
    out = kref.spmm(idx, vals, flat)
    return out.reshape((idx.shape[0],) + tuple(x.shape[1:]))


def _kernel_mix_dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    rows = x.reshape(x.shape[0], -1).contiguous()
    return kops.pushsum_mix(w, rows).reshape(x.shape)


def _kernel_mix_sparse(idx: torch.Tensor, vals: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    return kops.leaf_out(kops.spmm(idx, vals, kops.leaf_rows(x)), x)


def gossip_dense(state: PushSumState, w: torch.Tensor, *,
                 use_kernels: bool = False) -> PushSumState:
    """One mixing round of a tree state with an (N, N) weight matrix;
    ``use_kernels``: one ``pushsum_mix`` launch a leaf."""
    mix = _kernel_mix_dense if use_kernels else _mix_dense
    with phase(PHASE_PUSHSUM_MIX):
        return PushSumState(s=tree_map(lambda x: mix(w, x), state.s),
                            a=_mix_dense(w, state.a))


def gossip_circulant(state: PushSumState, offsets: Sequence[int],
                     weights: torch.Tensor) -> PushSumState:
    """One mixing round of a tree state on a circulant topology: a weighted
    sum of rolls along the node axis."""
    offsets = tuple(int(o) for o in offsets)
    with phase(PHASE_PUSHSUM_MIX):
        return PushSumState(
            s=tree_map(lambda x: _mix_circulant(offsets, weights, x),
                       state.s),
            a=_mix_circulant(offsets, weights, state.a))


def gossip_sparse(state: PushSumState, idx: torch.Tensor,
                  vals: torch.Tensor, *,
                  use_kernels: bool = False) -> PushSumState:
    """One mixing round of a tree state over a padded-CSR edge list;
    ``use_kernels``: one ``spmm`` launch a leaf (its rows padded to a
    multiple of 4 columns where they are not)."""
    mix = _kernel_mix_sparse if use_kernels else sparse_mix
    with phase(PHASE_PUSHSUM_MIX):
        return PushSumState(s=tree_map(lambda x: mix(idx, vals, x), state.s),
                            a=sparse_mix(idx, vals, state.a))


def gossip_packed(state: PushSumState, *, w: torch.Tensor | None = None,
                  offsets: Sequence[int] | None = None,
                  weights: torch.Tensor | None = None,
                  sparse_idx: torch.Tensor | None = None,
                  sparse_vals: torch.Tensor | None = None,
                  use_kernels: bool = False) -> PushSumState:
    """Eq. 9 over the packed (N, d_pad) buffer: one mix per round, by
    ``offsets`` (circulant), ``sparse_idx``/``sparse_vals`` (sparse) or
    ``w`` (dense)."""
    buf = state.s
    with phase(PHASE_PUSHSUM_MIX):
        if offsets is not None:
            offsets = tuple(int(o) for o in offsets)
            if weights is None:
                weights = torch.full((len(offsets),), 1.0 / len(offsets),
                                     dtype=torch.float32, device=buf.device)
            return PushSumState(s=_mix_circulant(offsets, weights, buf),
                                a=_mix_circulant(offsets, weights, state.a))
        if sparse_idx is not None:
            s_new = (kops.spmm(sparse_idx, sparse_vals, buf) if use_kernels
                     else sparse_mix(sparse_idx, sparse_vals, buf))
            return PushSumState(
                s=s_new, a=sparse_mix(sparse_idx, sparse_vals, state.a))
        if w is None:
            raise ValueError("gossip_packed() needs w=, offsets= or "
                             "sparse_idx=/sparse_vals=")
        s_new = (kops.pushsum_mix(w, buf) if use_kernels
                 else _mix_dense(w, buf))
        return PushSumState(s=s_new, a=_mix_dense(w, state.a))


def gossip(state: PushSumState, *, w: torch.Tensor | None = None,
           offsets: Sequence[int] | None = None,
           weights: torch.Tensor | None = None,
           use_kernels: bool = False) -> PushSumState:
    """One mixing round of a tree state on the schedule given: circulant
    ``offsets`` (``weights`` default to 1 / len(offsets)) or the dense
    ``w``, whose ``use_kernels`` route is :func:`gossip_dense`'s."""
    if offsets is not None:
        if weights is None:
            weights = torch.full((len(offsets),), 1.0 / len(offsets),
                                 dtype=torch.float32, device=state.a.device)
        return gossip_circulant(state, offsets, weights)
    if w is None:
        raise ValueError("gossip() needs either w= or offsets=")
    return gossip_dense(state, w, use_kernels=use_kernels)


def correct(s: PyTree, a: torch.Tensor) -> PyTree:
    """Push-sum correction y_i = s_i / a_i (paper Eq. 10)."""
    return tree_map(
        lambda x: x / a.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype), s)


def consensus_error(s: torch.Tensor | PyTree, *, a: torch.Tensor | None = None,
                    chunk: int | None = None) -> torch.Tensor:
    """max_i ||y_i - y_bar||_1 over the flat rows, y = s / a (or s).

    ``s`` is a tree or a 2-D (N, d) row buffer. ``chunk`` sweeps the
    columns of a 2-D buffer in blocks so the temporaries stay at
    (N, chunk) — the per-node L1 norms add across blocks.
    """
    if not isinstance(s, torch.Tensor):
        rows = [x.reshape(x.shape[0], -1) for x in tree_leaves(s)]
        s = rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)
    n, d = s.shape
    step = d if chunk is None else max(1, int(chunk))
    total = torch.zeros((n,), dtype=torch.float32, device=s.device)
    for c0 in range(0, d, step):
        block = s[:, c0:c0 + step]
        if a is not None:
            block = block / a[:, None].to(block.dtype)
        total += (block - block.mean(dim=0, keepdim=True)).abs().sum(dim=1)
    return total.max()
