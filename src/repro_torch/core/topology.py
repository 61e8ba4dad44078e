"""Decentralized network topologies and doubly-stochastic weight matrices.

Port of ``repro.core.topology`` (numpy there too, so W, the offsets and the
calibrated ``(C', lambda)`` are computed by the same numpy code and match
exactly). The paper (Def. 1) requires every round's W^(t) to be doubly
stochastic with w_ij > 0 iff j sends to i, plus self loops. d-Out and EXP
(Remark 2) are circulant: node i sends to (i + k) mod N for k in a
per-round offset set.

Row convention: ``s_new[i] = sum_j W[i, j] s[j]``. The sparse schedule
reads W as a padded receiver-major edge list (:func:`padded_csr`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "Topology",
    "DOutGraph",
    "ExpGraph",
    "RingGraph",
    "FullyConnectedGraph",
    "TimeVaryingTopology",
    "padded_csr",
    "is_doubly_stochastic",
    "is_strongly_connected_over_window",
    "spectral_gap",
    "effective_contraction",
    "derive_constants",
    "contraction_rate",
    "calibrate_constants",
]


def padded_csr(w: np.ndarray, k: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Dense W -> padded receiver-major CSR ``(idx, vals)``.

    ``idx`` (N, K) int32 names the senders each receiver mixes, ascending
    per row; ``vals`` (N, K) float64 the matching weights. Rows with fewer
    than K in-edges are padded with the receiver's own index and weight 0,
    sorted into place, so every row stays ascending. The sparse mix adds
    the K slots in storage order; in ascending sender order, with the
    zero-weight pads adding exactly 0, it reproduces the dense mix's sum bit
    for bit. ``k`` forces the slot count (at least the max in-degree) so
    the per-round CSRs of a period stack into one (P, N, K) array.
    Port of ``repro.core.topology.padded_csr``; equal to it exactly.
    """
    w = np.asarray(w)
    n = w.shape[0]
    support = [np.nonzero(w[i] > 0.0)[0] for i in range(n)]  # ascending
    need = max((len(s) for s in support), default=0)
    if k is None:
        k = need
    elif k < need:
        raise ValueError(f"k={k} slots cannot hold the max in-degree {need}")
    idx = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, k))
    vals = np.zeros((n, k), dtype=np.float64)
    for i, senders in enumerate(support):
        idx[i, :len(senders)] = senders
        vals[i, :len(senders)] = w[i, senders]
    order = np.argsort(idx, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, axis=1)
    vals = np.take_along_axis(vals, order, axis=1)
    return idx.astype(np.int32), vals


@dataclasses.dataclass(frozen=True)
class Topology:
    """A (possibly time-varying) sequence of directed graphs.

    Subclasses return the circulant offset set of round ``t`` from
    :meth:`offsets` (offset 0 is the self loop); non-circulant ones return
    ``None`` there and override :meth:`weight_matrix`
    (:mod:`repro_torch.net.graphs`).
    """

    n_nodes: int

    def offsets(self, t: int) -> Sequence[int] | None:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement offsets()")

    def out_degree(self, t: int) -> int:
        """Out-neighbours (self loop included) at round ``t``: the offsets'
        count, or for a non-circulant graph the support of W's sender
        columns, which must be the same for every node."""
        offs = self.offsets(t)
        if offs is not None:
            return len(offs)
        degs = (self.weight_matrix(t) > 0.0).sum(axis=0)
        if degs.min() != degs.max():
            raise NotImplementedError(
                f"{type(self).__name__} is non-circulant with irregular "
                f"out-degrees (min {int(degs.min())}, max {int(degs.max())} "
                f"at t={t}); there is no single out_degree — read per-node "
                "degrees off weight_matrix(t) > 0 column sums instead")
        return int(degs[0])

    def weight_matrix(self, t: int) -> np.ndarray:
        """Doubly stochastic W^(t) as float64 numpy (row convention)."""
        offs = self.offsets(t)
        if offs is None:
            raise NotImplementedError(
                f"{type(self).__name__}.offsets() returned None but the "
                "subclass does not override weight_matrix()")
        n = self.n_nodes
        w = 1.0 / len(offs)
        mat = np.zeros((n, n), dtype=np.float64)
        for i in range(n):
            for k in offs:
                # node j = i sends to node (i + k) mod n  =>  receiver row.
                mat[(i + k) % n, i] += w
        return mat

    def edges(self, t: int) -> set[tuple[int, int]]:
        """Directed edge set {(sender, receiver)} at round t, self loops
        included (the audit's curious-neighbour view reads it)."""
        offs = self.offsets(t)
        n = self.n_nodes
        if offs is None:
            # W[i, j] > 0 iff j sends to i (row convention)
            recv, send = np.nonzero(self.weight_matrix(t) > 0.0)
            return {(int(j), int(i)) for i, j in zip(recv, send)}
        return {(i, (i + k) % n) for i in range(n) for k in offs}

    def weight_matrix_torch(self, t: int, *, device=None,
                            dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(self.weight_matrix(t), dtype=dtype,
                               device=device)

    def mixing_weights(self, t: int) -> tuple[tuple[int, ...], np.ndarray]:
        """(offsets, per-offset weights): ``s_new[i] = sum_k w_k s[i - k]``."""
        offs = self.offsets(t)
        if offs is None:
            raise NotImplementedError(
                f"{type(self).__name__} is not circulant; use the dense "
                "schedule")
        offs = tuple(offs)
        return offs, np.full((len(offs),), 1.0 / len(offs), dtype=np.float64)

    def max_in_degree(self, t: int) -> int:
        """Largest per-receiver in-edge count at round t (self loop
        included)."""
        return int((self.weight_matrix(t) > 0.0).sum(axis=1).max())

    def sparse_weights(self, t: int, k: int | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Round t's W as padded CSR (:func:`padded_csr`); ``k`` fixes the
        slot count so the rounds of a period stack."""
        return padded_csr(self.weight_matrix(t), k)


@dataclasses.dataclass(frozen=True)
class DOutGraph(Topology):
    """Paper Remark 2: node i sends to (i+0) ... (i+d-1) mod N each round."""

    d: int = 2

    def __post_init__(self):
        if not (1 <= self.d <= self.n_nodes):
            raise ValueError(
                f"d-Out degree d={self.d} must be in [1, N={self.n_nodes}]")

    def offsets(self, t: int) -> Sequence[int]:
        return tuple(range(self.d))


@dataclasses.dataclass(frozen=True)
class ExpGraph(Topology):
    """Paper Remark 2: i sends to i + 2^(t mod (floor(log2(N-1)) + 1))."""

    def __post_init__(self):
        if self.n_nodes < 2:
            raise ValueError("EXP graph needs N >= 2")

    @property
    def period(self) -> int:
        if self.n_nodes <= 2:
            return 1
        return int(math.floor(math.log2(self.n_nodes - 1))) + 1

    def offsets(self, t: int) -> Sequence[int]:
        k = 2 ** (t % self.period)
        return (0, k % self.n_nodes)


@dataclasses.dataclass(frozen=True)
class RingGraph(Topology):
    """Bidirectional ring: i sends to i +- 1 plus self loop (weight 1/3)."""

    def offsets(self, t: int) -> Sequence[int]:
        if self.n_nodes == 1:
            return (0,)
        if self.n_nodes == 2:
            return (0, 1)
        return (0, 1, self.n_nodes - 1)


@dataclasses.dataclass(frozen=True)
class FullyConnectedGraph(Topology):
    """Complete graph: one gossip round is exact averaging."""

    def offsets(self, t: int) -> Sequence[int]:
        return tuple(range(self.n_nodes))


@dataclasses.dataclass(frozen=True)
class TimeVaryingTopology(Topology):
    """Cycles through a list of topologies (one per round)."""

    schedule: tuple[Topology, ...] = ()

    def __post_init__(self):
        if not self.schedule:
            raise ValueError("schedule must be non-empty")
        for topo in self.schedule:
            if topo.n_nodes != self.n_nodes:
                raise ValueError("all scheduled topologies must share n_nodes")

    @property
    def period(self) -> int:
        """lcm(cycle length, member periods): W^(t + period) == W^(t)."""
        period = len(self.schedule)
        for topo in self.schedule:
            period = math.lcm(period, int(getattr(topo, "period", 1)))
        return period

    def _at(self, t: int) -> Topology:
        return self.schedule[t % len(self.schedule)]

    def offsets(self, t: int) -> Sequence[int] | None:
        return self._at(t).offsets(t)

    def weight_matrix(self, t: int) -> np.ndarray:
        return self._at(t).weight_matrix(t)


def is_doubly_stochastic(mat: np.ndarray, atol: float = 1e-9) -> bool:
    """Square, no entry below -atol, every row and column summing to 1."""
    mat = np.asarray(mat)
    if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
        return False
    if (mat < -atol).any():
        return False
    ones = np.ones(mat.shape[0])
    return bool(np.allclose(mat.sum(axis=0), ones, atol=atol)
                and np.allclose(mat.sum(axis=1), ones, atol=atol))


def is_strongly_connected_over_window(topo: Topology, t0: int,
                                      window: int) -> bool:
    """Assumption 1: the union graph over rounds [t0, t0 + window) is
    strongly connected (reachability by boolean matrix powers)."""
    n = topo.n_nodes
    adj = np.eye(n, dtype=bool)
    for t in range(t0, t0 + window):
        for j, i in topo.edges(t):
            adj[i, j] = True
    reach = adj.copy()
    for _ in range(n):
        reach = reach | (reach @ adj)
    return bool(reach.all())


def spectral_gap(topo: Topology, t: int = 0) -> float:
    """1 - |second eigenvalue| of W^(t)."""
    eig = np.sort(np.abs(np.linalg.eigvals(topo.weight_matrix(t))))[::-1]
    second = eig[1] if len(eig) > 1 else 0.0
    return float(1.0 - second)


def contraction_rate(topo: Topology, *, period: int | None = None) -> float:
    """Worst per-round second singular value of W^(t) over the period."""
    if period is None:
        period = getattr(topo, "period", 1)
    n = topo.n_nodes
    j = np.ones((n, n)) / n
    worst = 0.0
    for t in range(period):
        worst = max(worst, float(np.linalg.norm(topo.weight_matrix(t) - j, 2)))
    return worst


def effective_contraction(topo: Topology, *,
                          period: int | None = None) -> float:
    """Per-round geometric contraction over a full period,
    ``||prod_t W^(t) - J||_2^(1 / period)`` clamped to [1e-4, 0.9999]
    before the root: a time-varying graph need not contract every round,
    its period product does. Equals :func:`contraction_rate` on a static
    graph (within the clamp)."""
    if period is None:
        period = getattr(topo, "period", 1)
    n = topo.n_nodes
    j = np.ones((n, n)) / n
    prod = np.eye(n)
    for t in range(period):
        prod = topo.weight_matrix(t) @ prod
    rate = float(np.linalg.norm(prod - j, 2))
    return min(0.9999, max(1e-4, rate)) ** (1.0 / period)


def derive_constants(
    topo: Topology,
    *,
    safety: float = 1.05,
    lam_floor: float = 0.05,
    lam_ceil: float = 0.995,
) -> tuple[float, float]:
    """A provably-motivated (C', lambda) pair for the Eq. (11) recursion
    (the reference's, which its launch plans take).

    lambda: per-round deviation contraction (second singular value, max over
    the topology's period) with a safety margin. C': sqrt(N) covers the
    L2->L1 node aggregation in Lemma 2's Theorem-1-of-[41] step; the paper
    instead *tunes* C' per setup (0.78/0.95) and validates Esti >= Real
    empirically (Fig. 2) — use :func:`calibrate_constants` to reproduce that.
    """
    lam = min(lam_ceil, max(lam_floor, contraction_rate(topo) * safety))
    c_prime = safety * float(np.sqrt(topo.n_nodes))
    return c_prime, lam


def calibrate_constants(
    topo: Topology,
    *,
    dim: int = 64,
    rounds: int = 50,
    trials: int = 3,
    margin: float = 1.25,
    seed: int = 0,
) -> tuple[float, float]:
    """Empirical (C', lambda) the way the paper tunes them.

    Short noiseless Perturbed Push-Sum traces with random inputs; C' is the
    tightest constant for which the Remark-1 recursion bounds the real
    sensitivity, times ``margin``. Same numpy stream as the reference, so
    the result is identical.
    """
    rng = np.random.default_rng(seed)
    n = topo.n_nodes
    lam = min(0.995, max(0.05, contraction_rate(topo)))
    best_c = 0.0
    for _ in range(trials):
        s = rng.normal(size=(n, dim))
        eps_scale = 10.0 ** rng.uniform(-2, 0)
        s_rec = None
        for t in range(rounds):
            eps = eps_scale * rng.normal(size=(n, dim))
            s_half = s + eps
            real = max(np.abs(s_half[i] - s_half[j]).sum()
                       for i in range(n) for j in range(n))
            eps_l1 = np.abs(eps).sum(axis=1)
            if s_rec is None:
                s_rec = 2.0 * (np.abs(s).sum(axis=1) + eps_l1)
            else:
                s_rec = lam * s_rec + 2.0 * eps_l1
            bound_unit = float(s_rec.max())
            if bound_unit > 0:
                best_c = max(best_c, real / bound_unit)
            s = topo.weight_matrix(t) @ s_half
    return float(best_c * margin), float(lam)
