"""Seeded random and structured topology families beyond the paper's
circulants (port of ``repro.net.graphs``, topologies only).

* :class:`ErdosRenyiGraph`: symmetric G(N, p) with Metropolis weights,
  optionally unioned with a ring backbone so the graph is connected.
* :class:`RandomMatchingGraph`: ``W = (I + P_1 + ... + P_k) / (k + 1)``
  over ``k`` random directed Hamiltonian cycles.
* :class:`SmallWorldGraph`: Watts-Strogatz ring lattice whose long-range
  edges are rewired symmetrically; Metropolis weights.
* :class:`TorusGraph`: 2-D torus grid, degree 4, ``(I + A) / 5``.
* :class:`RandomSequenceTopology`: a seeded family redrawn every round,
  repeating after ``period`` rounds.

Every draw is counter-based: ``weight_matrix(t)`` builds a fresh numpy
generator from ``SeedSequence(seed, spawn_key)``, a pure function of
(seed, t), with the same numpy calls as the reference, so W equals the
reference's exactly for the same seed. None of these is circulant: they
run on the dense or the sparse schedule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.topology import Topology

__all__ = [
    "ErdosRenyiGraph",
    "RandomMatchingGraph",
    "SmallWorldGraph",
    "TorusGraph",
    "RandomSequenceTopology",
    "fold_seed",
    "metropolis_weights",
]


def _rng(seed: int, *counters: int) -> np.random.Generator:
    """Counter-based generator: a pure function of (seed, counters)."""
    return np.random.default_rng(
        np.random.SeedSequence(entropy=int(seed), spawn_key=tuple(counters)))


def fold_seed(seed: int, counter: int) -> int:
    """A child seed of (seed, counter), by SeedSequence's hash."""
    return int(np.random.SeedSequence(
        entropy=int(seed), spawn_key=(int(counter),)).generate_state(1)[0])


def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Doubly stochastic W from a symmetric adjacency (self loops ignored):
    ``W[i, j] = 1 / (1 + max(deg_i, deg_j))`` on edges, the diagonal takes
    the slack and stays >= 1 / (1 + max degree) > 0."""
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    if adj.shape != (n, n):
        raise ValueError(f"adjacency must be square, got {adj.shape}")
    if not (adj == adj.T).all():
        raise ValueError("metropolis_weights needs a symmetric adjacency")
    adj = adj & ~np.eye(n, dtype=bool)
    deg = adj.sum(axis=1)
    w = np.zeros((n, n), dtype=np.float64)
    ii, jj = np.nonzero(adj)
    w[ii, jj] = 1.0 / (1.0 + np.maximum(deg[ii], deg[jj]))
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def _ring_adjacency(n: int) -> np.ndarray:
    adj = np.zeros((n, n), dtype=bool)
    idx = np.arange(n)
    adj[idx, (idx + 1) % n] = True
    adj[(idx + 1) % n, idx] = True
    np.fill_diagonal(adj, False)
    return adj


@dataclasses.dataclass(frozen=True)
class ErdosRenyiGraph(Topology):
    """Symmetric Erdős–Rényi G(N, p), drawn once from ``seed``, with
    Metropolis weights. ``backbone=True`` unions a bidirectional ring so
    the graph is connected at any p."""

    p: float = 0.3
    seed: int = 0
    backbone: bool = True

    def __post_init__(self):
        if self.n_nodes < 2:
            raise ValueError("ErdosRenyiGraph needs N >= 2")
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"edge probability p={self.p} must be in [0, 1]")

    def offsets(self, t: int) -> Sequence[int] | None:
        return None

    def weight_matrix(self, t: int) -> np.ndarray:
        n = self.n_nodes
        rng = _rng(self.seed, 0)
        upper = np.triu(rng.random((n, n)) < self.p, k=1)
        adj = upper | upper.T
        if self.backbone:
            adj |= _ring_adjacency(n)
        return metropolis_weights(adj)


@dataclasses.dataclass(frozen=True)
class RandomMatchingGraph(Topology):
    """Union of ``k`` random directed Hamiltonian cycles plus self loops,
    ``W = (I + P_1 + ... + P_k) / (k + 1)``: doubly stochastic, and
    strongly connected every round."""

    k: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.n_nodes < 2:
            raise ValueError("RandomMatchingGraph needs N >= 2")
        if not (1 <= self.k < self.n_nodes):
            raise ValueError(f"matching count k={self.k} must be in "
                             f"[1, N-1={self.n_nodes - 1}]")

    def offsets(self, t: int) -> Sequence[int] | None:
        return None

    def weight_matrix(self, t: int) -> np.ndarray:
        n = self.n_nodes
        w = np.eye(n, dtype=np.float64)
        for j in range(self.k):
            order = _rng(self.seed, 1, j).permutation(n)
            # order[i] sends to order[i + 1]: one directed n-cycle
            w[np.roll(order, -1), order] += 1.0
        return w / (self.k + 1)


@dataclasses.dataclass(frozen=True)
class SmallWorldGraph(Topology):
    """Watts–Strogatz: ring lattice of ``k`` neighbours a side whose edges
    at lattice offset >= 2 are each rewired, symmetrically, with
    probability ``beta``; the distance-1 ring is kept, so the graph stays
    connected. Metropolis weights."""

    k: int = 2
    beta: float = 0.1
    seed: int = 0

    def __post_init__(self):
        if self.n_nodes < 4:
            raise ValueError("SmallWorldGraph needs N >= 4")
        if not (1 <= self.k <= (self.n_nodes - 1) // 2):
            raise ValueError(
                f"lattice degree k={self.k} must be in [1, (N-1)//2="
                f"{(self.n_nodes - 1) // 2}] for N={self.n_nodes}")
        if not (0.0 <= self.beta <= 1.0):
            raise ValueError(f"rewiring beta={self.beta} must be in [0, 1]")

    def offsets(self, t: int) -> Sequence[int] | None:
        return None

    def weight_matrix(self, t: int) -> np.ndarray:
        n = self.n_nodes
        rng = _rng(self.seed, 2)
        adj = _ring_adjacency(n)
        for off in range(2, self.k + 1):
            for i in range(n):
                j = (i + off) % n
                if rng.random() < self.beta:
                    candidates = np.flatnonzero(~adj[i] & (np.arange(n) != i))
                    if candidates.size:
                        j = int(rng.choice(candidates))
                adj[i, j] = adj[j, i] = True
        return metropolis_weights(adj)


@dataclasses.dataclass(frozen=True)
class TorusGraph(Topology):
    """2-D torus grid (rows x cols = N) with 4-neighbour wraparound links.
    ``rows=0`` takes the most-square factorisation of N."""

    rows: int = 0

    def __post_init__(self):
        rows = self.rows or self._derive_rows(self.n_nodes)
        if rows < 2 or self.n_nodes % rows or self.n_nodes // rows < 2:
            raise ValueError(
                f"TorusGraph needs N = rows x cols with rows, cols >= 2; "
                f"got N={self.n_nodes}, rows={self.rows or rows}")
        object.__setattr__(self, "rows", rows)

    @staticmethod
    def _derive_rows(n: int) -> int:
        for r in range(int(math.isqrt(n)), 1, -1):
            if n % r == 0:
                return r
        return 1

    @property
    def cols(self) -> int:
        return self.n_nodes // self.rows

    def offsets(self, t: int) -> Sequence[int] | None:
        return None

    def weight_matrix(self, t: int) -> np.ndarray:
        n, rows, cols = self.n_nodes, self.rows, self.cols
        adj = np.zeros((n, n), dtype=bool)
        for r in range(rows):
            for c in range(cols):
                i = r * cols + c
                for rr, cc in (((r + 1) % rows, c), ((r - 1) % rows, c),
                               (r, (c + 1) % cols), (r, (c - 1) % cols)):
                    j = rr * cols + cc
                    if j != i:
                        adj[i, j] = adj[j, i] = True
        return metropolis_weights(adj)


@dataclasses.dataclass(frozen=True)
class RandomSequenceTopology(Topology):
    """Redraw a seeded base family every round with the seed
    ``fold_seed(base.seed, t % period)``, repeating after ``period``
    rounds so a plan can stack the period."""

    base: Topology | None = None
    period: int = 8

    def __post_init__(self):
        if self.base is None:
            raise ValueError("RandomSequenceTopology needs a base= topology")
        if not hasattr(self.base, "seed"):
            raise ValueError(
                f"base {type(self.base).__name__} has no seed field; only "
                "seeded random families can be resampled per round")
        if self.base.n_nodes != self.n_nodes:
            raise ValueError(f"base n_nodes={self.base.n_nodes} != wrapper "
                             f"n_nodes={self.n_nodes}")
        if self.period < 1:
            raise ValueError(f"period={self.period} must be >= 1")

    def _at(self, t: int) -> Topology:
        return dataclasses.replace(self.base,
                                   seed=fold_seed(self.base.seed,
                                                  t % self.period))

    def offsets(self, t: int) -> Sequence[int] | None:
        return None

    def weight_matrix(self, t: int) -> np.ndarray:
        return self._at(t).weight_matrix(0)
