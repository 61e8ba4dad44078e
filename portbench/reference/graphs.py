"""Mixing matrices and the Remark-1 constants of a configuration's graph,
worked out from the graph as the configuration file states it.

* ``dout``: paper Remark 2, node i pushes to i, i + 1, ..., i + d - 1
  (mod N), each message 1 / d of its mass: W[(i + k) % N, i] = 1 / d.
* ``erdos_renyi``: the listed undirected edges with Metropolis weights,
  W[i, j] = 1 / (1 + max(deg_i, deg_j)) on an edge, the diagonal the rest.

:func:`calibrate` is the paper's empirical tuning of (C', lambda): lambda
is the contraction of W on the consensus-orthogonal subspace (its second
largest singular value, clipped to [0.05, 0.995]); C' is the smallest
constant with which the Remark-1 recursion bounds the real sensitivity on
short noiseless runs of normal inputs, times a margin of 1.25 (numpy's
``default_rng(0)`` stream: 3 trials of 50 rounds at width 64).
"""
from __future__ import annotations

import numpy as np


def weights(topology: dict) -> np.ndarray:
    """The (N, N) column-stochastic mixing matrix of ``topology`` (f64)."""
    kind, n = topology["kind"], int(topology["nodes"])
    if kind == "dout":
        d = int(topology["d"])
        w = np.zeros((n, n))
        for i in range(n):
            for k in range(d):
                w[(i + k) % n, i] += 1.0 / d
        return w
    if kind == "erdos_renyi":
        adj = np.zeros((n, n), dtype=bool)
        for i, j in topology["edges"]:
            if i != j:
                adj[i, j] = adj[j, i] = True
        deg = adj.sum(axis=1)
        w = np.zeros((n, n))
        ii, jj = np.nonzero(adj)
        w[ii, jj] = 1.0 / (1.0 + np.maximum(deg[ii], deg[jj]))
        np.fill_diagonal(w, 1.0 - w.sum(axis=1))
        return w
    raise ValueError(f"unknown topology kind {kind!r}")


def contraction(w: np.ndarray) -> float:
    """The largest singular value of W on the subspace orthogonal to the
    all-ones vector: ``||W (I - 11^T / N)||_2``."""
    n = w.shape[0]
    proj = np.eye(n) - np.full((n, n), 1.0 / n)
    return float(np.linalg.svd(w @ proj, compute_uv=False)[0])


def calibrate(w: np.ndarray, *, dim: int = 64, rounds: int = 50,
              trials: int = 3, margin: float = 1.25,
              seed: int = 0) -> tuple[float, float]:
    """(C', lambda) of W (module docstring)."""
    rng = np.random.default_rng(seed)
    n = w.shape[0]
    lam = min(0.995, max(0.05, contraction(w)))
    best = 0.0
    for _ in range(trials):
        s = rng.normal(size=(n, dim))
        eps_scale = 10.0 ** rng.uniform(-2, 0)
        rec = None
        for _ in range(rounds):
            eps = eps_scale * rng.normal(size=(n, dim))
            half = s + eps
            real = np.abs(half[:, None, :] - half[None, :, :]).sum(-1).max()
            eps_l1 = np.abs(eps).sum(axis=1)
            rec = (2.0 * (np.abs(s).sum(axis=1) + eps_l1) if rec is None
                   else lam * rec + 2.0 * eps_l1)
            unit = float(rec.max())
            if unit > 0:
                best = max(best, real / unit)
            s = w @ half
    return float(best * margin), float(lam)


def gamma_limit(c_prime: float, lam: float, b: float, d_s: int) -> float:
    """The Remark-1 recursion's stability limit on gamma_n,
    ``(1 / lambda - 1) b / (2 C' d_s)``: above it the sensitivity estimate
    grows every round."""
    return (1.0 / lam - 1.0) * b / (2.0 * c_prime * d_s)
