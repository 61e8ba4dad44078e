"""Sensitivity estimation for DPPS (paper Lemma 2 / Remark 1), port of
``repro.core.sensitivity``.

Each node i keeps a running scalar estimate

    S_i^(0) = 2 C' (||s_i^(0)||_1 + ||eps_i^(0)||_1)
    S_i^(t) = lambda S_i^(t-1) + 2 C' (||eps_i^(t)||_1 + lambda gamma_n ||n_i^(t-1)||_1)

and the network uses S^(t) = max_i S_i^(t). Only two scalars per node
persist between rounds. ``reset_sensitivity`` restarts the recursion after
a synchronization round; ``real_sensitivity`` computes the exact
max_{i,j} ||s_i - s_j||_1 for validation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.tree_utils import PyTree, l1_norm_per_node, tree_leaves

__all__ = ["SensitivityState", "init_sensitivity", "update_sensitivity",
           "reset_sensitivity", "network_sensitivity", "real_sensitivity"]


class SensitivityState(NamedTuple):
    s_local: torch.Tensor        # (N,) per-node estimates S_i^(t)
    prev_noise_l1: torch.Tensor  # (N,) ||n_i^(t-1)||_1 (zero at t=0)
    c_prime: torch.Tensor        # 0-d f32 constant C'
    lam: torch.Tensor            # 0-d f32 constant lambda


def init_sensitivity(s0: PyTree, eps0_l1: torch.Tensor, *, c_prime: float,
                     lam: float) -> SensitivityState:
    """t = 0 branch of Remark 1."""
    dev = eps0_l1.device
    c = torch.tensor(c_prime, dtype=torch.float32, device=dev)
    s_local = 2.0 * c * (l1_norm_per_node(s0) + eps0_l1)
    return SensitivityState(
        s_local=s_local, prev_noise_l1=torch.zeros_like(s_local), c_prime=c,
        lam=torch.tensor(lam, dtype=torch.float32, device=dev))


def update_sensitivity(state: SensitivityState, eps_l1: torch.Tensor,
                       noise_l1: torch.Tensor, *,
                       gamma_n: float = 1.0) -> SensitivityState:
    """t > 0 branch of Remark 1: ``eps_l1`` is this round's per-node
    ||eps_i^(t)||_1, ``noise_l1`` the ||n_i^(t)||_1 of the noise drawn this
    round (the next round's n^(t-1)). The reference's form leaves out
    gamma_n, which is this one at ``gamma_n=1``; ``dpps_step`` applies the
    round's rate in the same order of operations."""
    s_new = state.lam * state.s_local + 2.0 * state.c_prime * (
        eps_l1 + state.lam * gamma_n * state.prev_noise_l1)
    return state._replace(s_local=s_new, prev_noise_l1=noise_l1)


def reset_sensitivity(state: SensitivityState, s_synced: PyTree,
                      eps_l1: torch.Tensor) -> SensitivityState:
    """Restart the recursion after a synchronization round (the t = 0
    branch over the synced values)."""
    s_local = 2.0 * state.c_prime * (l1_norm_per_node(s_synced) + eps_l1)
    return state._replace(s_local=s_local,
                          prev_noise_l1=torch.zeros_like(s_local))


def network_sensitivity(state: SensitivityState) -> torch.Tensor:
    """S^(t) = max_i S_i^(t), the one-scalar all-reduce of Alg. 1 line 4."""
    return state.s_local.max()


def real_sensitivity(s_half: PyTree | torch.Tensor, *,
                     chunk: int | None = None) -> torch.Tensor:
    """Exact max_{i,j} ||s_i - s_j||_1 (validation only, O(N^2 d)).

    The dense form holds an (N, N, d) difference a leaf; ``chunk`` bounds it
    to (chunk, N, d) by sweeping blocks of ``chunk`` rows, as the
    reference's ``lax.map`` does. Every pairwise distance is reduced the
    same way in both forms, and the max of the block maxima is the max.
    ``chunk=None`` (or ``chunk >= N``) keeps the single-shot form.
    """
    leaves = [s_half] if isinstance(s_half, torch.Tensor) else tree_leaves(s_half)
    flats = [x.reshape(x.shape[0], -1) for x in leaves]
    n = flats[0].shape[0]
    step = n if chunk is None or chunk >= n else max(1, int(chunk))
    best = None
    for i0 in range(0, n, step):
        dist = sum((f[i0:i0 + step, None, :] - f[None, :, :]).abs_().sum(-1)
                   for f in flats)
        block = dist.max()
        best = block if best is None else torch.maximum(best, block)
    return best
