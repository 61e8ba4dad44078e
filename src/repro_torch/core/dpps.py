"""DPPS — Differentially Private Perturbed Push-Sum (paper Algorithm 1),
port of ``repro.core.dpps`` (packed path).

Callers supply the round's perturbation ``eps`` (PartPSP: ``-gamma_s *
clipped shared gradient``; consensus: zero) and one round does

  1. perturb              s^(t+1/2) = s^(t) + eps^(t)                 (Eq. 7)
  2. sensitivity estimate S_i recursion, S = max_i S_i (1 scalar)     (Eq. 22)
  3. noise                s_noise = s^(t+1/2) + gamma_n Lap(0, S/b)   (Eq. 8)
  4. gossip               s <- W s_noise ; a <- W a                   (Eq. 9)
  5. correct              y = s / a                                   (Eq. 10)

over the packed (N, d_pad) buffer of :class:`repro_torch.core.packing.
PackedLayout`. With ``cfg.use_kernels`` the per-round passes are CUDA
kernels (``l1_norm_rows``, ``dpps_perturb_rows``, and ``pushsum_mix`` on
the dense schedule or ``spmm`` on the sparse one); otherwise their plain
versions, which compute the same thing.

The round counter ``DPPSState.t`` is a host integer, so the ``t == 0``
sensitivity init and the sync schedule are decided on the host with no
device sync; the noise scale ``S / b`` stays a 0-d device tensor that the
kernel reads through its pointer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.core.packing import PackedLayout
from repro_torch.core.pushsum import (
    PushSumState,
    correct,
    gossip_packed,
    init_push_sum,
)
from repro_torch.core.sensitivity import (
    SensitivityState,
    init_sensitivity,
    real_sensitivity,
)
from repro_torch.core.tree_utils import (
    PyTree,
    l1_norm_per_node,
    node_mean,
    tree_leaves,
    tree_map,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

__all__ = ["DPPSConfig", "DPPSState", "dpps_init", "dpps_step",
           "dpps_consensus", "is_sync_round"]


def is_sync_round(t: int, sync_interval: int) -> bool:
    """Whether round ``t`` ends with a full synchronization (paper SIII.C)."""
    return sync_interval > 0 and (t + 1) % sync_interval == 0


@dataclasses.dataclass(frozen=True)
class DPPSConfig:
    """Protocol hyperparameters (paper Alg. 1 inputs + deployment switches)."""

    b: float = 5.0            # privacy budget hyperparameter
    gamma_n: float = 1.0      # noise rate (round is b/gamma_n - DP)
    c_prime: float = 0.78     # C' in Eq. (11)
    lam: float = 0.55         # lambda in Eq. (11)
    noise: bool = True        # False => plain Perturbed Push-Sum (SGP)
    sync_interval: int = 0    # full sync every k rounds; 0 = never
    schedule: str = "dense"   # "dense" | "circulant" | "sparse"
    use_kernels: bool = False # the CUDA kernels instead of plain versions
    # "estimated" (Remark 1), "real" (exact, O(N^2 d)), "fixed" (constant)
    sensitivity_mode: str = "estimated"
    fixed_sensitivity: float = 0.0

    def __post_init__(self):
        if self.schedule not in ("dense", "circulant", "sparse"):
            raise ValueError(f"unknown or unported schedule {self.schedule!r}")
        if self.sensitivity_mode not in ("estimated", "real", "fixed"):
            raise ValueError(f"unknown sensitivity_mode {self.sensitivity_mode!r}")
        if self.noise and self.b <= 0:
            raise ValueError("privacy budget b must be > 0")
        if self.gamma_n < 0:
            raise ValueError("gamma_n must be >= 0")

    @property
    def epsilon_per_round(self) -> float:
        if not self.noise or self.gamma_n == 0:
            return float("inf")
        return self.b / self.gamma_n


class DPPSState(NamedTuple):
    push: PushSumState
    sens: SensitivityState
    t: int  # host-side round counter


def dpps_init(s0: PyTree, cfg: DPPSConfig) -> DPPSState:
    """Fresh state over node-stacked values ``s0`` (round 0)."""
    leaf = tree_leaves(s0)[0]
    n = leaf.shape[0]
    zeros = torch.zeros((n,), dtype=torch.float32, device=leaf.device)
    return DPPSState(push=init_push_sum(s0, n, leaf.device),
                     sens=init_sensitivity(s0, zeros, c_prime=cfg.c_prime,
                                           lam=cfg.lam),
                     t=0)


def dpps_step(
    state: DPPSState,
    eps: torch.Tensor | PyTree,
    cfg: DPPSConfig,
    layout: PackedLayout,
    *,
    w: torch.Tensor | None = None,
    offsets: Sequence[int] | None = None,
    mix_weights: torch.Tensor | None = None,
    sparse_idx: torch.Tensor | None = None,
    sparse_vals: torch.Tensor | None = None,
    seed: int = 0,
    bits: torch.Tensor | None = None,
) -> tuple[DPPSState, dict[str, Any]]:
    """One DPPS round over the packed state. Returns (new state, diag).

    ``state.push.s`` is the (N, d_pad) buffer; ``eps`` is an (N, d_pad)
    buffer or the shared leaf tree (packed here). The noise bits of round
    ``t`` are Philox of ``(seed, t)`` unless ``bits`` (N, d_s) uint32 is
    given. ``w`` (dense), ``offsets`` (+ ``mix_weights``, circulant) or
    ``sparse_idx`` + ``sparse_vals`` (sparse, (N, K) padded CSR) must match
    ``cfg.schedule``.
    """
    k = kops if cfg.use_kernels else kref
    s = state.push.s
    n = state.push.a.shape[0]
    t = state.t
    d_s = layout.d_s
    sens = state.sens
    eps_buf = eps if isinstance(eps, torch.Tensor) else layout.pack(eps)

    # -- 1. perturb (Eq. 7): the fused kernel below forms s + eps; the eps
    # norm is needed first, since the noise scale depends on it.
    eps_l1 = k.l1_norm_rows(eps_buf, d_s)
    noised = cfg.noise and cfg.gamma_n > 0
    s_half = s + eps_buf if (not noised or cfg.sensitivity_mode == "real") else None

    # -- 2. sensitivity estimate (Eq. 22 / Remark 1) -------------------------
    if t == 0:
        s_local = 2.0 * sens.c_prime * (k.l1_norm_rows(s, d_s) + eps_l1)
    else:
        s_local = sens.lam * sens.s_local + 2.0 * sens.c_prime * (
            eps_l1 + sens.lam * cfg.gamma_n * sens.prev_noise_l1)
    s_net = s_local.max()
    if cfg.sensitivity_mode == "real":
        s_used = real_sensitivity(layout.wire_slice(s_half))
    elif cfg.sensitivity_mode == "fixed":
        s_used = torch.tensor(cfg.fixed_sensitivity, dtype=torch.float32,
                              device=s.device)
    else:
        s_used = s_net

    # -- 3. Laplace noise (Eq. 8, Lemma 1), fused with the perturb add -------
    if noised:
        s_noise, _, noise_l1 = k.dpps_perturb_rows(
            s, eps_buf, s_used / cfg.b, cfg.gamma_n, d_s, bits=bits,
            seed=seed, t=t)
    else:
        s_noise = s_half
        noise_l1 = torch.zeros((n,), dtype=torch.float32, device=s.device)

    # -- 4. gossip (Eq. 9), or the full synchronization (paper SIII.C) --------
    if is_sync_round(t, cfg.sync_interval):
        # Exact averaging of the noised parameters, per leaf view, and a
        # restart of the recursion. The mix of this round would be thrown
        # away, so it is not run.
        means = tree_map(lambda x: x.mean(dim=0, keepdim=True),
                         layout.view_tree(s_noise))
        mean_l1 = l1_norm_per_node(means)                       # (1,)
        bcast = tree_map(lambda m: m.expand((n,) + tuple(m.shape[1:])), means)
        push_new = PushSumState(
            s=layout.append_pad(layout.flat_row(bcast), s_noise),
            a=torch.ones_like(state.push.a))
        s_local = (2.0 * sens.c_prime * mean_l1).expand(n).clone()
        prev_l1 = torch.zeros_like(noise_l1)
    else:
        push_half = PushSumState(s=s_noise, a=state.push.a)
        if cfg.schedule == "circulant":
            if offsets is None:
                raise ValueError("circulant schedule requires offsets=")
            push_new = gossip_packed(push_half, offsets=offsets,
                                     weights=mix_weights)
        elif cfg.schedule == "sparse":
            if sparse_idx is None or sparse_vals is None:
                raise ValueError(
                    "sparse schedule requires sparse_idx=/sparse_vals=")
            push_new = gossip_packed(push_half, sparse_idx=sparse_idx,
                                     sparse_vals=sparse_vals,
                                     use_kernels=cfg.use_kernels)
        else:
            if w is None:
                raise ValueError("dense schedule requires w=")
            push_new = gossip_packed(push_half, w=w,
                                     use_kernels=cfg.use_kernels)
        prev_l1 = noise_l1

    new_state = DPPSState(
        push=push_new,
        sens=sens._replace(s_local=s_local, prev_noise_l1=prev_l1),
        t=t + 1)
    diag = {
        "sensitivity_used": s_used,
        "sensitivity_estimate": s_net,
        "sensitivity_local": s_local,
        "eps_l1_max": eps_l1.max(),
        "noise_l1_mean": noise_l1.mean(),
        "a_min": push_new.a.min(),
        "a_max": push_new.a.max(),
    }
    return new_state, diag


def dpps_consensus(state: DPPSState) -> PyTree:
    """The protocol output s-bar (Alg. 1 Output): node mean of corrected y."""
    return node_mean(correct(state.push.s, state.push.a))
