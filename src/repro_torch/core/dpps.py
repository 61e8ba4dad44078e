"""DPPS — Differentially Private Perturbed Push-Sum (paper Algorithm 1),
port of ``repro.core.dpps``.

Callers supply the round's perturbation ``eps`` (PartPSP: ``-gamma_s *
clipped shared gradient``; consensus: zero) and one round does

  1. perturb              s^(t+1/2) = s^(t) + eps^(t)                 (Eq. 7)
  2. sensitivity estimate S_i recursion, S = max_i S_i (1 scalar)     (Eq. 22)
  3. noise                s_noise = s^(t+1/2) + gamma_n Lap(0, S/b)   (Eq. 8)
  4. gossip               s <- W s_noise ; a <- W a                   (Eq. 9)
  5. correct              y = s / a                                   (Eq. 10)

over the packed (N, d_pad) buffer of :class:`repro_torch.core.packing.
PackedLayout`, or, with ``layout=None``, over the tree of node-stacked
leaves (the pytree runtime, the reference's oracle and its per-round loop
driver's path). With ``cfg.use_kernels`` the per-round passes are CUDA
kernels (``l1_norm_rows``, ``dpps_perturb_rows``, and ``pushsum_mix`` on
the dense schedule or ``spmm`` on the sparse one), once over the buffer
or once a leaf; otherwise their plain versions, which compute the same
thing. The noise of both runtimes, on both routes, is the same Philox row:
the pytree runtime's plain draw is one flat draw over the wire row
(:func:`repro_torch.core.privacy.noise_wire`), its kernel route draws each
leaf's wire columns (``ops.dpps_perturb_tree``).

The round counter ``DPPSState.t`` is a host integer, so the ``t == 0``
sensitivity init and the sync schedule are decided on the host with no
device sync; the noise scale ``S / b`` stays a 0-d device tensor that the
kernel reads through its pointer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import torch

from repro_torch.core.packing import PackedLayout
from repro_torch.core.privacy import noise_wire
from repro_torch.core.pushsum import (
    PushSumState,
    consensus_error,
    correct,
    gossip_circulant,
    gossip_dense,
    gossip_packed,
    gossip_sparse,
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
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
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
    # The message mass in flight under bounded delays (a repro_torch.net.
    # Mailbox, attached when the plan carries an active DelayModel). The
    # empty default adds no tree leaves, so synchronous states and their
    # checkpoints are unchanged.
    mail: Any = ()


def dpps_init(s0: PyTree, cfg: DPPSConfig) -> DPPSState:
    """Fresh state over node-stacked values ``s0`` (round 0)."""
    leaf = tree_leaves(s0)[0]
    n = leaf.shape[0]
    zeros = torch.zeros((n,), dtype=torch.float32, device=leaf.device)
    return DPPSState(push=init_push_sum(s0, n, leaf.device),
                     sens=init_sensitivity(s0, zeros, c_prime=cfg.c_prime,
                                           lam=cfg.lam),
                     t=0)


def _bits_row(bits, leaves) -> torch.Tensor | None:
    """One uint32 tensor a leaf as the (N, d_s) wire row."""
    if bits is None:
        return None
    return torch.cat([b.reshape(x.shape[0], -1)
                      for b, x in zip(bits, leaves)], dim=1)


def dpps_step(
    state: DPPSState,
    eps: torch.Tensor | PyTree,
    cfg: DPPSConfig,
    layout: PackedLayout | None = None,
    *,
    w: torch.Tensor | None = None,
    offsets: Sequence[int] | None = None,
    mix_weights: torch.Tensor | None = None,
    sparse_idx: torch.Tensor | None = None,
    sparse_vals: torch.Tensor | None = None,
    seed: int = 0,
    bits: torch.Tensor | Sequence[torch.Tensor] | None = None,
    return_s_half: bool = False,
    return_wire_stats: bool = False,
    gossip_fn: Callable[[PushSumState], PushSumState] | None = None,
    mechanism: Any = None,
    tap: Any = None,
) -> tuple[DPPSState, dict[str, Any]]:
    """One DPPS round. Returns (new state, diag).

    With ``layout`` (the packed runtime) ``state.push.s`` is the (N, d_pad)
    buffer and ``eps`` an (N, d_pad) buffer or the shared leaf tree (packed
    here). With ``layout=None`` (the pytree runtime) both are trees of
    node-stacked leaves. The noise bits of round ``t`` are Philox of
    ``(seed, t)`` unless ``bits`` is given: the (N, d_s) uint32 wire row
    (packed runtime) or one uint32 tensor a leaf (pytree runtime). ``w``
    (dense), ``offsets`` (+ ``mix_weights``, circulant) or ``sparse_idx``
    + ``sparse_vals`` (sparse, (N, K) padded CSR) must match
    ``cfg.schedule``, unless ``gossip_fn`` is given: it then replaces the
    built-in mix of a round that is not a sync round, taking the noised
    ``PushSumState`` (the async mailbox, ``repro_torch.net.DelayModel.
    open_round``, is one).

    ``return_s_half`` adds the perturbed pre-noise state ``s^(t+1/2)``
    under ``s_half`` (the buffer, or the tree); ``return_wire_stats`` the
    watchdog's ``wd_nonfinite`` (non-finite wire entries), ``wd_mass_drift``
    (``|mean(a) - 1|``) and ``wd_consensus_residual`` (the corrected
    iterates' consensus error). ``mechanism`` and ``tap``, the audit lab's
    seams, are not ported yet.
    """
    if mechanism is not None or tap is not None:
        raise NotImplementedError(
            "dpps_step(mechanism=, tap=): the audit lab's noise mechanisms "
            "and transcript tap are not ported yet (ROADMAP Queue 1 item 9)")
    packed = layout is not None
    s = state.push.s
    n = state.push.a.shape[0]
    t = state.t
    sens = state.sens
    noised = cfg.noise and cfg.gamma_n > 0
    need_s_half = (return_s_half or cfg.sensitivity_mode == "real"
                   or not noised)

    # -- 1. perturb (Eq. 7): the fused kernel below forms s + eps; the eps
    # norm is needed first, since the noise scale depends on it.
    if packed:
        k = kops if cfg.use_kernels else kref
        d_s = layout.d_s
        eps_buf = eps if isinstance(eps, torch.Tensor) else layout.pack(eps)
        eps_l1 = k.l1_norm_rows(eps_buf, d_s)
        s_half = s + eps_buf if need_s_half else None
        s_norm = lambda: k.l1_norm_rows(s, d_s)
    else:
        s_leaves, treedef = tree_flatten(s)
        eps_leaves = tree_leaves(eps)
        norm = kops.l1_norm_tree if cfg.use_kernels else l1_norm_per_node
        eps_l1 = norm(eps_leaves)
        s_half = (tree_unflatten(treedef, [x + e for x, e in
                                           zip(s_leaves, eps_leaves)])
                  if need_s_half or not cfg.use_kernels else None)
        s_norm = lambda: norm(s_leaves)

    # -- 2. sensitivity estimate (Eq. 22 / Remark 1) -------------------------
    if t == 0:
        s_local = 2.0 * sens.c_prime * (s_norm() + eps_l1)
    else:
        s_local = sens.lam * sens.s_local + 2.0 * sens.c_prime * (
            eps_l1 + sens.lam * cfg.gamma_n * sens.prev_noise_l1)
    s_net = s_local.max()
    if cfg.sensitivity_mode == "real":
        s_used = real_sensitivity(layout.wire_slice(s_half) if packed
                                  else s_half)
    elif cfg.sensitivity_mode == "fixed":
        s_used = torch.tensor(cfg.fixed_sensitivity, dtype=torch.float32,
                              device=state.push.a.device)
    else:
        s_used = s_net

    # -- 3. Laplace noise (Eq. 8, Lemma 1), fused with the perturb add -------
    if not noised:
        s_noise = s_half
        noise_l1 = torch.zeros((n,), dtype=torch.float32,
                               device=state.push.a.device)
    elif packed:
        s_noise, _, noise_l1 = k.dpps_perturb_rows(
            s, eps_buf, s_used / cfg.b, cfg.gamma_n, d_s, bits=bits,
            seed=seed, t=t)
    elif cfg.use_kernels:
        out, _, noise_l1 = kops.dpps_perturb_tree(
            s_leaves, eps_leaves, s_used / cfg.b, cfg.gamma_n,
            bits=bits, seed=seed, t=t)
        s_noise = tree_unflatten(treedef, out)
    else:
        noise = noise_wire(s_half, s_used / cfg.b,
                           bits=_bits_row(bits, s_leaves), seed=seed, t=t)
        noise_l1 = l1_norm_per_node(noise)
        s_noise = tree_map(lambda h, z: h + cfg.gamma_n * z.to(h.dtype),
                           s_half, noise)

    # -- 4. gossip (Eq. 9), or the full synchronization (paper SIII.C) --------
    if is_sync_round(t, cfg.sync_interval):
        # Exact averaging of the noised parameters, per leaf view, and a
        # restart of the recursion. The mix of this round would be thrown
        # away, so it is not run.
        means = tree_map(lambda x: x.mean(dim=0, keepdim=True),
                         layout.view_tree(s_noise) if packed else s_noise)
        mean_l1 = l1_norm_per_node(means)                       # (1,)
        bcast = tree_map(lambda m: m.expand((n,) + tuple(m.shape[1:])),
                         means)
        # the packed buffer copies the broadcast views once; a tree state
        # holds each leaf as its own tensor, as the kernels take them
        push_new = PushSumState(
            s=(layout.append_pad(layout.flat_row(bcast), s_noise) if packed
               else tree_map(torch.Tensor.contiguous, bcast)),
            a=torch.ones_like(state.push.a))
        s_local = (2.0 * sens.c_prime * mean_l1).expand(n).clone()
        prev_l1 = torch.zeros_like(noise_l1)
    else:
        push_half = PushSumState(s=s_noise, a=state.push.a)
        if gossip_fn is not None:
            push_new = gossip_fn(push_half)
        elif cfg.schedule == "circulant":
            if offsets is None:
                raise ValueError("circulant schedule requires offsets=")
            if packed:
                push_new = gossip_packed(push_half, offsets=offsets,
                                         weights=mix_weights)
            else:
                if mix_weights is None:
                    mix_weights = torch.full(
                        (len(offsets),), 1.0 / len(offsets),
                        dtype=torch.float32, device=state.push.a.device)
                push_new = gossip_circulant(push_half, offsets, mix_weights)
        elif cfg.schedule == "sparse":
            if sparse_idx is None or sparse_vals is None:
                raise ValueError(
                    "sparse schedule requires sparse_idx=/sparse_vals=")
            push_new = (gossip_packed(push_half, sparse_idx=sparse_idx,
                                      sparse_vals=sparse_vals,
                                      use_kernels=cfg.use_kernels)
                        if packed else
                        gossip_sparse(push_half, sparse_idx, sparse_vals,
                                      use_kernels=cfg.use_kernels))
        else:
            if w is None:
                raise ValueError("dense schedule requires w=")
            push_new = (gossip_packed(push_half, w=w,
                                      use_kernels=cfg.use_kernels)
                        if packed else
                        gossip_dense(push_half, w,
                                     use_kernels=cfg.use_kernels))
        prev_l1 = noise_l1

    new_state = state._replace(
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
    if return_wire_stats:
        # The watchdog's inputs (repro.obs.watchdog in the reference):
        # judged on the host at segment boundaries.
        diag["wd_nonfinite"] = sum(
            (~torch.isfinite(x)).sum().to(torch.int32)
            for x in tree_leaves(s_noise))
        diag["wd_mass_drift"] = (push_new.a.mean() - 1.0).abs()
        diag["wd_consensus_residual"] = consensus_error(push_new.s,
                                                        a=push_new.a)
    if return_s_half:
        diag["s_half"] = s_half
    return new_state, diag


def dpps_consensus(state: DPPSState) -> PyTree:
    """The protocol output s-bar (Alg. 1 Output): node mean of corrected y."""
    return node_mean(correct(state.push.s, state.push.a))
