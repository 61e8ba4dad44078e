"""PartPSP — Partial Communication Push-Sum SGD with DP (paper Algorithm 2),
port of ``repro.core.partpsp`` (packed and pytree runtimes).

Per round, for every node i (the node axis is a batch dimension):

  1. l^(t+1) = l^(t) - gamma_l g_l(y^(t), l^(t))          (line 4, Eq. 23)
  2. g_s = clip_L1(grad_s F(y^(t), l^(t+1)), C)           (line 5, Eq. 24)
  3. eps = -gamma_s g_s                                   (line 6, Eq. 25)
  4. a DPPS round on the shared leaves with eps           (Alg. 1)

Baselines (paper SV.D) are the same step under other configs: SGP (share
all, no clip, no noise), SGPDP (share all, DPPS noise), PEDFL (share all,
fixed noise scale 2C).

``loss_fn(params, batch) -> (N,)`` takes node-stacked params and batch and
returns the per-node losses. Every node's loss touches only its own slice,
so one backward over their sum gives every node's gradient.
:func:`node_stacked` makes such a loss of a single-node one (a model's
``loss_fn``), as the reference's ``jax.vmap`` over the nodes does.

Memory: a round holds the local leaves twice (the state's and the
updated ones, since the state is never written in place) and frees each
pass's gradients as soon as they are used.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Sequence

import torch

from repro_torch.core.dpps import (LOCAL_COLUMN_OPS, LOCAL_NODE_OPS,
                                   ColumnOps, DPPSConfig, DPPSState, NodeOps,
                                   dpps_init, dpps_step)
from repro_torch.core.loops import node_loop
from repro_torch.core.packing import PackedLayout
from repro_torch.core.partition import Partition
from repro_torch.core.privacy import PrivacyAccountant, l1_clip_per_node
from repro_torch.core.pushsum import correct
from repro_torch.core.tree_utils import (PyTree, l1_norm_per_node, node_mean,
                                         tree_flatten, tree_unflatten)
from repro_torch.obs.trace import (PHASE_CLIP, PHASE_GRADS_LOCAL,
                                    PHASE_GRADS_SHARED, phase)

__all__ = ["PartPSPConfig", "PartPSPState", "make_baseline_config",
           "partpsp_init", "partpsp_step", "consensus_params", "node_stacked",
           "privacy_summary"]

LossFn = Callable[[PyTree, Any], torch.Tensor]


def node_stacked(loss_fn: Callable) -> LossFn:
    """``(params, batch) -> (N,)`` from a single-node ``loss_fn(params,
    batch) -> scalar``: node i's loss on node i's slice of the node-stacked
    params and batch, stacked over i.

    A Python loop over the nodes stands in for the reference's
    ``jax.vmap(loss_fn)``: ``torch.func.vmap`` does not compose with
    ``torch.utils.checkpoint``, which the transformer's training forward
    runs every layer under. Each leaf is unbound over the nodes once, so
    the backward stacks one gradient for it rather than adding a full-size
    tensor for every node. The loop is :func:`repro_torch.core.loops.
    node_loop` (under a dry run's cost count, its loop rule: node 0 stands
    for all, as the reference's vmapped body is one computation). The
    returned loss takes split layer stacks as
    :class:`repro_torch.core.partition.LayerParts` (``takes_layer_parts``),
    which ``loss_fn`` must read through
    :func:`repro_torch.core.partition.layer_list`.
    """

    def stacked(params: PyTree, batch: Any) -> torch.Tensor:
        p_leaves, p_def = tree_flatten(params)
        b_leaves, b_def = tree_flatten(batch)
        return node_loop(loss_fn, b_leaves[0].shape[0], p_leaves, b_leaves,
                         lambda p, b: (tree_unflatten(p_def, p),
                                       tree_unflatten(b_def, b)))

    stacked.takes_layer_parts = True
    return stacked


@dataclasses.dataclass(frozen=True)
class PartPSPConfig:
    gamma_l: float = 0.05          # local learning rate
    gamma_s: float = 0.05          # shared learning rate
    clip: float = 100.0            # L1 clipping threshold C (0 disables)
    dpps: DPPSConfig = dataclasses.field(default_factory=DPPSConfig)
    algorithm: str = "partpsp"     # partpsp | sgp | sgpdp | pedfl
    # False: the fused single-pass variant (the reference's efficiency
    # option), the shared gradient taken at (y, l_t) in pass 1. Last here
    # (the reference puts it before ``algorithm``), so positional
    # construction keeps its meaning.
    two_pass: bool = True

    def __post_init__(self):
        if self.algorithm not in ("partpsp", "sgp", "sgpdp", "pedfl"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")


def make_baseline_config(
    algorithm: str, *, gamma_l: float = 0.05, gamma_s: float = 0.05,
    clip: float = 100.0, b: float = 1.0, gamma_n: float = 1.0,
    c_prime: float = 0.78, lam: float = 0.55, schedule: str = "dense",
    sync_interval: int = 0, sensitivity_mode: str = "estimated",
) -> PartPSPConfig:
    """The paper's algorithm variants from one knob."""
    common = dict(b=b, c_prime=c_prime, lam=lam, schedule=schedule,
                  sync_interval=sync_interval)
    if algorithm == "sgp":
        dpps = DPPSConfig(gamma_n=0.0, noise=False, **common)
        return PartPSPConfig(gamma_l, gamma_s, 0.0, dpps, "sgp")
    if algorithm == "pedfl":
        # Fixed sensitivity from the parameter-norm clip: two parameter
        # vectors in the L1 ball of radius C are at most 2C apart.
        dpps = DPPSConfig(gamma_n=gamma_n, noise=True,
                          sensitivity_mode="fixed",
                          fixed_sensitivity=2.0 * clip, **common)
        return PartPSPConfig(gamma_l, gamma_s, clip, dpps, "pedfl")
    dpps = DPPSConfig(gamma_n=gamma_n, noise=True,
                      sensitivity_mode=sensitivity_mode, **common)
    return PartPSPConfig(gamma_l, gamma_s, clip, dpps, algorithm)


class PartPSPState(NamedTuple):
    dpps: DPPSState            # push-sum + sensitivity state of the shared leaves
    local: list                # node-stacked local leaves


def partpsp_init(params: PyTree, partition: Partition,
                 cfg: PartPSPConfig) -> PartPSPState:
    shared, local = partition.split(params)
    return PartPSPState(dpps=dpps_init(list(shared), cfg.dpps),
                        local=list(local))


def _grads(loss_fn: LossFn, partition: Partition, shared: Sequence,
           local: Sequence, batch: Any, wrt: Sequence) -> tuple:
    """Per-node losses (N,) and the gradients of their sum w.r.t. ``wrt``
    (leaves of ``shared``/``local`` that require grad)."""
    with torch.enable_grad():
        params = partition.merge(
            shared, local,
            layer_parts=getattr(loss_fn, "takes_layer_parts", False))
        losses = loss_fn(params, batch)
        if not wrt:
            return losses.detach(), []
        grads = torch.autograd.grad(losses.sum(), list(wrt), allow_unused=True)
    return losses.detach(), [torch.zeros_like(x) if g is None else g
                             for x, g in zip(wrt, grads)]


def partpsp_step(
    state: PartPSPState,
    batch: Any,
    *,
    cfg: PartPSPConfig,
    partition: Partition,
    loss_fn: LossFn,
    layout: PackedLayout | None = None,
    w: torch.Tensor | None = None,
    offsets: Sequence[int] | None = None,
    mix_weights: torch.Tensor | None = None,
    sparse_idx: torch.Tensor | None = None,
    sparse_vals: torch.Tensor | None = None,
    seed: int = 0,
    bits: torch.Tensor | Sequence[torch.Tensor] | None = None,
    return_s_half: bool = False,
    return_wire_stats: bool = False,
    gossip_fn: Any = None,
    node_ops: NodeOps = LOCAL_NODE_OPS,
    node0: int = 0,
    mechanism: Any = None,
    tap: Any = None,
    wire_draws: torch.Tensor | None = None,
    noise_draws: torch.Tensor | None = None,
    columns: ColumnOps = LOCAL_COLUMN_OPS,
) -> tuple[PartPSPState, dict[str, Any]]:
    """One PartPSP round: over the packed DPPS state with ``layout``, over
    the list of shared leaves with ``layout=None`` (the pytree runtime).
    ``return_s_half``, ``return_wire_stats``, ``gossip_fn``, ``node_ops``,
    ``node0``, ``mechanism``, ``tap``, ``wire_draws``, ``noise_draws`` and
    ``columns`` go to :func:`repro_torch.core.dpps.dpps_step`;
    ``node_ops`` also reduces ``loss_mean`` and ``grad_l1_max``, and
    ``columns`` makes the clip norm the whole shared vector's over a model
    axis (each rank holding its shards of the leaves; ``loss_fn`` then the
    rank's model's, whose backward sums over "model" itself)."""
    push = state.dpps.push
    y = correct(push.s, push.a)                     # Eq. 10, shared leaves
    if layout is not None:
        y = layout.unpack(y)

    # -- pass 1: local gradient at (y, l_t) (Eq. 5) ---------------------------
    with phase(PHASE_GRADS_LOCAL):
        local_req = [l.detach().requires_grad_(True) for l in state.local]
        if cfg.two_pass:
            losses, g_local = _grads(loss_fn, partition, y, local_req, batch,
                                     local_req)
        else:  # one pass: the shared gradient at (y, l_t) too
            y_req = [v.detach().requires_grad_(True) for v in y]
            losses, g_both = _grads(loss_fn, partition, y_req, local_req,
                                    batch, local_req + y_req)
            g_local, g_shared = g_both[:len(local_req)], g_both[len(local_req):]
            del g_both, y_req
        local_new = []
        for l in state.local:  # each gradient is freed once its leaf is done
            local_new.append(l - cfg.gamma_l * g_local.pop(0).to(l.dtype))
        del local_req

    # -- pass 2: shared gradient at (y, l_{t+1}) (Eq. 6) ----------------------
    with phase(PHASE_GRADS_SHARED):
        if cfg.two_pass:
            y_req = [v.detach().requires_grad_(True) for v in y]
            _, g_shared = _grads(loss_fn, partition, y_req, local_new, batch,
                                 y_req)
            del y_req
        del y

    # -- clip (Eq. 24) and the DPPS perturbation (Eq. 25) ---------------------
    with phase(PHASE_CLIP):
        if cfg.clip > 0:
            g_shared, g_norms = l1_clip_per_node(
                g_shared, cfg.clip, counted=columns.counted,
                col_sum=columns.col_sum)
        else:
            g_norms = columns.col_sum(l1_norm_per_node(g_shared,
                                                       columns.counted))
        eps = [(-cfg.gamma_s * g).to(torch.float32) for g in g_shared]
        del g_shared

    dpps_new, diag = dpps_step(state.dpps, eps, cfg.dpps, layout, w=w,
                               offsets=offsets, mix_weights=mix_weights,
                               sparse_idx=sparse_idx, sparse_vals=sparse_vals,
                               seed=seed, bits=bits,
                               return_s_half=return_s_half,
                               return_wire_stats=return_wire_stats,
                               gossip_fn=gossip_fn, node_ops=node_ops,
                               node0=node0, mechanism=mechanism,
                               tap=tap, wire_draws=wire_draws,
                               noise_draws=noise_draws, columns=columns)
    metrics = {"loss_mean": node_ops.vmean(losses), "loss_per_node": losses,
               "grad_l1_max": node_ops.vmax(g_norms), **diag}
    return PartPSPState(dpps=dpps_new, local=local_new), metrics


def consensus_params(state: PartPSPState, partition: Partition) -> PyTree:
    """Evaluation parameters (paper SV.D): every node gets the network
    average of the shared parameters and keeps its own local ones."""
    push = state.dpps.push
    s_bar = node_mean(correct(push.s, push.a))
    n = push.a.shape[0]
    return partition.merge([x[None].expand((n,) + tuple(x.shape)) for x in s_bar],
                           state.local)


def privacy_summary(cfg: PartPSPConfig, rounds: int) -> dict[str, Any]:
    """The accountant's summary after ``rounds`` rounds of ``cfg``: every
    round is protected where the noise is on at a positive rate, none
    otherwise (sync rounds are not told apart, as in the reference)."""
    acct = PrivacyAccountant(b=cfg.dpps.b, gamma_n=cfg.dpps.gamma_n)
    protected = cfg.dpps.noise and cfg.dpps.gamma_n > 0
    for _ in range(rounds):
        acct = acct.step(protected=protected)
    return acct.summary()
