"""Sharded protocol execution: the node axis over the ranks of a mesh, port
of ``repro.engine.shard``.

Each rank of the mesh's gossip axis holds the contiguous block of B = N /
shards node rows ``[rank B, (rank + 1) B)`` (:mod:`repro_torch.launch.
sharding` cuts a global state into it and gathers it back) and runs
:func:`repro_torch.engine.rounds.run_dpps` / ``run_partpsp`` over it. The
engine packs inside each rank, as the reference packs inside the
``shard_map`` body: a rank's (B, d_pad) buffer is what crosses the wire.
Each gossip schedule lowers to its natural collective:

* dense     — the paper-faithful baseline: an all-gather of the buffer
  (and of ``a``) into (N, d_pad), then the rank's rows of W against it,
  ``ops.pushsum_mix(W[rows], full)`` (O(N d_s) wire bytes a round);
* sparse    — the same all-gather, then the rank's receivers' padded-CSR
  rows, ``ops.spmm(idx[rows], vals[rows], full)``: the wire bytes of dense,
  O(edges / shards d_s) local work; static plans only;
* circulant — each static offset k a global roll of the block-sharded
  node axis: whole-block point-to-point exchanges plus one boundary
  exchange (``batch_isend_irecv``; O(d d_s) wire bytes a round, d the
  union out-degree). An exchange whose peer is the rank itself (a world of
  one) is a local copy, as the reference's self-``ppermute`` is.

Node-axis reductions (the sensitivity max of Alg. 1 line 4, the sync
average, the scalar metrics) become ``all_reduce``s over the gossip group
through :class:`repro_torch.core.dpps.NodeOps`: ``MAX`` / ``MIN``, and for
the means a ``SUM`` divided by the node count (gloo has no ``AVG``), so
every scalar row leaves a call already reduced, the same on every rank. A
world of one rank still issues its all-gathers and all-reduces.

Noise: the port keys its Philox stream by the global node (each rank
passes ``node0 = rank B`` down to the draw), so a rank's noise is the same
rows of the single-card draw, bit for bit, and a sharded run equals the
single-card engine's where the arithmetic is the same. The reference
instead folds the key by the shard index, so its shards' noise differs
from its single-device run's.

Rejected, as in the reference: ``sensitivity_mode="real"`` (O(N^2)
pairwise distances across ranks), a node count that does not divide over
the shards, fault-masked plans, wire codecs and the bf16 wire, delays, and
meshes with more than one gossip axis. Per-node series
(``sensitivity_local``, ``loss_per_node``) and transcript-tap series are
dropped from the trajectory. A call needs an initialised process group:
there is no fallback to the single-card engine.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core.dpps import DPPSConfig, DPPSState, NodeOps
from repro_torch.core.partpsp import PartPSPConfig, PartPSPState
from repro_torch.core.pushsum import PushSumState, sparse_mix
from repro_torch.core.tree_utils import PyTree, tree_map
from repro_torch.engine import rounds as _rounds
from repro_torch.engine.plan import ProtocolPlan
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import n_gossip_nodes
from repro_torch.launch.sharding import (_charge_on_meta, all_gather_rows,
                                         gossip_axis)

__all__ = [
    "sharded_node_ops",
    "sharded_gossip_builder",
    "shard_run_dpps",
    "shard_run_partpsp",
]

# Per-node metric trajectories are dropped under sharding (scalar metrics
# are all-reduced and the same on every rank). Transcript-tap series are
# per-node wire recordings and are dropped the same way: the audit lab runs
# on the single-card engine.
_PER_NODE_METRICS = ("sensitivity_local", "loss_per_node")


def _drop_unsharded(traj: dict[str, Any]) -> dict[str, Any]:
    for name in _PER_NODE_METRICS:
        traj.pop(name, None)
    for name in [k for k in traj if k.startswith("tap_")]:
        traj.pop(name)
    return traj


def _gossip_axis(mesh) -> tuple[Any, int, int]:
    """(process group, shard count, this rank's index) of the mesh's one
    gossip axis."""
    name = gossip_axis(mesh)
    if not dist.is_initialized():
        raise RuntimeError("the sharded engine needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    return mesh.get_group(name), n_gossip_nodes(mesh), \
        mesh.get_local_rank(name)


def sharded_node_ops(group, n_nodes: int) -> NodeOps:
    """NodeOps whose reductions span every rank of ``group`` (``n_nodes``
    nodes in all): one ``all_reduce`` each (``group`` None on meta: each
    charged to the cost count, the dry run's rank of a data dim)."""
    def reduce(x: torch.Tensor, op) -> torch.Tensor:
        if group is None:
            _charge_on_meta(x, "all-reduce")
        else:
            dist.all_reduce(x, op=op, group=group)
        return x

    op = dist.ReduceOp
    return NodeOps(
        vmax=lambda x: reduce(x.max(), op.MAX),
        vmin=lambda x: reduce(x.min(), op.MIN),
        vmean=lambda x: reduce(x.sum(), op.SUM) / n_nodes,
        leaf_mean=lambda x: reduce(x.sum(dim=0, keepdim=True),
                                   op.SUM) / n_nodes,
    )


def _exchange(x: torch.Tensor, shifts: list[int], group, n_shards: int,
              rank: int) -> list[torch.Tensor]:
    """For each shift q: the block of the rank q places before this one
    (every rank sends its block q ranks on), all in one batch of
    point-to-point ops; a shift with no peer (q = 0 mod shards) is ``x``."""
    x = x.contiguous()
    out, ops = [], []
    for q in shifts:
        if q % n_shards == 0:
            out.append(x)
            continue
        recv = torch.empty_like(x)
        dst = dist.get_global_rank(group, (rank + q) % n_shards)
        src = dist.get_global_rank(group, (rank - q) % n_shards)
        ops += [dist.P2POp(dist.isend, x, dst, group),
                dist.P2POp(dist.irecv, recv, src, group)]
        out.append(recv)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _sharded_roll(x: torch.Tensor, shift: int, group, n_shards: int,
                  rank: int) -> torch.Tensor:
    """Global roll by static ``shift`` of a block-sharded leading axis.

    Rank d holds rows [d L, (d + 1) L). Decompose shift = q L + r: the bulk
    is a whole-block exchange by q, the remainder r a boundary exchange
    with the next block over.
    """
    block = x.shape[0]
    q, r = divmod(shift % (block * n_shards), block)
    if r == 0:
        return _exchange(x, [q], group, n_shards, rank)[0]
    bulk, prev = _exchange(x, [q, q + 1], group, n_shards, rank)
    return torch.cat([prev[block - r:], bulk[:block - r]], dim=0)


def _dense_rows(w_rows: torch.Tensor, full: torch.Tensor,
                use_kernels: bool) -> torch.Tensor:
    """The rank's receivers ``W[rows] @ full`` over the leading node axis,
    as ``core.pushsum`` mixes the whole network (its plain matmul over the
    flat (N, -1) rows, or one ``pushsum_mix`` launch)."""
    flat = full.reshape(full.shape[0], -1)
    out = (kops.pushsum_mix(w_rows, flat.contiguous()) if use_kernels
           else w_rows.to(full.dtype) @ flat)
    return out.reshape((w_rows.shape[0],) + tuple(full.shape[1:]))


def _sparse_rows(idx: torch.Tensor, vals: torch.Tensor, full: torch.Tensor,
                 use_kernels: bool) -> torch.Tensor:
    """The rank's receivers' padded-CSR rows against the gathered senders,
    as ``core.pushsum`` mixes the whole network."""
    if not use_kernels:
        return sparse_mix(idx, vals, full)
    return kops.leaf_out(kops.spmm(idx, vals, kops.leaf_rows(full)), full)


def sharded_gossip_builder(plan: ProtocolPlan, group, n_shards: int,
                           rank: int) -> Callable:
    """Per-round ``gossip_fn`` factory: receives the round's mixing operands
    (``plan.mix_at(t)``) and returns the collective mix ``dpps_step``
    plugs in at Eq. 9, over a rank's row block (``s`` a packed buffer or
    a tree of leaves, and ``a``)."""
    kernels = plan.use_kernels

    def gossip(mix_leaf, mix_a):
        def gossip_fn(push: PushSumState) -> PushSumState:
            return PushSumState(s=tree_map(mix_leaf, push.s), a=mix_a(push.a))

        return gossip_fn

    if plan.schedule == "circulant":
        offsets = plan.offsets

        def builder(mix):
            wts = mix["mix_weights"]

            def mix_leaf(x):
                out = wts[0].to(x.dtype) * _sharded_roll(
                    x, offsets[0], group, n_shards, rank)
                for k, off in enumerate(offsets[1:], start=1):
                    out = out + wts[k].to(x.dtype) * _sharded_roll(
                        x, off, group, n_shards, rank)
                return out

            return gossip(mix_leaf, mix_leaf)

        return builder

    def rows_of(t: torch.Tensor, block: int) -> torch.Tensor:
        return t[rank * block:(rank + 1) * block]

    if plan.schedule == "sparse":

        def builder(mix):
            idx, vals = mix["sparse_idx"], mix["sparse_vals"]  # (N, K)

            def mixer(use_kernels):
                def mix_leaf(x):
                    block = x.shape[0]
                    return _sparse_rows(
                        rows_of(idx, block), rows_of(vals, block),
                        all_gather_rows(x, group, n_shards), use_kernels)

                return mix_leaf

            return gossip(mixer(kernels), mixer(False))

        return builder

    def builder(mix):
        w = mix["w"]  # (N, N)

        def mixer(use_kernels):
            def mix_leaf(x):
                return _dense_rows(rows_of(w, x.shape[0]),
                                   all_gather_rows(x, group, n_shards),
                                   use_kernels)

            return mix_leaf

        return gossip(mixer(kernels), mixer(False))

    return builder


def _plan_nodes(plan: ProtocolPlan) -> int | None:
    """The plan's node count where its operands carry it (dense, sparse)."""
    if plan.ws is not None:
        return int(plan.ws.shape[-1])
    if plan.sparse_idx is not None:
        return int(plan.sparse_idx.shape[1])
    return None


def _check_cfg(cfg: DPPSConfig, n_nodes: int, n_shards: int,
               plan: ProtocolPlan | None = None) -> None:
    if cfg.sensitivity_mode == "real":
        raise ValueError("sensitivity_mode='real' is experiments-only and "
                         "unsupported under sharding")
    if n_nodes % n_shards != 0:
        raise ValueError(f"node count {n_nodes} must divide evenly over "
                         f"{n_shards} gossip shards")
    if plan is not None and plan.dynamic:
        raise NotImplementedError(
            "fault injection (ProtocolPlan.dynamic / faults=) is not "
            "implemented for the sharded engine: per-round masking and "
            "column renormalization need a global view of each sender's "
            "surviving mass, which the collective gossip path never "
            "materializes. Run fault studies on the single-device engine — "
            "schedule='sparse' masks the edge list there without ever "
            "stacking dense (T, N, N) weights; *static* sparse plans (no "
            "faults) shard fine.")
    codec = None if plan is None else plan.wire
    if codec is not None:
        raise NotImplementedError(
            f"wire codec {codec.name!r} (ProtocolPlan.wire / wire=) is not "
            "implemented for the sharded engine: the codec's per-node "
            "encode (and its error-feedback residual) runs on the packed "
            "(N, d_s) buffer, which the shard_map body builds per shard "
            "while the all-gathered gossip operand crosses shards "
            "unencoded. Run wire-compression studies on the "
            "single-device engine.")


def _setup(mesh, plan: ProtocolPlan, cfg: DPPSConfig, block: int) -> dict:
    """The private seams of ``engine.rounds`` for this rank, after the
    checks."""
    group, n_shards, rank = _gossip_axis(mesh)
    n_nodes = _plan_nodes(plan) or block * n_shards
    _check_cfg(cfg, n_nodes, n_shards, plan)
    if block * n_shards != n_nodes:
        raise ValueError(f"the state holds {block} node rows; a rank's "
                         f"block of {n_nodes} nodes over {n_shards} shards "
                         f"is {n_nodes // n_shards} (launch.sharding."
                         "shard_rows cuts it)")
    return dict(_gossip_builder=sharded_gossip_builder(plan, group,
                                                       n_shards, rank),
                _node_ops=sharded_node_ops(group, n_nodes),
                _node0=rank * block)


def shard_run_dpps(mesh, state: DPPSState,
                   eps_at: Callable[[int], PyTree] | None, *,
                   cfg: DPPSConfig, plan: ProtocolPlan, rounds: int,
                   seed: int = 0, bits_at=None
                   ) -> tuple[DPPSState, dict[str, torch.Tensor]]:
    """:func:`repro_torch.engine.rounds.run_dpps` over this rank's row
    block of the state (``launch.sharding.shard_rows``); ``eps_at(t)`` and
    ``bits_at(t)`` give the block's rows. Returns the block's final state
    and the trajectory of reduced scalar rows, the same on every rank."""
    seams = _setup(mesh, plan, plan.resolve_dpps(cfg), state.push.a.shape[0])
    final, traj = _rounds.run_dpps(state, eps_at, cfg=cfg, plan=plan,
                                   rounds=rounds, seed=seed, bits_at=bits_at,
                                   **seams)
    return final, _drop_unsharded(traj)


def shard_run_partpsp(mesh, state: PartPSPState, batch_at, *,
                      cfg: PartPSPConfig, partition, loss_fn,
                      plan: ProtocolPlan, rounds: int, seed: int = 0,
                      bits_at=None
                      ) -> tuple[PartPSPState, dict[str, torch.Tensor]]:
    """:func:`repro_torch.engine.rounds.run_partpsp` over this rank's row
    block; ``batch_at(t)`` gives the block's node rows of round t's batch
    (``data.NodeShardedLoader`` with a mesh yields them)."""
    seams = _setup(mesh, plan, plan.resolve_dpps(cfg.dpps),
                   state.dpps.push.a.shape[0])
    final, traj = _rounds.run_partpsp(
        state, batch_at, cfg=cfg, partition=partition, loss_fn=loss_fn,
        plan=plan, rounds=rounds, seed=seed, bits_at=bits_at, **seams)
    return final, _drop_unsharded(traj)
