"""Which node rows a rank holds: the node half of ``repro.launch.sharding``.

The reference turns a model's PartitionSpec trees into ``NamedSharding``
trees: train-state leaves are node-stacked, their node dim over the gossip
axes and their other dims after the model pspec ("model" for heads, ffn,
experts); batches shard their node dim the same way; serving places
consensus params and caches by the model pspec.

The port shards the node axis only (:mod:`repro_torch.engine.shard`), so
this module holds the node half: each rank of the mesh's gossip axis holds
the contiguous block of rows ``[rank B, (rank + 1) B)``, B = N / shards, of
every node-stacked leaf (a tensor of at least one dimension: the protocol
states keep no other), and every 0-d tensor and host scalar (``c_prime``,
``lam``, ``t``) whole on every rank. :func:`train_state_shardings` and
:func:`train_batch_shardings` give that layout as a tree of row slices
(``None``: replicated); :func:`shard_rows` cuts a global tree into a
rank's rows by it, and :func:`gather_rows` gathers a rank's rows back into
the global tree over the gossip group. The model half (tensor parallelism
inside a node: ``serve_param_shardings``, ``serve_cache_shardings``, the
model pspecs of the train state) is not ported.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.tree_utils import PyTree, tree_flatten, tree_unflatten
from repro_torch.launch.mesh import gossip_axes, n_gossip_nodes

__all__ = ["node_rows", "train_state_shardings", "train_batch_shardings",
           "shard_rows", "gather_rows", "all_gather_rows", "gossip_axis"]


def gossip_axis(mesh) -> str:
    """The mesh's one gossip axis (the sharded engine's scope; the
    reference's message for a mesh with more)."""
    axes = gossip_axes(mesh)
    if len(axes) != 1:
        raise NotImplementedError(
            f"sharded engine supports one gossip axis, mesh has {axes}; "
            "use the auto-sharded jit path (launch/steps.py) for multi-pod")
    return axes[0]


def node_rows(mesh, n_nodes: int) -> slice:
    """The node rows this rank holds of ``n_nodes``: its contiguous block
    along the mesh's gossip axis."""
    axis = gossip_axis(mesh)
    n_shards = n_gossip_nodes(mesh)
    if n_nodes % n_shards != 0:
        raise ValueError(f"node count {n_nodes} must divide evenly over "
                         f"{n_shards} gossip shards")
    block = n_nodes // n_shards
    rank = mesh.get_local_rank(axis)
    return slice(rank * block, (rank + 1) * block)


def _is_node_leaf(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() >= 1


def _node_count(tree: PyTree) -> int:
    counts = {x.shape[0] for x in tree_flatten(tree)[0] if _is_node_leaf(x)}
    if len(counts) != 1:
        raise ValueError(f"node-stacked leaves disagree on N: {counts}")
    return counts.pop()


def train_state_shardings(state: PyTree, mesh) -> PyTree:
    """A ``PartPSPState`` (or ``DPPSState``)-shaped tree of what this rank
    holds: the row slice of each node-stacked leaf, ``None`` for the
    replicated scalars. The state is the global one (N rows)."""
    rows = node_rows(mesh, _node_count(state))
    leaves, treedef = tree_flatten(state)
    return tree_unflatten(treedef, [rows if _is_node_leaf(x) else None
                                    for x in leaves])


def train_batch_shardings(batch: PyTree, mesh) -> PyTree:
    """The row slice of each leaf of a node-stacked batch (leading node
    dim over the gossip axis, the rest whole)."""
    rows = node_rows(mesh, _node_count(batch))
    leaves, treedef = tree_flatten(batch)
    return tree_unflatten(treedef, [rows for _ in leaves])


def shard_rows(tree: PyTree, mesh) -> PyTree:
    """This rank's rows of a global node-stacked tree (a state or a batch):
    each node-stacked leaf's row block (a view), the rest as it is."""
    rows = node_rows(mesh, _node_count(tree))
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [x[rows] if _is_node_leaf(x) else x
                                    for x in leaves])


def all_gather_rows(x: torch.Tensor, group, n_shards: int) -> torch.Tensor:
    """Every rank's ``x`` (B, ...) stacked in rank order -> (n_shards B,
    ...): one all-gather over ``group`` into a fresh tensor, even where the
    group has one rank."""
    full = x.new_empty((n_shards * x.shape[0],) + tuple(x.shape[1:]))
    # all_gather_into_tensor: torch 2.11 has no all_gather_single, and
    # torch 2.13 keeps the older name (deprecated) as a call to it
    dist.all_gather_into_tensor(full, x.contiguous(), group=group)
    return full


def gather_rows(tree: PyTree, mesh) -> PyTree:
    """The global tree of every rank's rows (:func:`shard_rows` undone):
    one all-gather over the gossip group a node-stacked leaf, the
    replicated leaves as they are. Every rank of the group calls it."""
    n_shards = n_gossip_nodes(mesh)
    group = mesh.get_group(gossip_axis(mesh))
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [
        all_gather_rows(x, group, n_shards) if _is_node_leaf(x) else x
        for x in leaves])
