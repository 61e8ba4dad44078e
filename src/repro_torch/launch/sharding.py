"""What a rank holds: ``repro.launch.sharding``'s node half (the node rows
of a protocol state) and the serving half of its model axis.

The reference turns a model's PartitionSpec trees into ``NamedSharding``
trees: train-state leaves are node-stacked, their node dim over the gossip
axes and their other dims after the model pspec ("model" for heads, ffn,
experts); batches shard their node dim the same way; serving places
consensus params and caches by the model pspec.

For training the port shards the node axis (:mod:`repro_torch.engine.
shard`): each rank of the mesh's gossip axis holds
the contiguous block of rows ``[rank B, (rank + 1) B)``, B = N / shards, of
every node-stacked leaf (a tensor of at least one dimension: the protocol
states keep no other), and every 0-d tensor and host scalar (``c_prime``,
``lam``, ``t``) whole on every rank. :func:`train_state_shardings` and
:func:`train_batch_shardings` give that layout as a tree of row slices
(``None``: replicated); :func:`shard_rows` cuts a global tree into a
rank's rows by it, and :func:`gather_rows` gathers a rank's rows back into
the global tree over the gossip group.

The model half, for serving: :func:`serve_param_shardings` and
:func:`serve_cache_shardings` give the reference's pspecs applied by rank
(:mod:`repro_torch.models.parallel`): each leaf a tuple of (dim, slice)
pairs, or ``None`` for a leaf the rank holds whole; :func:`shard_params`
cuts the whole model's parameters (the port's own, or
``convert.transformer_params_from_reference``'s) into the rank's part,
and :func:`gather_params` gathers the parts back over the model group.
A ``mesh`` here is a ``DeviceMesh`` of ("data", "model") dims, or what
:func:`repro_torch.launch.mesh.as_model_axis` takes. The model pspecs of
the train state (DPPS over model-sharded leaves) are not ported (ROADMAP
item 11b's remainder).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.tree_utils import (PyTree, tree_flatten,
                                         tree_flatten_with_path,
                                         tree_unflatten)
from repro_torch.launch.mesh import as_model_axis, gossip_axes, n_gossip_nodes

__all__ = ["node_rows", "train_state_shardings", "train_batch_shardings",
           "shard_rows", "gather_rows", "all_gather_rows", "gossip_axis",
           "serve_param_shardings", "serve_cache_shardings", "shard_params",
           "gather_params"]


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


# -- the model axis (serving) ---------------------------------------------------

def _rank_model(model, mesh):
    """``model``'s architecture as rank ``mesh`` of its model axis."""
    from repro_torch.models.transformer import Transformer

    return Transformer(model.cfg, axis=as_model_axis(mesh))


def _nest(flat: dict) -> dict:
    """{"a/b": x, ...} -> {"a": {"b": x}, ...}."""
    out: dict = {}
    for path, x in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return out


def serve_param_shardings(model, mesh) -> dict:
    """The parameter tree of what this rank holds: (dim, slice) pairs, or
    ``None`` for a leaf held whole."""
    return _nest(_rank_model(model, mesh).param_shards())


def serve_cache_shardings(model, mesh, *, batch: int, capacity: int,
                          shard_seq: bool = False) -> dict:
    """The cache tree (``batch`` sequences, ``capacity`` slots) of what
    this rank holds: its batch rows over "data" (the reference's
    ``batch_axis="data"``) and its KV heads (the reference replicates KV
    unless 16 divides K). ``shard_seq`` with a data dim above 1 raises
    ``NotImplementedError``."""
    return _nest(_rank_model(model, mesh).cache_shards(
        batch, capacity, shard_seq=shard_seq))


def shard_params(params: PyTree, mesh, model) -> PyTree:
    """This rank's part of the whole model's ``params``."""
    return _rank_model(model, mesh).shard_params(params)


def gather_params(shards: PyTree, mesh, model) -> PyTree:
    """The whole model's parameters from every rank's :func:`shard_params`
    part (its inverse): one all-gather over the model group a sharded
    leaf, the ranks' blocks joined in rank order, each replicated KV head
    taken once. Every rank of the group calls it."""
    from repro_torch.models.parallel import ModelAxis

    rank_model = _rank_model(model, mesh)
    axis = rank_model.axis
    if axis.size == 1:
        return shards
    per_rank = [
        _rank_model(model, ModelAxis(size=axis.size, rank=r)).param_shards()
        for r in range(axis.size)]
    pairs, treedef = tree_flatten_with_path(shards)
    out = []
    for path, x in pairs:
        if per_rank[0][path] is None:
            out.append(x)
            continue
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x.contiguous(), group=axis.group)
        starts = [sh[path][0][1].start for sh in per_rank]
        keep = [part for r, part in enumerate(parts)  # a replicated head once
                if starts.index(starts[r]) == r]
        out.append(torch.cat(keep, dim=per_rank[0][path][0][0]))
    return tree_unflatten(treedef, out)
