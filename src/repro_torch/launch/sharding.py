"""What a rank holds: ``repro.launch.sharding``'s node half (the node rows
of a protocol state) and its model axis, for serving and for training.

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
:func:`repro_torch.launch.mesh.as_model_axis` takes.

The model half of the train state: :func:`train_state_pspecs` gives the
reference's specs (its ``prepend_axes(pspec, gossip)`` of every
node-stacked leaf; the (N,) vectors over the gossip axes; the scalars
replicated) as tuples; :func:`train_state_shardings` with ``model=``
gives them applied by rank: each node-stacked leaf's (dim, slice) pairs,
its node rows first, then its model block (the node dim counted);
:func:`shard_train_state` cuts a global state (the port's, or a
converted reference state) into the rank's part, and
:func:`gather_train_state` gathers the parts back (every rank calls it);
:func:`train_columns` gives each shared leaf's wire columns and whether
this rank counts them (:class:`repro_torch.core.dpps.ColumnOps`).
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
           "serve_param_shardings", "serve_cache_shardings", "shard_cache",
           "shard_params",
           "gather_params", "train_state_pspecs", "shard_train_state",
           "gather_train_state", "train_state_blocks", "train_columns"]


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


def train_state_shardings(state: PyTree, mesh, model=None,
                          partition=None) -> PyTree:
    """A ``PartPSPState`` (or ``DPPSState``)-shaped tree of what this rank
    holds: the row slice of each node-stacked leaf, ``None`` for the
    replicated scalars. The state is the global one (N rows). With
    ``model`` (a ``Transformer``) and ``partition`` (a ``PartPSPState``
    of its parameters), each node-stacked leaf's (dim, slice) pairs
    instead: ``(0, rows)``, then its block over "model" (the reference's
    ``prepend_axes(pspec, gossip)`` applied by rank)."""
    rows = node_rows(mesh, _node_count(state))
    leaves, treedef = tree_flatten(state)
    if model is None:
        return tree_unflatten(treedef, [rows if _is_node_leaf(x) else None
                                        for x in leaves])
    blocks = iter(train_state_blocks(state, model, mesh, partition))
    return tree_unflatten(treedef, [
        ((0, rows),) + next(blocks) if _is_node_leaf(x) else None
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
    group has one rank; ``group`` None on meta: charged, not issued (the
    dry run's rank of a data dim)."""
    full = x.new_empty((n_shards * x.shape[0],) + tuple(x.shape[1:]))
    if group is None:  # the dry run's rank of a data dim: charged on meta
        _charge_on_meta(x, "all-gather")
        return full
    # all_gather_into_tensor: torch 2.11 has no all_gather_single, and
    # torch 2.13 keeps the older name (deprecated) as a call to it
    dist.all_gather_into_tensor(full, x.contiguous(), group=group)
    return full


def _charge_on_meta(x: torch.Tensor, kind: str) -> None:
    """Charge one collective of ``kind`` on ``x`` to the active cost count
    (a rank without a process group: the dry run's, on meta only)."""
    from repro_torch.core import loops

    if not x.is_meta:
        raise RuntimeError("a data dim of more than one rank needs a "
                           "process group (launch.mesh)")
    loops.charge_collective(kind, x.numel() * x.element_size())


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
    unless 16 divides K); with ``shard_seq`` (the reference's
    ``seq_axis="data"``, a decode of global batch 1) its block of each KV
    leaf's slots over "data" in place of batch rows (a ``ValueError``
    where they do not divide), the recurrent states whole over "data"."""
    return _nest(_rank_model(model, mesh).cache_shards(
        batch, capacity, shard_seq=shard_seq))


def shard_cache(cache: PyTree, mesh, model, *, batch: int, capacity: int,
                shard_seq: bool = False) -> PyTree:
    """This rank's part of a whole model's (``batch``, ``capacity``)
    cache, by :func:`serve_cache_shardings` (a prefill's cache cut to be
    decoded sequence-sharded: the reference has no sequence-sharded
    prefill): new tensors, a leaf held whole copied too (a decode writes
    its cache in place)."""
    from repro_torch.models.parallel import take

    shards = _rank_model(model, mesh).cache_shards(batch, capacity,
                                                    shard_seq=shard_seq)
    pairs, treedef = tree_flatten_with_path(cache)
    return tree_unflatten(treedef, [
        x.clone() if shards[p] is None else take(x, shards[p])
        for p, x in pairs])


def shard_params(params: PyTree, mesh, model) -> PyTree:
    """This rank's part of the whole model's ``params``."""
    return _rank_model(model, mesh).shard_params(params)


def _block_of(pairs) -> slice:
    """A model block's run of its dim (each half's, for a ``Halves``)."""
    sl = pairs[0][1]
    return slice(sl.start, sl.stop)


def _gather_model(x: torch.Tensor, per_rank: list, axis) -> torch.Tensor:
    """The whole leaf from every model rank's block ``x``: an all-reduce
    over "model" of a zero-filled whole leaf into which each rank writes
    the part of its block that no earlier rank holds
    (:func:`~repro_torch.models.parallel.owned_runs`: a KV head several
    ranks hold is written once), exact for blocks of any sizes, empty
    ones too (each half of the dim for a ``Halves`` block). ``per_rank``
    is each rank's (dim, slice) pair of the leaf (None: held whole)."""
    from repro_torch.models.parallel import Halves, owned_runs

    if per_rank[0] is None:
        return x
    (dim, sl), = per_rank[axis.rank]
    runs = [_block_of(pairs) for pairs in per_rank]
    own = owned_runs(runs)[axis.rank]
    width = max(r.stop for r in runs)
    halves = isinstance(sl, Halves)
    shape = list(x.shape)
    shape[dim] = 2 * width if halves else width
    full = x.new_zeros(shape)
    src, dst = x, full
    if halves:
        src, dst, dim = x.unflatten(dim, (2, -1)), full.unflatten(
            dim, (2, -1)), dim + 1
    n = own.stop - own.start
    dst.narrow(dim, own.start, n).copy_(src.narrow(dim, own.start - sl.start,
                                                   n))
    dist.all_reduce(full, group=axis.group)
    return full


def _per_rank_shards(model, axis) -> list[dict]:
    """Each model rank's ``param_shards`` (rank r of ``axis.size``)."""
    from repro_torch.models.parallel import ModelAxis

    return [_rank_model(model, ModelAxis(size=axis.size, rank=r))
            .param_shards() for r in range(axis.size)]


def gather_params(shards: PyTree, mesh, model) -> PyTree:
    """The whole model's parameters from every rank's :func:`shard_params`
    part (its inverse): one all-gather over the model group a sharded
    leaf, the ranks' blocks joined in rank order, each replicated KV head
    taken once. Every rank of the group calls it."""
    axis = _rank_model(model, mesh).axis
    if axis.size == 1:
        return shards
    per_rank = _per_rank_shards(model, axis)
    pairs, treedef = tree_flatten_with_path(shards)
    return tree_unflatten(treedef, [
        _gather_model(x, [sh[path] for sh in per_rank], axis)
        for path, x in pairs])


# -- the model axis (training) ---------------------------------------------------

def _shifted(pairs) -> tuple:
    """(dim, slice) pairs of a parameter, its dims counted after a node
    dim."""
    return tuple((dim + 1, sl) for dim, sl in pairs or ())


def _is_param_path(path: str) -> bool:
    """A state leaf that is a parameter leaf (a shared or a local one), not
    ``a`` or a sensitivity vector."""
    return path.startswith((".dpps/.push/.s/", ".local/"))


def _state_blocks(state, per_leaf: list) -> list:
    """``per_leaf`` (one value a parameter leaf, in the partition's leaf
    order) as the state's node-stacked leaves take it: its shared leaves'
    values, then its local leaves'; ``()`` for ``a`` and the (N,)
    vectors."""
    blocks = iter(per_leaf)
    return [next(blocks) if _is_param_path(p) else ()
            for p, x in tree_flatten_with_path(state)[0] if _is_node_leaf(x)]


def train_state_blocks(state, model, mesh, partition) -> list:
    """This rank's model block of each node-stacked leaf of ``state`` (in
    leaf order), as (dim, slice) pairs counted after the node dim; ``mesh``
    as :func:`repro_torch.launch.mesh.as_model_axis` takes it (a
    ``ModelAxis`` names a rank without a process group)."""
    shards = _rank_model(model, mesh).param_shards()
    shared, local = partition.split_static(
        [_shifted(shards[path]) for path, _ in partition.leaf_plans()])
    return _state_blocks(state, shared + local)


def train_state_pspecs(model, partition, mesh) -> dict:
    """The reference's ``train_state_shardings(model, partition, mesh)``
    as spec tuples, by the state's leaf paths (``.dpps/.push/.s/0``, ...,
    :func:`repro_torch.core.tree_utils.tree_flatten_with_path`'s): each
    parameter leaf its pspec after the gossip axes, ``a`` and the (N,)
    sensitivity vectors over the gossip axes, the scalars replicated."""
    from repro_torch.models.transformer import _spec_paths

    gax = gossip_axes(mesh)
    head = gax if len(gax) > 1 else gax[0]
    specs = _spec_paths(model.param_pspecs())
    shared, local = partition.split_static(
        [(head,) + tuple(specs[path]) for path, _ in partition.leaf_plans()])
    out = {f".dpps/.push/.s/{i}": spec for i, spec in enumerate(shared)}
    out.update({".dpps/.push/.a": (head,), ".dpps/.sens/.s_local": (head,),
                ".dpps/.sens/.prev_noise_l1": (head,),
                ".dpps/.sens/.c_prime": (), ".dpps/.sens/.lam": (),
                ".dpps/.t": ()})
    out.update({f".local/{i}": spec for i, spec in enumerate(local)})
    return out


def shard_train_state(state: PyTree, mesh, model, partition) -> PyTree:
    """This rank's part of a global ``PartPSPState`` (N rows, the whole
    model's leaves): its node rows (:func:`node_rows`) of its model
    blocks of each node-stacked leaf (new tensors,
    ``models.parallel.take``), the scalars as they are."""
    from repro_torch.models.parallel import take

    rows = node_rows(mesh, _node_count(state))
    blocks = iter(train_state_blocks(state, model, mesh, partition))
    leaves, treedef = tree_flatten(state)
    return tree_unflatten(treedef, [
        take(x, ((0, rows),) + next(blocks)) if _is_node_leaf(x) else x
        for x in leaves])


def gather_train_state(state: PyTree, mesh, model, partition) -> PyTree:
    """The global state from every rank's :func:`shard_train_state` part:
    each parameter leaf's model blocks gathered over "model"
    (:func:`gather_params`'s rule), then every node-stacked leaf's rows
    over the gossip axis (:func:`gather_rows`). Every rank of the mesh
    calls it."""
    axis = _rank_model(model, mesh).axis
    if axis.size > 1:
        per_rank = _per_rank_shards(model, axis)
        shared, local = partition.split_static(
            [[_shifted(sh[path]) or None for sh in per_rank]
             for path, _ in partition.leaf_plans()])
        blocks = iter(_state_blocks(state, shared + local))
        leaves, treedef = tree_flatten(state)
        state = tree_unflatten(treedef, [
            _gather_model(x, next(blocks) or [None], axis)
            if _is_node_leaf(x) else x for x in leaves])
    return gather_rows(state, mesh)


def train_columns(model, partition, axis) -> tuple[list, list]:
    """(counted, col_maps) of each shared leaf of rank ``axis`` (a
    ``ModelAxis``) of ``model``'s architecture: which of the leaf's
    columns this rank counts in a per-node norm (columns several ranks
    hold, a replicated leaf's or a KV head's that two ranks' query heads
    read, count on the first of them): True (all), False (none), or a
    slice of the leaf's last dim (a run of KV heads whose first another
    rank counts); and its wire columns in the whole model's wire row
    (``kernels.ref.ColumnMap``: the whole leaf's first column, and the
    rank's block of it; for Mamba2's ``w_in`` (a ``Halves`` block) one map
    of the leaf viewed as (..., d, 2, d_inner): runs of the rank's heads'
    columns, a stride of d_inner)."""
    import math

    from repro_torch.kernels.ref import ColumnMap
    from repro_torch.models.parallel import Halves, owned_runs
    from repro_torch.models.transformer import Transformer

    whole = {p: tuple(x.shape) for p, x in tree_flatten_with_path(
        Transformer(model.cfg).init(torch.Generator(), device="meta"))[0]}
    per_rank = _per_rank_shards(model, axis)
    counted, col_maps, col0 = [], [], 0
    for path, action in partition.leaf_plans():
        if action == "local":
            continue
        shape = whole[path]
        if isinstance(action, tuple):  # the shared layers [:k]
            shape = (int(action[1]),) + shape[1:]
        pairs = per_rank[axis.rank][path]
        if pairs is None:
            counted.append(axis.rank == 0)
            col_maps.append(ColumnMap(col0, 1, 1))
            col0 += math.prod(shape)
            continue
        runs = [_block_of(sh[path]) for sh in per_rank]
        mine, own = runs[axis.rank], owned_runs(runs)[axis.rank]
        dim, sl = pairs[0]
        if own == mine or mine.stop == mine.start:
            counted.append(True)
        elif own.stop == own.start:
            counted.append(False)
        else:  # KV heads: the leaf's last dim
            assert dim == len(shape) - 1, (path, dim)
            counted.append(slice(own.start - mine.start,
                                 own.stop - mine.start))
        trail = math.prod(shape[dim + 1:])
        width = shape[dim] // 2 if isinstance(sl, Halves) else shape[dim]
        run = (sl.stop - sl.start) * trail
        if run == 0:  # a rank without heads holds none of the leaf
            col_maps.append(ColumnMap(col0, 1, 1))
        elif dim == 0:  # a block of the leading dim: a run of columns
            col_maps.append(ColumnMap(col0 + sl.start * trail, 1, 1))
        else:
            col_maps.append(ColumnMap(col0, run, width * trail,
                                      sl.start * trail))
        col0 += math.prod(shape)
    return counted, col_maps
