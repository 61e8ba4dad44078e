"""Minimal parameter trees and per-node reductions over them.

The reference keeps parameters as JAX pytrees. The port keeps plain nested
``dict`` / ``list`` / ``tuple`` / ``NamedTuple`` containers of tensors and
flattens them in ``jax.tree_util.tree_flatten`` order (dict keys sorted, a
NamedTuple's fields in field order), because packing offsets depend on the
leaf order. Leaf paths name a dict entry by its key, a list or tuple entry
by its index and a NamedTuple field as jax names a ``GetAttrKey``
(``.dpps``), so a protocol state's leaves carry the reference's names
(``.dpps/.push/.s/0``). Every leaf of node-stacked state carries a leading
node dimension ``N``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

__all__ = [
    "TreeDef",
    "tree_flatten",
    "tree_flatten_with_path",
    "tree_unflatten",
    "tree_leaves",
    "tree_map",
    "l1_norm_per_node",
    "node_mean",
    "tree_l1_norm_per_node",
    "tree_l2_norm_sq_per_node",
    "tree_scale_per_node",
    "tree_add",
    "tree_sub",
    "tree_scale",
    "tree_zeros_like",
    "tree_node_mean",
    "tree_count_params",
    "tree_any_nan",
]

PyTree = Any


class TreeDef(NamedTuple):
    kind: str       # "leaf" | "dict" | "list" | "tuple" | "namedtuple"
    keys: tuple = ()          # dict keys, sorted; a NamedTuple's fields
    children: tuple = ()      # child TreeDefs
    cls: type | None = None   # the NamedTuple class


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def _flatten(tree, path: tuple, out: list) -> TreeDef:
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys, tuple(
            _flatten(tree[k], path + (str(k),), out) for k in keys))
    if _is_namedtuple(tree):
        fields = type(tree)._fields
        return TreeDef("namedtuple", fields, tuple(
            _flatten(x, path + ("." + f,), out)
            for f, x in zip(fields, tree)), type(tree))
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return TreeDef(kind, (), tuple(
            _flatten(x, path + (str(i),), out) for i, x in enumerate(tree)))
    out.append(("/".join(path), tree))
    return TreeDef("leaf")


def tree_flatten_with_path(tree: PyTree) -> tuple[list[tuple[str, Any]], TreeDef]:
    """``[(path, leaf)]`` with ``"/"``-joined key paths, and the tree def."""
    out: list = []
    return out, _flatten(tree, (), out)


def tree_flatten(tree: PyTree) -> tuple[list, TreeDef]:
    pairs, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def tree_leaves(tree: PyTree) -> list:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: TreeDef, leaves) -> PyTree:
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        kids = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.keys, kids))
        if td.kind == "namedtuple":
            return td.cls(*kids)
        return kids if td.kind == "list" else tuple(kids)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree def holds")
    return out


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(x, *ys)
                                    for x, *ys in zip(leaves, *others)])


def counted_part(x: torch.Tensor, keep):
    """The part of node-stacked leaf ``x`` whose columns this rank of a
    model axis counts in a per-node norm (``keep`` one entry of a
    ``counted`` list): all of it (None or True), none (False, or an empty
    leaf: None is returned), or its ``keep`` slice of the last dim (a
    run of KV heads whose first another rank counts)."""
    if keep is False or x[0].numel() == 0:
        return None
    if keep is None or keep is True:
        return x
    return x[..., keep]


def l1_norm_per_node(tree: PyTree, counted=None) -> torch.Tensor:
    """sum over leaves of ||leaf_i||_1 for each node i -> (N,).

    One reduction over the flat wire row (leaf rows concatenated in leaf
    order), as ``repro.core.tree_utils.tree_l1_norm_per_node`` does.
    ``counted`` (one entry a leaf, :func:`counted_part`'s) keeps only the
    columns this rank of a model axis counts (zeros where it counts none).
    """
    leaves = tree_leaves(tree)
    if counted is not None:
        kept = [counted_part(x, keep) for x, keep in zip(leaves, counted)]
        kept = [x for x in kept if x is not None]
        if not kept:
            return torch.zeros((leaves[0].shape[0],), dtype=torch.float32,
                               device=leaves[0].device)
        leaves = kept
    rows = [x.reshape(x.shape[0] if x.dim() else 1, -1) for x in leaves]
    row = rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)
    return row.abs().sum(dim=1)


def node_mean(tree: PyTree) -> PyTree:
    """Average over the leading node dimension (the consensus target)."""
    return tree_map(lambda x: x.mean(dim=0), tree)


# The reference's names: the same functions where the port had them.
tree_l1_norm_per_node = l1_norm_per_node
tree_node_mean = node_mean


def tree_l2_norm_sq_per_node(tree: PyTree) -> torch.Tensor:
    """sum over leaves of ||leaf_i||_2^2 for each node i -> (N,), summed
    leaf by leaf."""
    sq = [x.square().reshape(x.shape[0], -1).sum(dim=1)
          for x in tree_leaves(tree)]
    return sum(sq[1:], start=sq[0])


def tree_scale_per_node(tree: PyTree, scale: torch.Tensor) -> PyTree:
    """Node i's slice of every leaf times ``scale[i]``."""
    return tree_map(lambda x: x * scale.reshape(
        (-1,) + (1,) * (x.dim() - 1)).to(x.dtype), tree)


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_scale(tree: PyTree, scale) -> PyTree:
    """Every leaf times the scalar ``scale``, in the leaf's dtype."""
    return tree_map(lambda x: x * torch.as_tensor(scale, dtype=x.dtype,
                                                  device=x.device), tree)


def tree_zeros_like(tree: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, tree)


def tree_count_params(tree: PyTree, *, per_node: bool = True) -> int:
    """Total element count; with ``per_node`` the node dim is not counted."""
    total = 0
    for x in tree_leaves(tree):
        n = x.numel()
        if per_node and x.dim() >= 1:
            n //= x.shape[0]
        total += n
    return int(total)


def tree_any_nan(tree: PyTree) -> torch.Tensor:
    """A 0-d bool: whether any leaf holds a NaN or an infinity."""
    flags = [(~torch.isfinite(x)).any() for x in tree_leaves(tree)]
    out = flags[0]
    for f in flags[1:]:
        out = out | f
    return out
