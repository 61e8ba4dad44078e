"""Partial-communication parameter partition (paper SIII.C, Fig. 1), port
of ``repro.core.partition``.

PartPSP splits the parameter tree into *shared* leaves (gossiped through
DPPS) and *local* leaves (never leave the node). Actions per leaf (first
matching rule wins, ``default`` otherwise): ``"shared"``, ``"local"``, or
``("split_layers", k)`` for layer-stacked leaves (N, L, ...): layers [:k]
shared, [k:] local. Patterns are regexes searched in the leaf's key path
(``"/"``-joined, dict keys sorted, as ``jax.tree_util`` orders them).

``merge(..., layer_parts=True)`` hands a split leaf back as
:class:`LayerParts` (its two parts, uncopied) instead of their
concatenation: a model that walks the layers one by one (the transformer's
training forward) reads each layer from its part, so a training pass makes
no copy of the layer stack and its backward computes no gradient for the
part that does not require one.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence

import torch

from repro_torch.core.tree_utils import (
    PyTree,
    TreeDef,
    tree_flatten_with_path,
    tree_leaves,
    tree_unflatten,
)

__all__ = ["Partition", "LayerParts", "layer_list", "SHARE_ALL",
           "SHARE_NONE"]

Action = Any  # "shared" | "local" | ("split_layers", int)

SHARE_ALL: Sequence[tuple[str, Action]] = ((".*", "shared"),)
SHARE_NONE: Sequence[tuple[str, Action]] = ((".*", "local"),)


class LayerParts:
    """A layer-stacked leaf as consecutive parts along its layer axis (the
    shared layers [:k] and the local [k:] of a ``("split_layers", k)``
    leaf), standing for their concatenation without making it.

    ``layer_axis`` is 1 for a node-stacked leaf (N, L, ...), 0 for one
    node's (L, ...). :meth:`unbind` splits the node axis, as
    ``Tensor.unbind(0)`` would; :func:`layer_list` gives the layers.
    """

    def __init__(self, parts, layer_axis: int = 1):
        self.parts = tuple(parts)
        self.layer_axis = layer_axis

    def unbind(self, dim: int = 0) -> list["LayerParts"]:
        """One node's parts for each node (``dim`` must be the node axis)."""
        if dim != 0 or self.layer_axis != 1:
            raise ValueError("LayerParts.unbind splits the node axis only")
        return [LayerParts(ps, layer_axis=0)
                for ps in zip(*(p.unbind(0) for p in self.parts))]


def layer_list(leaf) -> list[torch.Tensor]:
    """The layers of one node's layer-stacked leaf (L, ...), as views: of
    the tensor, or of each part of a :class:`LayerParts` in order."""
    if isinstance(leaf, LayerParts):
        if leaf.layer_axis != 0:
            raise ValueError("layer_list takes one node's leaf (L, ...)")
        return [layer for part in leaf.parts for layer in part.unbind(0)]
    return list(leaf.unbind(0))


@dataclasses.dataclass(frozen=True)
class _LeafPlan:
    path: str
    action: Action
    shape: tuple[int, ...]


class Partition:
    """Static shared/local split plan over a parameter tree."""

    def __init__(self, treedef: TreeDef, plans: tuple[_LeafPlan, ...]):
        self._treedef = treedef
        self._plans = plans

    @classmethod
    def from_rules(cls, template: PyTree, rules: Sequence[tuple[str, Action]],
                   *, default: Action = "shared") -> "Partition":
        """``template``: node-stacked params (tensors; only shapes are read)."""
        pairs, treedef = tree_flatten_with_path(template)
        compiled = [(re.compile(pat), act) for pat, act in rules]
        plans = []
        for path, leaf in pairs:
            action = default
            for pat, act in compiled:
                if pat.search(path):
                    action = act
                    break
            shape = tuple(leaf.shape)
            if isinstance(action, tuple) and action[0] == "split_layers":
                k = int(action[1])
                if len(shape) < 2:
                    raise ValueError(f"split_layers on non-layer-stacked "
                                     f"leaf {path} shape {shape}")
                if not 0 <= k <= shape[1]:
                    raise ValueError(f"split_layers k={k} out of range for "
                                     f"{path} with L={shape[1]}")
            plans.append(_LeafPlan(path, action, shape))
        return cls(treedef, tuple(plans))

    def split(self, params: PyTree) -> tuple[list, list]:
        """params -> (shared leaves, local leaves). Either may be empty."""
        leaves = tree_leaves(params)
        if len(leaves) != len(self._plans):
            raise ValueError("params do not match the partition template")
        shared, local = [], []
        for leaf, plan in zip(leaves, self._plans):
            if plan.action == "shared":
                shared.append(leaf)
            elif plan.action == "local":
                local.append(leaf)
            else:
                k = plan.action[1]
                shared.append(leaf[:, :k])
                local.append(leaf[:, k:])
        return shared, local

    def leaf_plans(self) -> tuple[tuple[str, Action], ...]:
        """(path, action) of each leaf, in leaf order."""
        return tuple((plan.path, plan.action) for plan in self._plans)

    def split_static(self, values: Sequence) -> tuple[list, list]:
        """Split one static value a leaf (in leaf order; e.g. a spec) as
        :meth:`split` splits the leaves: a split_layers leaf gives its
        value to both sides (a cut along the layer dim changes no spec),
        as the reference's ``split_static`` does."""
        values = list(values)
        if len(values) != len(self._plans):
            raise ValueError("values do not match the partition template")
        shared, local = [], []
        for value, plan in zip(values, self._plans):
            if plan.action != "local":
                shared.append(value)
            if plan.action != "shared":
                local.append(value)
        return shared, local

    def merge(self, shared: Sequence, local: Sequence, *,
              layer_parts: bool = False) -> PyTree:
        """Inverse of :meth:`split`. With ``layer_parts`` a split leaf is
        a :class:`LayerParts` of its two parts, not their concatenation."""
        shared, local = list(shared), list(local)
        si = li = 0
        leaves = []
        for plan in self._plans:
            if plan.action == "shared":
                leaves.append(shared[si])
                si += 1
            elif plan.action == "local":
                leaves.append(local[li])
                li += 1
            else:
                parts = (shared[si], local[li])
                leaves.append(LayerParts(parts) if layer_parts
                              else torch.cat(parts, dim=1))
                si += 1
                li += 1
        if si != len(shared) or li != len(local):
            raise ValueError("leaf counts do not match the partition")
        return tree_unflatten(self._treedef, leaves)

    def d_shared(self, *, per_node: bool = True) -> int:
        """d_s: number of communicated scalars per node."""
        total = 0
        for plan in self._plans:
            n = 1
            for d in plan.shape:
                n *= d
            if per_node and plan.shape:
                n //= plan.shape[0]
            if plan.action == "shared":
                total += n
            elif plan.action != "local":
                k = plan.action[1]
                total += n * k // plan.shape[1] if plan.shape[1] else 0
        return int(total)

    def describe(self) -> str:
        """``d_shared`` and ``d_local``, then a leaf a line: its path, shape
        and action (the reference's text, character for character)."""
        lines = [f"d_shared={self.d_shared():,} d_local={self.d_local():,}"]
        for plan in self._plans:
            lines.append(f"  {plan.path:60s} {plan.shape!s:24s} -> "
                         f"{plan.action}")
        return "\n".join(lines)

    def d_local(self, *, per_node: bool = True) -> int:
        """Number of scalars that stay on the node (per node)."""
        total = 0
        for plan in self._plans:
            n = 1
            for d in plan.shape:
                n *= d
            if per_node and plan.shape:
                n //= plan.shape[0]
            total += n
        return int(total) - self.d_shared(per_node=per_node)
