"""Partial-communication parameter partition (paper SIII.C, Fig. 1), port
of ``repro.core.partition``.

PartPSP splits the parameter tree into *shared* leaves (gossiped through
DPPS) and *local* leaves (never leave the node). Actions per leaf (first
matching rule wins, ``default`` otherwise): ``"shared"``, ``"local"``, or
``("split_layers", k)`` for layer-stacked leaves (N, L, ...): layers [:k]
shared, [k:] local. Patterns are regexes searched in the leaf's key path
(``"/"``-joined, dict keys sorted, as ``jax.tree_util`` orders them).
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

__all__ = ["Partition", "SHARE_ALL", "SHARE_NONE"]

Action = Any  # "shared" | "local" | ("split_layers", int)

SHARE_ALL: Sequence[tuple[str, Action]] = ((".*", "shared"),)
SHARE_NONE: Sequence[tuple[str, Action]] = ((".*", "local"),)


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

    def merge(self, shared: Sequence, local: Sequence) -> PyTree:
        """Inverse of :meth:`split`."""
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
                leaves.append(torch.cat([shared[si], local[li]], dim=1))
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
