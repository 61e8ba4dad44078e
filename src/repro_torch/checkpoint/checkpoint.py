"""Tree checkpoints: an ``.npz`` tensor payload and JSON metadata (port of
``repro.checkpoint.checkpoint``).

The files are the reference's: ``tensors.npz`` holds the leaves as ``a0``,
``a1``, ... in tree-flatten order (dict keys sorted, as
``jax.tree_util`` orders them), and ``meta.json`` holds ``step``, the
leaves' ``names`` ("/"-joined key paths), ``dtypes``, ``shapes`` and the
caller's ``user`` metadata. So a checkpoint of a tree of dicts, lists and
tuples that either package writes loads in the other. ``treedef`` holds
this package's own description of the tree; the reference's loader does
not read it, and neither does this one: both restore into the structure
of a template.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.core.tree_utils import (tree_flatten,
                                         tree_flatten_with_path,
                                         tree_unflatten)
from repro_torch.device import resolve_device

__all__ = ["save_checkpoint", "load_checkpoint"]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, state: Any, *, step: int = 0,
                    metadata: dict | None = None) -> None:
    """Write ``state`` (a tree of tensors or arrays) under the directory
    ``path``, made if missing."""
    os.makedirs(path, exist_ok=True)
    named, treedef = tree_flatten_with_path(state)
    arrays = {f"a{i}": _host(leaf) for i, (_, leaf) in enumerate(named)}
    np.savez(os.path.join(path, "tensors.npz"), **arrays)
    meta = {
        "step": step,
        "treedef": str(treedef),
        "names": [name or "leaf" for name, _ in named],
        "dtypes": [str(arrays[f"a{i}"].dtype) for i in range(len(named))],
        "shapes": [list(arrays[f"a{i}"].shape) for i in range(len(named))],
        "user": metadata or {},
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_checkpoint(path: str, template: Any, *,
                    device=None) -> tuple[Any, dict]:
    """Restore into the structure of ``template`` -> (tree, meta). Every
    leaf's shape and the leaf count are checked against the template; each
    leaf keeps the checkpoint's dtype, as the reference's loader does, and
    lands on ``device`` (the CUDA card by default)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    leaves, treedef = tree_flatten(template)
    if len(leaves) != len(meta["names"]):
        raise ValueError(f"checkpoint has {len(meta['names'])} leaves, "
                         f"template has {len(leaves)}")
    restored = []
    with np.load(os.path.join(path, "tensors.npz")) as payload:
        for i, tmpl in enumerate(leaves):
            arr = payload[f"a{i}"]
            want = tuple(np.shape(tmpl))
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"leaf {meta['names'][i]}: checkpoint shape {arr.shape} "
                    f"!= template shape {want}")
            restored.append(torch.from_numpy(arr).to(dev))
    return tree_unflatten(treedef, restored), meta
