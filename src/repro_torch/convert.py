"""Weights across: numpy copies of the reference's params and protocol
states -> the port's.

Takes trees of numpy arrays (e.g. ``jax.tree_util.tree_map(np.asarray,
x)`` of a ``repro`` params tree, ``DPPSState`` or ``PartPSPState``); reads
the reference states by attribute (``push.s``, ``push.a``, ``sens.*``,
``t``), so nothing of ``repro`` or ``jax`` is imported. Containers keep
their structure, and :mod:`repro_torch.core.tree_utils` flattens dicts in
sorted-key order, as ``jax.tree_util.tree_flatten`` does, so packing
offsets agree.

``device=None`` is the CUDA card, as everywhere in the port
(:func:`repro_torch.device.resolve_device`); pass ``device="cpu"`` for
the CPU.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.dpps import DPPSState
from repro_torch.core.partpsp import PartPSPState
from repro_torch.core.pushsum import PushSumState
from repro_torch.core.sensitivity import SensitivityState
from repro_torch.core.tree_utils import PyTree, tree_flatten_with_path, tree_map
from repro_torch.device import resolve_device

__all__ = ["tree_from_numpy", "dpps_state_from_reference",
           "partpsp_state_from_reference",
           "transformer_params_from_reference"]


def tree_from_numpy(tree: PyTree, device=None) -> PyTree:
    """Nested dict/list/tuple of arrays -> the same of torch tensors (copies:
    numpy views of the reference's arrays are read-only)."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=dev), tree)


def dpps_state_from_reference(state: Any, device=None) -> DPPSState:
    """A reference ``DPPSState`` (numpy leaves, unpacked tree ``push.s``)."""
    device = resolve_device(device)
    sens = state.sens
    return DPPSState(
        push=PushSumState(s=tree_from_numpy(state.push.s, device),
                          a=tree_from_numpy(state.push.a, device)),
        sens=SensitivityState(*(tree_from_numpy(getattr(sens, f), device)
                                for f in SensitivityState._fields)),
        t=int(np.asarray(state.t)))


def partpsp_state_from_reference(state: Any, device=None) -> PartPSPState:
    """A reference ``PartPSPState`` (numpy leaves)."""
    device = resolve_device(device)
    return PartPSPState(dpps=dpps_state_from_reference(state.dpps, device),
                        local=list(tree_from_numpy(list(state.local), device)))


def transformer_params_from_reference(params: PyTree, cfg, device=None, *,
                                      nodes: int | None = None) -> dict:
    """A reference ``Transformer.init`` tree (numpy leaves) for the model
    ``cfg`` -> the port's parameter dict. With ``nodes``, a node-stacked
    tree (every leaf with a leading axis of ``nodes``, as a PartPSP
    session holds it). Every path and shape is checked against the port's
    own ``Transformer(cfg).init`` tree (built on the meta device, so
    nothing is allocated), so that a renamed, missing or reshaped leaf
    fails here rather than in the forward pass. The PartPSP state over such
    params converts with :func:`partpsp_state_from_reference`."""
    from repro_torch.models.transformer import Transformer

    model = Transformer(cfg)
    want, _ = tree_flatten_with_path(model.init(torch.Generator(),
                                                device="meta"))
    got, _ = tree_flatten_with_path(params)
    lead = () if nodes is None else (int(nodes),)
    want_shapes = {p: lead + tuple(x.shape) for p, x in want}
    got_shapes = {p: tuple(np.shape(x)) for p, x in got}
    if want_shapes != got_shapes:
        missing = sorted(set(want_shapes) - set(got_shapes))
        extra = sorted(set(got_shapes) - set(want_shapes))
        wrong = sorted(p for p in set(want_shapes) & set(got_shapes)
                       if want_shapes[p] != got_shapes[p])
        raise ValueError(f"params do not fit {cfg.name}"
                         f"{'' if nodes is None else f' x {nodes} nodes'}: "
                         f"missing {missing}, unexpected {extra}, wrong "
                         f"shape {wrong}")
    dtype = model.dtype
    return tree_map(lambda x: x.to(dtype), tree_from_numpy(params, device))
