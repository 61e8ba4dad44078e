"""MODEL_FLOPS accounting (port of ``repro.launch.flops``): 6*N*D (train) /
2*N*D (inference) with N the *active* parameter count (MoE experts scaled
to top_k + shared).

The parameter shapes come from ``Transformer.init`` on the meta device (no
allocation), as the reference's come from ``jax.eval_shape``.
"""
from __future__ import annotations

import torch

from repro_torch.configs import INPUT_SHAPES, ArchSpec, ShapeSpec
from repro_torch.core.tree_utils import tree_flatten_with_path
from repro_torch.models.config import MoEGroup
from repro_torch.models.transformer import Transformer

__all__ = ["param_counts", "model_flops", "model_flops_per_chip"]


def param_counts(arch: ArchSpec) -> tuple[int, int]:
    """(total, active) parameter counts of the full model."""
    params = Transformer(arch.model).init(torch.Generator(), device="meta")
    total = active = 0
    moe = next((g for g in arch.model.groups if isinstance(g, MoEGroup)), None)
    for path, leaf in tree_flatten_with_path(params)[0]:
        n = leaf.numel()
        total += n
        if moe is not None and "/moe/w_" in "/" + path:
            # expert bank: only top_k of n_experts are active per token
            active += n * moe.top_k // moe.n_experts
        else:
            active += n
    return total, active


def model_flops_per_chip(arch: ArchSpec, shape_name: str, n_chips: int) -> float:
    return model_flops(arch, INPUT_SHAPES[shape_name], n_chips)


def model_flops(arch: ArchSpec, shape: ShapeSpec, n_chips: int = 1) -> float:
    """:func:`model_flops_per_chip` of any ``ShapeSpec``."""
    _, active = param_counts(arch)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * active * tokens
    else:  # decode: one new token per sequence
        total = 2.0 * active * shape.global_batch
    return total / n_chips
