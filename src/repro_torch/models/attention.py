"""GQA attention parameters (port of ``repro.models.attention``).

Only :func:`init_attention` so far: the attention arithmetic of the
attention-only family lives in :mod:`repro_torch.models.transformer`, as in
the reference. Cross-attention waits for the VLM slice (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init

__all__ = ["init_attention"]


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, dtype=torch.float32,
                   device=None) -> dict:
    return {
        "wq": dense_init(gen, (d_model, n_heads * head_dim), dtype, device),
        "wk": dense_init(gen, (d_model, n_kv_heads * head_dim), dtype, device),
        "wv": dense_init(gen, (d_model, n_kv_heads * head_dim), dtype, device),
        "wo": dense_init(gen, (n_heads * head_dim, d_model), dtype, device),
    }
