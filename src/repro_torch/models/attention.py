"""GQA attention parameters and cross-attention (port of
``repro.models.attention``).

The self-attention arithmetic lives in :mod:`repro_torch.models.
transformer`, as in the reference. Cross-attention (the VLM's gated
image layers) is the plain einsum with materialised scores, as in the
reference, which has no kernel for it. Over a model axis it runs on the
rank's heads (``n_heads`` / ``n_kv_heads`` the rank's, its ``wq`` /
``wk`` / ``wv`` column blocks and ``wo`` row block); the ``wo`` partial
is summed over "model" before the tanh gate scales it, so the gate's
gradient is whole on every rank.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import dense_init
from repro_torch.models.parallel import NO_AXIS, ModelAxis

__all__ = ["init_attention", "init_cross_attention", "cross_attention",
           "open_cross_gates"]


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, dtype=torch.float32,
                   device=None) -> dict:
    return {
        "wq": dense_init(gen, (d_model, n_heads * head_dim), dtype, device),
        "wk": dense_init(gen, (d_model, n_kv_heads * head_dim), dtype, device),
        "wv": dense_init(gen, (d_model, n_kv_heads * head_dim), dtype, device),
        "wo": dense_init(gen, (n_heads * head_dim, d_model), dtype, device),
    }


def init_cross_attention(gen: torch.Generator, d_model: int, n_heads: int,
                         n_kv_heads: int, head_dim: int, dtype=torch.float32,
                         device=None) -> dict:
    p = init_attention(gen, d_model, n_heads, n_kv_heads, head_dim, dtype,
                       device)
    # llama-3.2-V's tanh gate starts closed: a fresh cross layer adds zero
    p["gate"] = torch.zeros((1,), dtype=dtype, device=device)
    return p


def cross_attention(params: dict, x: torch.Tensor, enc: torch.Tensor, *,
                    n_heads: int, n_kv_heads: int, head_dim: int,
                    axis: ModelAxis = NO_AXIS) -> torch.Tensor:
    """x (B, S, d_model) attends, unmasked, over ``enc`` (B, M, d_model),
    the image embeddings; the output is scaled by tanh(gate). Over
    ``axis``: ``x`` and ``enc`` enter the rank's heads through its
    copy-to-model, the heads' ``wo`` partial leaves through its sum."""
    x, enc = axis.copy(x), axis.copy(enc)
    b, s, _ = x.shape
    group = n_heads // n_kv_heads
    q = (x @ params["wq"]).reshape(b, s, n_kv_heads, group, head_dim)
    k = (enc @ params["wk"]).reshape(b, -1, n_kv_heads, head_dim)
    v = (enc @ params["wv"]).reshape(b, -1, n_kv_heads, head_dim)
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) / \
        math.sqrt(head_dim)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    out = out.reshape(b, s, n_heads * head_dim).to(x.dtype)
    gate = torch.tanh(params["gate"].float()).to(x.dtype)
    return axis.reduce(out @ params["wo"]) * gate


def open_cross_gates(params: dict, gate: float = 0.5) -> dict:
    """``params`` with every cross-attention ``gate`` set to ``gate``: a new
    tree whose other leaves (tensors or numpy arrays) are shared. A fresh
    gate is zero and tanh(0) makes its layer add nothing, so seeded weights
    exercise the cross layers only with their gates opened."""
    return {k: open_cross_gates(v, gate) if isinstance(v, dict)
            else v * 0 + gate if k == "gate" else v
            for k, v in params.items()}
