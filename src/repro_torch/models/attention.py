"""GQA attention parameters and cross-attention (port of
``repro.models.attention``).

The self-attention arithmetic lives in :mod:`repro_torch.models.
transformer`, as in the reference. Cross-attention (the VLM's gated
image layers) is the plain einsum with materialised scores, as in the
reference, which has no kernel for it. Over a model axis it runs on the
rank's heads (a :class:`~repro_torch.models.parallel.HeadShare`: its
``wq`` columns and ``wo`` rows, the KV heads they read of ``wk`` /
``wv``, which may be parts of two GQA groups); the ``wo`` partial
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
    the image embeddings; the output is scaled by tanh(gate). ``n_heads``
    / ``n_kv_heads``: the whole model's. Over ``axis``: the rank's heads
    (:meth:`ModelAxis.attn_heads`), ``x`` and ``enc`` entering them
    through its copy-to-model, the heads' ``wo`` partial leaving through
    its sum."""
    share = axis.attn_heads(n_heads, n_kv_heads)
    x, enc = axis.copy(x), axis.copy(enc)
    b, s, _ = x.shape
    m = enc.shape[1]
    q = (x @ params["wq"]).reshape(b, s, share.h, head_dim)
    k = (enc @ params["wk"]).reshape(b, m, share.kv, head_dim)
    v = (enc @ params["wv"]).reshape(b, m, share.kv, head_dim)
    qg, back = share.grid(q)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / \
        math.sqrt(head_dim)
    probs = torch.softmax(scores, dim=-1)
    out = back(torch.einsum("bkgst,btkd->bskgd", probs, v.float()))
    out = out.reshape(b, s, share.h * head_dim).to(x.dtype)
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
