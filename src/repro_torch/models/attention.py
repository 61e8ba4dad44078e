"""GQA attention parameters, the self-attention functions and
cross-attention (port of ``repro.models.attention``).

:func:`attention_train` and :func:`attention_decode` are the reference's
public functions over the arithmetic the model runs, which lives in
:mod:`repro_torch.models.transformer` (``_attn_train``, ``_attn_decode``;
imported when called, since that module imports this one):
``use_flash=True`` on the card routes the prefill softmax through
``csrc/flash_attention.cu``. A decode step writes its K/V slot into the
cache it is given and returns that cache, where the reference returns
updated copies. Cross-attention (the VLM's gated
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

from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init
from repro_torch.models.parallel import NO_AXIS, ModelAxis

__all__ = ["init_attention", "attention_train", "attention_decode",
           "init_kv_cache", "init_cross_attention", "cross_attention",
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


def _window(window) -> int:
    return -1 if window is None else int(window)


def attention_train(params: dict, x: torch.Tensor, positions: torch.Tensor,
                    *, n_heads: int, n_kv_heads: int, head_dim: int, theta,
                    window=None, use_flash: bool = False) -> torch.Tensor:
    """Full-sequence causal (optionally sliding-window: ``window`` >= 1;
    None or < 0 is global) GQA self-attention of x (B, S, d_model) at
    ``positions`` (B, S) -> (B, S, d_model). ``use_flash``: the softmax
    through the flash-attention kernel (its plain version on the CPU)."""
    from repro_torch.models.transformer import _attn_train

    out, _, _ = _attn_train(params, x, positions, head_dim, float(theta),
                            _window(window),
                            NO_AXIS.attn_heads(n_heads, n_kv_heads),
                            use_flash=use_flash)
    return out


def init_kv_cache(batch: int, capacity: int, n_kv_heads: int, head_dim: int,
                  n_layers: int, dtype=torch.float32, device=None) -> dict:
    """Zeroed K/V of ``n_layers`` layers, (L, B, T, K, D) each."""
    shape = (n_layers, batch, capacity, n_kv_heads, head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(params: dict, x: torch.Tensor, pos: int,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                     n_heads: int, n_kv_heads: int, head_dim: int, theta,
                     window=None) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """One decode step of x (B, 1, d_model) at position ``pos`` against one
    layer's cache k, v (B, T, K, D) -> (out, k_cache, v_cache), the caches
    those given with slot ``pos`` written in place."""
    from repro_torch.models.transformer import _attn_decode

    out = _attn_decode(params, x, int(pos), k_cache, v_cache, head_dim,
                       float(theta), _window(window), False,
                       NO_AXIS.attn_heads(n_heads, n_kv_heads))
    return out, k_cache, v_cache


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
