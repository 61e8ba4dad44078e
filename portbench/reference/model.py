"""A pre-norm decoder over frame embeddings, its loss and gradients,
written out in plain PyTorch (float32).

Parameters are a nested dict under these paths (one node's, the layer
leaves stacked over the layers):

  embed (V, d)            unused with embedding inputs (zero gradient)
  final_ln/scale (d,)
  lm_head (d, V)
  group_0/ln1/scale (L, d)          group_0/ln2/scale (L, d)
  group_0/attn/{wq,wk,wv} (L, d, H Dh)   group_0/attn/wo (L, H Dh, d)
  group_0/mlp/w_up (L, d, F)        group_0/mlp/w_down (L, F, d)

Layer l: ``x += attn(rms(x) ln1) ; x += mlp(rms(x) ln2)`` with RMSNorm
``x / sqrt(mean(x^2) + eps)``, rotary positions on q and k (the two
halves of each head rotated by ``theta^(-i / (Dh / 2))``), causal softmax
attention scaled by ``1 / sqrt(Dh)``, and a tanh-GELU MLP. The loss is the
mean next-frame cross entropy over the codebook: the hidden state at
position p predicts the label at p + 1.

``tree_paths`` orders leaves as a tree flatten with sorted keys does,
which is the order of the PartPSP wire row.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def tree_paths(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) pairs, dict keys sorted, paths joined with "/"."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        value = tree[key]
        if isinstance(value, dict):
            out.extend(tree_paths(value, path))
        else:
            out.append((path, value))
    return out


def from_paths(pairs) -> dict:
    tree: dict = {}
    for path, leaf in pairs:
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def param_shapes(m: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(path, shape) of one node's parameters of the model sized by ``m``
    (a configuration file's ``model`` entry), in wire order."""
    d, L, F_ = m["d_model"], m["n_layers"], m["d_ff"]
    hd = m["n_heads"] * m["head_dim"]
    kd = m["n_kv_heads"] * m["head_dim"]
    v = m["vocab_size"]
    shapes = {
        "embed": (v, d), "final_ln/scale": (d,), "lm_head": (d, v),
        "group_0/ln1/scale": (L, d), "group_0/ln2/scale": (L, d),
        "group_0/attn/wq": (L, d, hd), "group_0/attn/wk": (L, d, kd),
        "group_0/attn/wv": (L, d, kd), "group_0/attn/wo": (L, hd, d),
        "group_0/mlp/w_up": (L, d, F_), "group_0/mlp/w_down": (L, F_, d),
    }
    return [(p, shapes[p]) for p, _ in tree_paths(from_paths(
        [(p, None) for p in shapes]))]


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, Dh): each head's halves rotated by position."""
    s, _, dh = x.shape
    half = dh // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                    / half * -math.log(theta))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer(lp: dict, x: torch.Tensor, m: dict) -> torch.Tensor:
    """One decoder layer of one sequence x (S, d)."""
    s = x.shape[0]
    dh, h, kv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    eps, theta = m["norm_eps"], m["rope_theta"]
    a = rms(x, lp["ln1"]["scale"], eps)
    q = rotary((a @ lp["attn"]["wq"]).reshape(s, h, dh), theta)
    k = rotary((a @ lp["attn"]["wk"]).reshape(s, kv, dh), theta)
    v = (a @ lp["attn"]["wv"]).reshape(s, kv, dh)
    g = h // kv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(dh)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -1e30), dim=-1)
    att = torch.einsum("hqk,khd->qhd", probs, v).reshape(s, h * dh)
    x = x + att @ lp["attn"]["wo"]
    b = rms(x, lp["ln2"]["scale"], eps)
    up = F.gelu(b @ lp["mlp"]["w_up"], approximate="tanh")
    return x + up @ lp["mlp"]["w_down"]


def loss(params: dict, embeds: torch.Tensor, labels: torch.Tensor,
         m: dict, layers=None) -> torch.Tensor:
    """Mean next-frame cross entropy of one node's batch: embeds (B, S, d),
    labels (B, S). ``layers`` lists each layer's parameter dict (default:
    the stacked leaves of ``params["group_0"]`` taken apart)."""
    if layers is None:
        g = params["group_0"]
        layers = [{blk: {name: leaf[i] for name, leaf in sub.items()}
                   for blk, sub in g.items()} for i in range(m["n_layers"])]
    total = torch.zeros((), dtype=torch.float32, device=embeds.device)
    bsz, s = labels.shape
    for j in range(bsz):
        x = embeds[j].float()
        for lp in layers:
            x = layer(lp, x, m)
        x = rms(x, params["final_ln"]["scale"], m["norm_eps"])
        logits = (x[:-1] @ params["lm_head"]).float()
        total = total + F.cross_entropy(logits, labels[j, 1:].long(),
                                        reduction="sum")
    return total / (bsz * (s - 1))
