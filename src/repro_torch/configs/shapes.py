"""Meta-device input stand-ins for every (arch x shape) combination (port of
``repro.configs.shapes``).

``input_specs`` never allocates: it returns meta tensors, the counterpart of
the reference's ``jax.ShapeDtypeStruct``, that the dry run
(``repro_torch.launch.dryrun``) traces against.

Layouts (the reference's):
  train   — node-stacked: {"tokens": (n_nodes, per_node_batch, seq)}
            (+ "image_embeds" (n_nodes, pnb, n_img, d) for vlm;
             audio uses "embeds" (n_nodes, pnb, seq, d) + "labels")
  prefill — consensus serving, no node dim: {"tokens": (batch, seq)}
  decode  — {"token": (batch,) int32 | (batch, d) f32, "pos": scalar int32}
            (the cache comes from the model's ``init_cache`` on meta)

Tokens and labels are int32, the dtype the port's loaders yield
(``repro_torch.data.SyntheticLMStream``), as the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import INPUT_SHAPES, ArchSpec, ShapeSpec

__all__ = ["input_specs", "train_batch_specs", "serve_batch_specs"]

F32 = torch.float32
I32 = torch.int32


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(spec: ArchSpec, shape: ShapeSpec, n_nodes: int) -> dict:
    cfg = spec.model
    assert shape.global_batch % n_nodes == 0, (shape.global_batch, n_nodes)
    pnb = shape.global_batch // n_nodes
    s = shape.seq_len
    if cfg.input_mode == "embeddings":
        batch = {
            "embeds": _sds((n_nodes, pnb, s, cfg.d_model), F32),
            "labels": _sds((n_nodes, pnb, s), I32),
        }
    else:
        batch = {"tokens": _sds((n_nodes, pnb, s), I32)}
    if spec.family == "vlm":
        n_img = cfg.groups[0].n_image_tokens
        batch["image_embeds"] = _sds((n_nodes, pnb, n_img, cfg.d_model), F32)
    return batch


def serve_batch_specs(spec: ArchSpec, shape: ShapeSpec) -> dict:
    cfg = spec.model
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "prefill":
        if cfg.input_mode == "embeddings":
            batch = {"embeds": _sds((b, s, cfg.d_model), F32),
                     "labels": _sds((b, s), I32)}
        else:
            batch = {"tokens": _sds((b, s), I32)}
        if spec.family == "vlm":
            n_img = cfg.groups[0].n_image_tokens
            batch["image_embeds"] = _sds((b, n_img, cfg.d_model), F32)
        return batch
    # decode: one new token against a seq_len cache
    if cfg.input_mode == "embeddings":
        tok = _sds((b, cfg.d_model), F32)
    else:
        tok = _sds((b,), I32)
    out = {"token": tok, "pos": _sds((), I32)}
    if spec.family == "vlm":
        n_img = cfg.groups[0].n_image_tokens
        out["image_embeds"] = _sds((b, n_img, cfg.d_model), F32)
    return out


def input_specs(spec: ArchSpec, shape_name: str, *, n_nodes: int = 16) -> dict:
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        return train_batch_specs(spec, shape, n_nodes)
    return serve_batch_specs(spec, shape)
