"""The paper's MNIST MLP (784 -> 10 -> 784 -> 10, tanh), port of the model
in ``benchmarks/common.py``.

Parameters are a dict ``{"l1", "l2", "l3"}``; every function takes either
single-node leaves or node-stacked ones (a leading N axis on parameters
and batch alike), since ``@`` broadcasts over the node axis.
"""
from __future__ import annotations

import torch

__all__ = ["D_IN", "N_CLASSES", "HIDDEN", "PARTITIONS", "init_mlp",
           "mlp_logits", "mlp_loss"]

D_IN, N_CLASSES = 784, 10
HIDDEN = 10

PARTITIONS = {
    # PartPSP-1 shares the first layer, PartPSP-2 the first two; SGP and
    # SGPDP share everything.
    "partpsp-1": (("l1", "shared"),),
    "partpsp-2": (("l1|l2", "shared"),),
    "full": ((".*", "shared"),),
}


def init_mlp(gen: torch.Generator, *, d_in: int = D_IN, hidden: int = HIDDEN,
             n_classes: int = N_CLASSES, device=None) -> dict:
    """Single-node params, normal / sqrt(fan_in)."""
    def layer(shape):
        return torch.randn(shape, generator=gen, device=device) / shape[0] ** 0.5
    return {"l1": layer((d_in, hidden)), "l2": layer((hidden, d_in)),
            "l3": layer((d_in, n_classes))}


def mlp_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(x @ p["l1"])
    h = torch.tanh(h @ p["l2"])
    return h @ p["l3"]


def mlp_loss(p: dict, batch) -> torch.Tensor:
    """Mean cross-entropy of each node's batch -> (N,) (or a scalar for
    single-node inputs)."""
    x, y = batch
    logp = torch.log_softmax(mlp_logits(p, x), dim=-1)
    return -torch.gather(logp, -1, y[..., None].to(torch.int64))[..., 0].mean(-1)
