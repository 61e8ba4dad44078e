"""Minimal optimizers (port of ``repro.optim.optimizers``): the paper's
algorithms take plain SGD steps; AdamW is there for non-private training.
Pure functions, tree in and tree out; the updates are elementwise, so a
node-stacked tree updates as well as a single one."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.tree_utils import tree_leaves, tree_map

PyTree = Any

__all__ = ["OptState", "sgd", "adamw", "global_norm"]


class OptState(NamedTuple):
    step: torch.Tensor              # int32 scalar: updates taken
    mu: PyTree | None = None        # first moment (momentum)
    nu: PyTree | None = None        # second moment


@dataclasses.dataclass(frozen=True)
class _Optimizer:
    init: Callable[[PyTree], OptState]
    update: Callable[[PyTree, OptState, PyTree], tuple[PyTree, OptState]]


def _step0(params: PyTree) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr: float, momentum: float = 0.0) -> _Optimizer:
    """p - lr g, or with ``momentum`` m = momentum m + g and p - lr m."""

    def init(params: PyTree) -> OptState:
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return OptState(step=_step0(params), mu=mu)

    def update(grads, state, params):
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state.mu, grads)
            upd = mu
        else:
            mu, upd = None, grads
        new_params = tree_map(lambda p, u: p - lr * u.to(p.dtype), params, upd)
        return new_params, OptState(step=state.step + 1, mu=mu)

    return _Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> _Optimizer:
    """Adam with bias correction and decoupled weight decay; moments in
    f32 whatever the parameters' dtype."""

    def init(params: PyTree) -> OptState:
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        return OptState(step=_step0(params), mu=z,
                        nu=tree_map(torch.clone, z))

    def update(grads, state, params):
        step = state.step + 1
        t = step.to(torch.float32)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu,
                      grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t

        def upd(p, m, v):
            step_ = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.float()
            return p - (lr * step_).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, OptState(step=step, mu=mu, nu=nu)

    return _Optimizer(init, update)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (f32)."""
    return torch.sqrt(sum((torch.sum(torch.square(x.float()))
                           for x in tree_leaves(tree)), torch.zeros(())))
