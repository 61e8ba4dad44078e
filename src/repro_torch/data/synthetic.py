"""Deterministic synthetic data (port of ``repro.data.synthetic``).

* :class:`SyntheticLMStream`: a learnable token stream for the language
  models, a random low-rank first-order Markov chain with a transition
  temperature for each node (non-IID across nodes).
* :class:`SyntheticClassification` and :func:`dirichlet_partition`: the
  teacher-MLP task of the paper's benchmarks.

The fixed arrays (the Markov chain's factors and node temperatures, the
teacher weights, the Dirichlet matrix) come from
``np.random.default_rng(seed)`` as in the reference, so they match exactly.
Sampling uses an explicit ``torch.Generator`` on the data's device (the
reference's ``jax.random`` stream cannot be reproduced); the tests feed
both packages the same batches instead.

``device=None`` is the CUDA card (:func:`repro_torch.device.resolve_device`);
pass ``device="cpu"`` for the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["SyntheticLMStream", "SyntheticClassification",
           "dirichlet_partition"]


@dataclasses.dataclass
class SyntheticLMStream:
    """Tokens of a random first-order Markov chain with low-rank
    transitions ``softmax(ctx[tok] @ emit / temp[node])``, so next-token
    cross entropy is reducible and training curves mean something."""

    vocab_size: int
    seq_len: int
    n_nodes: int
    seed: int = 0
    markov_rank: int = 64       # low-rank transition structure
    node_skew: float = 0.5      # spread of the node temperatures (non-IID)
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        v, r = self.vocab_size, min(self.markov_rank, self.vocab_size)
        # the reference's draws, in its order, rounded to f32 as it does
        emit = rng.normal(size=(r, v)) * 2.0
        ctx = rng.normal(size=(v, r))
        temp = 1.0 + self.node_skew * rng.uniform(-1, 1, size=(self.n_nodes,))
        self.emit = torch.as_tensor(emit, dtype=torch.float32,
                                    device=self.device)
        self.ctx = torch.as_tensor(ctx, dtype=torch.float32,
                                   device=self.device)
        self.node_temp = torch.as_tensor(temp, dtype=torch.float32,
                                         device=self.device)

    def batch(self, gen: torch.Generator, per_node_batch: int) -> dict:
        """-> ``{"tokens": (n_nodes, per_node_batch, seq_len) int32}``.

        Each step samples ``argmax(logits + Gumbel)`` (what
        ``jax.random.categorical`` draws) for every sequence of every node
        at once; the first token is uniform over the vocabulary."""
        n, b, v = self.n_nodes, per_node_batch, self.vocab_size
        tok = torch.randint(0, v, (n, b), generator=gen, device=self.device)
        toks = [tok]
        temp = self.node_temp[:, None, None]
        for _ in range(self.seq_len - 1):
            logits = self.ctx[tok] @ self.emit / temp          # (N, B, V)
            u = torch.rand(logits.shape, generator=gen, device=self.device)
            g = -torch.log(-torch.log(u.clamp_min_(torch.finfo(u.dtype).tiny)))
            tok = torch.argmax(logits + g, dim=-1)
            toks.append(tok)
        return {"tokens": torch.stack(toks, dim=-1).to(torch.int32)}


@dataclasses.dataclass
class SyntheticClassification:
    """Teacher-MLP generated classification (stands in for MNIST/FMNIST)."""

    d_in: int = 32
    n_classes: int = 10
    teacher_hidden: int = 64
    seed: int = 0
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        w1 = rng.normal(size=(self.d_in, self.teacher_hidden)) / np.sqrt(self.d_in)
        w2 = (rng.normal(size=(self.teacher_hidden, self.n_classes))
              / np.sqrt(self.teacher_hidden))
        self.w1 = torch.as_tensor(w1, dtype=torch.float32, device=self.device)
        self.w2 = torch.as_tensor(w2, dtype=torch.float32, device=self.device)

    def label(self, x: torch.Tensor) -> torch.Tensor:
        return (torch.tanh(x @ self.w1) @ self.w2).argmax(dim=-1)

    def sample(self, gen: torch.Generator, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.randn((n, self.d_in), generator=gen, device=self.w1.device)
        return x, self.label(x)

    def node_batches(self, gen: torch.Generator, n_nodes: int, per_node: int,
                     partition: np.ndarray | None = None):
        """Per-node batches ``(x (N, per_node, d_in), y (N, per_node))``,
        optionally label-skewed by a Dirichlet matrix (N, n_classes):
        Gumbel-top-k sampling without replacement from 4 * per_node draws
        with probability proportional to the node's class weights."""
        dev = self.w1.device
        xs = torch.randn((n_nodes, 4 * per_node, self.d_in), generator=gen,
                         device=dev)
        ys = self.label(xs)
        if partition is None:
            return xs[:, :per_node], ys[:, :per_node]
        probs = torch.as_tensor(partition, dtype=torch.float32, device=dev)
        w = torch.gather(probs, 1, ys)
        u = torch.rand(w.shape, generator=gen, device=dev).clamp_min(1e-20)
        g = -torch.log(-torch.log(u))
        idx = torch.argsort(-(torch.log(w + 1e-9) + g), dim=1)[:, :per_node]
        x_sel = torch.gather(xs, 1, idx[..., None].expand(-1, -1, self.d_in))
        return x_sel, torch.gather(ys, 1, idx)


def dirichlet_partition(n_nodes: int, n_classes: int, alpha: float = 0.5,
                        seed: int = 0) -> np.ndarray:
    """Per-node class distributions: rows ~ Dirichlet(alpha)."""
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.full(n_classes, alpha), size=n_nodes)
