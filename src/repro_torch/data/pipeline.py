"""Node-sharded input pipeline (port of ``repro.data.pipeline``).

Produces node-stacked batches, leaves shaped (n_nodes, per_node, ...).
Deterministic: batch t is a pure function of (seed, t), drawn from a
``torch.Generator`` on the stream's device seeded from both. Given a
``mesh`` (the reference's ``sharding``), every rank draws the same batch
and keeps its own node rows (:func:`repro_torch.launch.sharding.
shard_rows`), so per-node data never crosses node boundaries and the
ranks together hold exactly the single-process batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import torch

__all__ = ["NodeShardedLoader", "seeded_generator"]


def seeded_generator(device, *keys: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the integers
    ``keys`` through numpy's ``SeedSequence``: a pure function of them."""
    state = np.random.SeedSequence([int(k) for k in keys])
    return torch.Generator(device=device).manual_seed(
        int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))


@dataclasses.dataclass
class NodeShardedLoader:
    """Wraps a ``batch(gen, per_node_batch) -> dict`` generator (e.g.
    :class:`repro_torch.data.SyntheticLMStream`, whose ``device`` the
    generator is made on)."""

    generator: Any
    per_node_batch: int
    seed: int = 0
    mesh: Any = None  # a DeviceMesh: yield this rank's node rows

    def batch_at(self, step: int) -> Any:
        batch = self.generator.batch(
            seeded_generator(self.generator.device, self.seed, step),
            self.per_node_batch)
        if self.mesh is None:
            return batch
        from repro_torch.launch.sharding import shard_rows

        return shard_rows(batch, self.mesh)

    def __iter__(self) -> Iterator[Any]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
