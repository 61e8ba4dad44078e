"""Typed run results (port of ``repro.api.results``: ``RunReport`` and
``ServeReport``)."""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["RunReport", "ServeReport"]


@dataclasses.dataclass
class RunReport:
    """What a :meth:`Session.run` / :meth:`Session.train` call did.

    ``state`` is the final protocol/training state (the resume seed);
    ``trajectory`` the per-round diagnostics as host numpy arrays (leaves
    (rounds, ...)); ``rounds`` the rounds executed; ``epsilon_spent`` the
    composed epsilon of the protected rounds (sync rounds excluded);
    ``compile_s`` the wall seconds of the first segment (it includes the
    kernels' build or load on first use); ``run_s`` the wall seconds of
    everything after.
    """

    state: Any
    trajectory: dict[str, np.ndarray]
    rounds: int
    epsilon_spent: float
    compile_s: float = 0.0
    run_s: float = 0.0

    @property
    def wall_clock(self) -> float:
        return self.compile_s + self.run_s


@dataclasses.dataclass
class ServeReport:
    """One batched prefill + decode pass (:meth:`Session.serve`).

    ``tokens`` is the generated sequence per batch row, (batch, gen): the
    argmax first token followed by the sampled continuation. ``prefill_s``
    and ``decode_s`` are wall seconds, each ending in a device
    synchronisation. The port adds ``logits``, the prefill's last-token
    logits (B, V) f32, and ``cache``, the KV cache after the last step.
    """

    tokens: Any
    prefill_s: float
    decode_s: float
    steps: int
    logits: Any = None
    cache: Any = None

    @property
    def ms_per_token(self) -> float:
        return self.decode_s / max(self.steps, 1) * 1e3
