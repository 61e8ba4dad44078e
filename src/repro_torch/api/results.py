"""Typed run results (port of ``repro.api.results``: ``RunReport``,
``ServeReport`` and ``estimate_wire_bytes``).

The wire-byte figure is an estimate of the protocol's network traffic:
each round every node sends its noised message (``d_s`` elements in the
plan's wire format, or the payload of its wire codec), its push-sum weight
and its sensitivity scalar to each out-neighbour (paper Alg. 1 lines 4 and
6, Eq. 9). It counts payload only, no framing, as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["RunReport", "ServeReport", "estimate_wire_bytes"]


def estimate_wire_bytes(plan, n_nodes: int, d_s: int, rounds: int) -> int:
    """Estimated protocol payload bytes of ``rounds`` rounds. ``plan`` may be
    None (dense all-to-all is assumed). Self-loops (circulant offset 0, the
    dense diagonal) never cross the wire and are left out. An active wire
    codec owns the message payload (int8 ``d_s + 4``, top-k ``6 k``, bf16
    ``2 d_s``); the ledger and ``NetworkStatsHook`` read the same figure."""
    codec = getattr(plan, "wire", None) if plan is not None else None
    if codec is not None and getattr(codec, "active", False):
        payload = int(codec.payload_bytes(d_s))
    else:
        payload = d_s * (2 if plan is not None and plan.wire_dtype == "bf16"
                         else 4)
    if plan is not None and plan.schedule == "circulant" and plan.offsets:
        edges_per_round = n_nodes * sum(
            1 for o in plan.offsets if o % n_nodes != 0)
    elif plan is not None and plan.sparse_idx is not None:
        # edge-list plans pay for the nominal non-self edges only (mean
        # over the period)
        idx = plan.sparse_idx.cpu().numpy()          # (P, N, K)
        vals = plan.sparse_vals.cpu().numpy()
        recv = np.arange(idx.shape[1])[None, :, None]
        nonself = (vals > 0.0) & (idx != recv)
        edges_per_round = float(nonself.sum()) / idx.shape[0]
    else:
        edges_per_round = n_nodes * (n_nodes - 1)
    # message payload + push-sum weight a_i (f32) + sensitivity scalar S_i
    per_round = edges_per_round * (payload + 4 + 4)
    return int(int(rounds) * per_round)


@dataclasses.dataclass
class RunReport:
    """What a :meth:`Session.run` / :meth:`Session.train` call did.

    ``state`` is the final protocol/training state (the resume seed);
    ``trajectory`` the per-round diagnostics as host numpy arrays (leaves
    (rounds, ...)), hook captures included; ``rounds`` the rounds executed
    (fewer than asked for after an abort); ``epsilon_spent`` the composed
    epsilon of the protected rounds (sync rounds excluded); ``wire_bytes``
    :func:`estimate_wire_bytes` of them; ``compile_s`` the wall seconds of
    the first segment (it includes the kernels' build or load on first
    use); ``run_s`` the wall seconds of everything after, hooks' host work
    included; ``aborted`` / ``abort_reason`` whether a hook stopped the run
    (a :class:`repro_torch.api.hooks.RunAbort`) and its message;
    ``network`` the realized-network record of a hook with
    ``network_stats()`` (:class:`repro_torch.net.NetworkStatsHook`).
    """

    state: Any
    trajectory: dict[str, np.ndarray]
    rounds: int
    epsilon_spent: float
    wire_bytes: int
    compile_s: float = 0.0
    run_s: float = 0.0
    aborted: bool = False
    abort_reason: str | None = None
    network: Any = None

    @property
    def wall_clock(self) -> float:
        return self.compile_s + self.run_s

    def summary(self) -> dict[str, Any]:
        eps = float(self.epsilon_spent)
        out = {
            "rounds": self.rounds,
            "epsilon_spent": eps if np.isfinite(eps) else None,
            "wire_bytes": self.wire_bytes,
            "compile_s": round(self.compile_s, 3),
            "run_s": round(self.run_s, 3),
            "wall_clock_s": round(self.wall_clock, 3),
            "aborted": self.aborted,
        }
        if self.network is not None:
            out["network"] = self.network.summary()
        return out


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
