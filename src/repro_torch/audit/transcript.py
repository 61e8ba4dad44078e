"""Transcript taps: record what the network reveals each round (port of
``repro.audit.transcript``).

The DPPS wire protocol (paper Alg. 1) makes three quantities visible
outside a node each round:

* the noised outgoing message ``s^(t+1/2) + gamma_n n^(t)`` (Eq. 8-9), as
  encoded by the wire codec: every out-neighbour, and anyone tapping the
  link, receives it;
* the push-sum weight ``a_i`` gossiped beside it (Eq. 9);
* the per-node sensitivity scalar ``S_i`` broadcast for the network max
  (Alg. 1 line 4), sent in the clear.

A :class:`TranscriptTap` says which of them to record.
``repro_torch.core.dpps.dpps_step`` calls :meth:`TranscriptTap.capture`
when it is given one, adding ``tap_*`` rows to the round's diagnostics; the
drivers stack them into (T, ...) rows, and :meth:`Transcript.from_trajectory`
reassembles them into a round-indexed transcript that the threat models of
:mod:`repro_torch.audit.threat` take views of. Without a tap nothing is
captured, and with one the protocol state is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core.tree_utils import PyTree, tree_leaves

__all__ = ["TranscriptTap", "Transcript", "flatten_messages", "TAP_PREFIX"]

TAP_PREFIX = "tap_"


def flatten_messages(tree: PyTree) -> torch.Tensor:
    """Node-stacked tree -> the (N, d_s) wire layout (leaf rows
    concatenated in leaf order)."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    rows = [x.reshape(n, -1) for x in leaves]
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)


@dataclasses.dataclass(frozen=True)
class TranscriptTap:
    """Which wire-visible quantities to record each round. ``messages``
    dominates the cost (T x N x d_s values): switch it off for long
    ledger-only runs."""

    messages: bool = True      # noised outgoing messages, (N, d_s)
    sensitivity: bool = True   # broadcast S_i scalars (N,) + network S ()
    weights: bool = True       # outgoing push-sum weights a_i, (N,)

    def capture(self, *, s_noise: PyTree, a_out: torch.Tensor,
                sens_local: torch.Tensor,
                sens_scalar: torch.Tensor) -> dict[str, torch.Tensor]:
        """Called by ``dpps_step``; returns the round's ``tap_*`` rows."""
        out: dict[str, torch.Tensor] = {}
        if self.messages:
            out[TAP_PREFIX + "messages"] = flatten_messages(s_noise)
        if self.sensitivity:
            out[TAP_PREFIX + "sens_local"] = sens_local
            out[TAP_PREFIX + "sensitivity"] = sens_scalar
        if self.weights:
            out[TAP_PREFIX + "weights"] = a_out
        return out


class Transcript(NamedTuple):
    """Round-indexed wire recording; ``None`` fields were not tapped.
    Shapes: ``messages`` (T, N, d_s); ``sens_local`` (T, N);
    ``sensitivity`` (T,); ``weights`` (T, N)."""

    messages: Any
    sens_local: Any
    sensitivity: Any
    weights: Any

    @classmethod
    def from_trajectory(cls, traj: dict[str, Any]) -> "Transcript":
        """The ``tap_*`` rows a driver captured."""
        get = lambda k: traj.get(TAP_PREFIX + k)
        return cls(messages=get("messages"), sens_local=get("sens_local"),
                   sensitivity=get("sensitivity"), weights=get("weights"))

    @property
    def rounds(self) -> int:
        for x in self:
            if x is not None:
                return int(x.shape[0])
        raise ValueError("empty transcript (tap recorded nothing)")

    @property
    def n_nodes(self) -> int:
        for x in (self.messages, self.sens_local, self.weights):
            if x is not None:
                return int(x.shape[1])
        raise ValueError("transcript has no per-node field")
