"""Threat models: what each adversary class sees of a DPPS transcript (port
of ``repro.audit.threat``).

A link eavesdropper sees one node's wire, a curious neighbour everything
arriving on its own in-edges, and a global observer every message. The
paper's Theorem 1 is stated against the per-round release, so the
empirical epsilon under every view must stay below the theoretical one.
Mechanisms whose guarantee depends on the threat model (graph-homomorphic
correlated noise) separate here: private against a local eavesdropper,
broken against a global observer who sums the zero-sum noise away.

A :class:`ThreatModel` is a pure view: it selects rows of a recorded
:class:`~repro_torch.audit.transcript.Transcript` and never touches
protocol state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

from repro_torch.audit.transcript import Transcript

__all__ = [
    "Observation",
    "ThreatModel",
    "LOCAL_EAVESDROPPER",
    "CURIOUS_NEIGHBOR",
    "GLOBAL_OBSERVER",
    "THREAT_MODELS",
]


class Observation(NamedTuple):
    """An adversary's view of a transcript: ``visible`` node indices whose
    outgoing wire it reads, their rows of ``messages`` (T, k, d_s),
    ``sens_local`` (T, k) and ``weights`` (T, k), and the broadcast network
    scalar ``sensitivity`` (T,), which every adversary sees."""

    visible: tuple[int, ...]
    messages: Any
    sens_local: Any
    sensitivity: Any
    weights: Any

    def node_messages(self, node: int):
        """(T, d_s) message stream of one visible node."""
        if self.messages is None:
            raise ValueError("transcript was recorded without messages")
        return self.messages[:, self.visible.index(node), :]


@dataclasses.dataclass(frozen=True)
class ThreatModel:
    """A named view of transcripts; ``kind`` picks the visibility rule:
    ``eavesdropper`` (the victim's outgoing links), ``neighbor`` (an
    honest-but-curious out-neighbour of the victim: every message on its
    own in-edges; needs ``topo``) or ``global`` (every node's wire)."""

    name: str
    kind: str

    def __post_init__(self):
        if self.kind not in ("eavesdropper", "neighbor", "global"):
            raise ValueError(f"unknown threat kind {self.kind!r}")

    def visible_nodes(self, *, victim: int, n_nodes: int, topo: Any = None,
                      t: int = 0) -> tuple[int, ...]:
        if self.kind == "global":
            return tuple(range(n_nodes))
        if self.kind == "eavesdropper":
            return (victim,)
        if topo is None:
            raise ValueError("the curious-neighbor view needs topo= to "
                             "resolve the adversary's in-edges")
        edges = topo.edges(t)
        receivers = sorted(r for (s, r) in edges if s == victim and r != victim)
        if not receivers:
            raise ValueError(f"victim {victim} has no out-neighbor to be "
                             "curious")
        adversary = receivers[0]
        return tuple(sorted(s for (s, r) in edges if r == adversary))

    def observe(self, transcript: Transcript, *, victim: int,
                topo: Any = None, t: int = 0) -> Observation:
        visible = self.visible_nodes(victim=victim,
                                     n_nodes=transcript.n_nodes,
                                     topo=topo, t=t)
        idx = list(visible)
        take = lambda x: None if x is None else x[:, idx]
        return Observation(visible=visible,
                           messages=take(transcript.messages),
                           sens_local=take(transcript.sens_local),
                           sensitivity=transcript.sensitivity,
                           weights=take(transcript.weights))


LOCAL_EAVESDROPPER = ThreatModel("local_eavesdropper", "eavesdropper")
CURIOUS_NEIGHBOR = ThreatModel("curious_neighbor", "neighbor")
GLOBAL_OBSERVER = ThreatModel("global_observer", "global")

THREAT_MODELS = (LOCAL_EAVESDROPPER, CURIOUS_NEIGHBOR, GLOBAL_OBSERVER)
