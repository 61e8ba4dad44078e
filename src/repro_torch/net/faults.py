"""FaultModel: network faults inside the protocol round (port of
``repro.net.faults``).

Push-sum survives dropped packets, lost nodes and stragglers because Eq. 9
only needs each round's realized W to be **column**-stochastic: the ``a``
weights absorb the lost double stochasticity and ``y = s / a`` stays
unbiased. :meth:`FaultModel.realize` builds that matrix from the round's
nominal W:

1. knock out edges: per-edge drops (``drop_rate``), whole nodes on a churn
   schedule (``churn``: a down node neither sends nor receives), per-sender
   stragglers (``straggler_rate``: the node's messages miss the round);
2. keep every self loop;
3. renormalise each column to sum to 1, so mass is conserved at any rate.

:meth:`FaultModel.realize_sparse` does the same on the padded-CSR edge
list of the sparse schedule; its renormalisation is a segment sum over the
slots, column-stochastic to f32 rounding but not bit-identical to the
dense path's column sum, and its drop draws have the edge list's shape.

Randomness. The reference draws ``jax.random.bernoulli`` from a salted fold
of the round key, which the port cannot reproduce (threefry). The port
draws its keep decisions from Philox4x32-10, as it draws the noise
(:mod:`repro_torch.kernels.ref`), under another key: :func:`salted_bits`
of (session seed, ``FAULT_SALT``, ``FaultModel.seed``, round t). The
stream is independent of the noise bits (turning faults on leaves round
t's noise unchanged) and the same under the engine and the loop driver. A
keep decision is a uint32 compared with ``floor(p 2^32)``. The tests feed
the reference's own masks through ``draws=`` (:class:`FaultDraws`) and
``Session.run/train(fault_draws_at=)``.

A ``FaultModel()`` with every knob at its default is inactive: the plan
drops it, and the run is the fault-free one bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.kernels.ref import philox4x32_10

__all__ = ["FaultModel", "FaultDraws", "FAULT_SALT", "salted_bits",
           "keep_threshold", "segment_sum"]

# The Philox key of the fault stream is the session seed's with this salt
# folded into its high word (the reference folds it into the round key).
FAULT_SALT = 0x4E455446  # "NETF"

_MASK32 = 0xFFFFFFFF


def salted_bits(seed: int, salt: int, model_seed: int, t: int, sub: int,
                count: int, device=None) -> torch.Tensor:
    """``count`` uint32 words (as int64) of a salted Philox stream.

    Word ``e`` is word ``e % 4`` of Philox4x32-10 with key ``(seed lo,
    seed hi ^ salt)`` and counter ``(e // 4, sub, model_seed, t)``: a pure
    function of (session seed, salt, model seed, round, sub-stream, e). The
    noise stream's key is ``(seed lo, seed hi)``, so no salted word is a
    noise word. ``sub`` numbers the draws of one round (drops and
    stragglers; timeouts and delays)."""
    quads = -(-count // 4)
    q = torch.arange(quads, dtype=torch.int64, device=device)
    ctr = (q & _MASK32, torch.full_like(q, sub & _MASK32),
           torch.full_like(q, model_seed & _MASK32),
           torch.full_like(q, int(t) & _MASK32))
    words = philox4x32_10(ctr, (seed & _MASK32,
                                ((seed >> 32) ^ salt) & _MASK32))
    return torch.stack(words, dim=-1).reshape(-1)[:count]


def keep_threshold(p: float) -> int:
    """A uint32 ``u`` is kept with probability ``p`` when ``u <
    keep_threshold(p)``."""
    return min(int(p * 2.0 ** 32), 1 << 32)


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``out[j] = sum of data[f] over ids[f] == j`` (flat ``f``), as
    ``jax.ops.segment_sum``. ``index_put_(accumulate=True)`` adds each
    segment's entries one after another in slot order, on the CPU and, by
    its sorted deterministic kernel, on the card, so two calls on the same
    inputs give the same bits (an atomic ``index_add_`` would not)."""
    out = torch.zeros((n,), dtype=data.dtype, device=data.device)
    return out.index_put_((ids.reshape(-1).long(),), data.reshape(-1),
                          accumulate=True)


class FaultDraws(NamedTuple):
    """One round's random keep decisions. ``drop``: bool, the shape of the
    weights (dense (N, N), sparse (N, K)), True where the edge survives;
    ``sends``: bool (N,), False for a straggling sender. None where the
    model's rate is 0 (nothing is drawn)."""

    drop: torch.Tensor | None = None
    sends: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Static description of the network's failures.

    ``drop_rate``: per-round, per-(non-self)-edge drop probability.
    ``churn``: ``(node, t_down, t_up)`` half-open downtime windows; a down
    node neither sends nor receives and keeps its own state. ``straggler_
    rate``: per-node probability that a round's outgoing messages miss it.
    ``seed``: a fold for running several independent fault streams off one
    session seed.
    """

    drop_rate: float = 0.0
    churn: tuple[tuple[int, int, int], ...] = ()
    straggler_rate: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if not (0.0 <= self.drop_rate < 1.0):
            raise ValueError(f"drop_rate={self.drop_rate} must be in [0, 1)")
        if not (0.0 <= self.straggler_rate < 1.0):
            raise ValueError(
                f"straggler_rate={self.straggler_rate} must be in [0, 1)")
        windows: dict[int, list[tuple[int, int]]] = {}
        for entry in self.churn:
            if len(entry) != 3:
                raise ValueError(
                    f"churn entries are (node, t_down, t_up); got {entry!r}")
            node, t_down, t_up = entry
            for name, val in (("node", node), ("t_down", t_down),
                              ("t_up", t_up)):
                if not isinstance(val, int) or isinstance(val, bool):
                    raise ValueError(
                        f"churn {name}={val!r} must be an int (entry "
                        f"{entry!r}); floats/strings are silently wrong in "
                        "the round comparison")
            if node < 0:
                raise ValueError(f"churn node {node} must be >= 0")
            if not t_down < t_up:
                raise ValueError(
                    f"churn interval [{t_down}, {t_up}) is empty for node "
                    f"{node}")
            for lo, hi in windows.get(node, ()):
                if t_down < hi and lo < t_up:
                    raise ValueError(
                        f"churn windows [{lo}, {hi}) and [{t_down}, {t_up}) "
                        f"overlap for node {node}; merge them into one "
                        "interval per downtime")
            windows.setdefault(node, []).append((t_down, t_up))

    @property
    def active(self) -> bool:
        """Whether the round masks anything at all."""
        return (self.drop_rate > 0.0 or bool(self.churn)
                or self.straggler_rate > 0.0)

    def up_mask(self, t: int, n_nodes: int, device=None) -> torch.Tensor:
        """(N,) bool: node up at round ``t`` under the churn schedule."""
        bad = sorted({c[0] for c in self.churn if c[0] >= n_nodes})
        if bad:
            raise ValueError(
                f"churn nodes {bad} out of range for N={n_nodes} "
                f"(valid ids 0..{n_nodes - 1})")
        up = torch.ones((n_nodes,), dtype=torch.bool, device=device)
        for node, t_down, t_up in self.churn:
            if t_down <= t < t_up:
                up[node] = False
        return up

    def draw(self, seed: int, t: int, shape: tuple[int, int],
             device=None) -> FaultDraws:
        """Round ``t``'s keep decisions from the port's Philox stream;
        ``shape`` is the weights' ((N, N) dense, (N, K) sparse)."""
        drop = sends = None
        if self.drop_rate > 0.0:
            bits = salted_bits(seed, FAULT_SALT, self.seed, t, 0,
                               shape[0] * shape[1], device)
            drop = (bits < keep_threshold(1.0 - self.drop_rate)).reshape(
                shape)
        if self.straggler_rate > 0.0:
            bits = salted_bits(seed, FAULT_SALT, self.seed, t, 1, shape[0],
                               device)
            sends = bits < keep_threshold(1.0 - self.straggler_rate)
        return FaultDraws(drop=drop, sends=sends)

    def realize(self, w: torch.Tensor, t: int, *, seed: int = 0,
                draws: FaultDraws | None = None,
                with_adjacency: bool = False
                ) -> tuple[torch.Tensor, dict[str, Any]]:
        """Nominal (N, N) W -> (realized column-stochastic W, diagnostics).

        The nominal W must have a positive diagonal (every topology of the
        port has): the kept self loop keeps each column's mass positive.
        ``draws`` replaces the round's Philox draws (tests). Diagnostics:
        ``net_out_degree`` (N,) int32 realized non-self out-edges a sender,
        ``net_dropped_edges`` () int32 nominal minus realized edges, and
        with ``with_adjacency`` ``net_adj`` (N, N) bool (receiver, sender),
        self loops included.
        """
        n = w.shape[0]
        if draws is None:
            draws = self.draw(seed, t, (n, n), w.device)
        eye = torch.eye(n, dtype=torch.bool, device=w.device)
        nominal = (w > 0.0) & ~eye
        keep = torch.ones((n, n), dtype=torch.bool, device=w.device)
        if draws.drop is not None:
            keep &= draws.drop.to(w.device)
        if draws.sends is not None:
            keep &= draws.sends.to(w.device)[None, :]  # column j = sender j
        if self.churn:
            up = self.up_mask(t, n, w.device)
            keep &= up[None, :] & up[:, None]
        realized = nominal & keep
        mask = realized | eye
        w_masked = w * mask
        w_real = w_masked / w_masked.sum(dim=0, keepdim=True)
        out_degree = realized.sum(dim=0).to(torch.int32)
        diag = {"net_out_degree": out_degree,
                "net_dropped_edges": (nominal.sum() - out_degree.sum()).to(
                    torch.int32)}
        if with_adjacency:
            diag["net_adj"] = mask
        return w_real, diag

    def realize_sparse(self, idx: torch.Tensor, vals: torch.Tensor, t: int,
                       *, seed: int = 0, draws: FaultDraws | None = None,
                       with_adjacency: bool = False
                       ) -> tuple[torch.Tensor, dict[str, Any]]:
        """The padded-CSR twin of :meth:`realize`; never forms an (N, N) W.

        Slot (i, k) carries sender ``idx[i, k]`` to receiver i with weight
        ``vals[i, k]``; pad slots carry the receiver's index and weight 0
        and are neither edges nor self loops here (``vals > 0`` is the
        support). Returns the renormalised ``vals`` (dropped edges weigh 0)
        and the diagnostics of :meth:`realize`; each sender's surviving
        mass is a :func:`segment_sum` over the slots.
        """
        n, k = idx.shape
        if draws is None:
            draws = self.draw(seed, t, (n, k), vals.device)
        sender = idx.long()
        rows = torch.arange(n, device=idx.device)[:, None]
        self_slot = sender == rows          # self loops and zero-weight pads
        nominal = (vals > 0.0) & ~self_slot
        keep = torch.ones((n, k), dtype=torch.bool, device=vals.device)
        if draws.drop is not None:
            keep &= draws.drop.to(vals.device)
        if draws.sends is not None:
            keep &= draws.sends.to(vals.device)[sender]
        if self.churn:
            up = self.up_mask(t, n, vals.device)
            keep &= up[sender] & up[:, None]
        realized = nominal & keep
        mask = realized | self_slot
        vals_masked = vals * mask
        col_mass = segment_sum(vals_masked, sender, n)
        vals_real = vals_masked / col_mass[sender]
        out_degree = segment_sum(realized.to(torch.int32), sender, n)
        diag = {"net_out_degree": out_degree,
                "net_dropped_edges": (nominal.sum() - out_degree.sum()).to(
                    torch.int32)}
        if with_adjacency:
            # integer adds, then a threshold, as the reference does
            hits = torch.zeros((n, n), dtype=torch.int32, device=idx.device)
            hits.index_put_((rows.expand(n, k), sender), mask.to(torch.int32),
                            accumulate=True)
            diag["net_adj"] = hits > 0
        return vals_real, diag
