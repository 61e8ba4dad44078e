"""DelayModel: bounded-delay asynchronous push-sum (port of
``repro.net.delays``).

* **bounded random delays**: every sent (value, weight) message draws a
  delay in {0..B}, B = ``max_delay``; delayed mass waits in a per-receiver
  arrival calendar (:class:`Mailbox`) carried beside the state and is mixed
  in the round it lands.
* **staleness timeouts**: with probability ``timeout_rate`` a message times
  out at send time and its mass is credited back to the sender's self loop.
* **heterogeneous node rates**: node i takes part every ``rates[i]``
  rounds; in between it holds its whole state and its arrivals wait in its
  inbox.

The mass travels on the messages, so ``state + inbox + calendar`` mass
stays N for any delay pattern (the ``async_mass_mean`` row). The round's
noise is added before the message is enqueued, so every message carries
the synchronous protocol's Eq.-8 protection.

Randomness. The reference draws ``bernoulli`` / ``randint`` from a salted
fold of the round key; the port draws Philox words (:func:`repro_torch.
net.faults.salted_bits`) under ``DELAY_SALT``: a timeout is a uint32 below
``floor(rate 2^32)``, a delay the high 32 bits of ``u (B + 1)`` (no modulo
bias). The tests feed the reference's draws through ``draws=``
(:class:`DelayDraws`) and ``Session.run/train(delay_draws_at=)``.

Slot mixes. Each delay slot's mix takes the round's plain mix in the
reference. Here it follows the plan's kernel routing, as the synchronous
gossip does: ``pushsum_mix`` (dense) or ``spmm`` (sparse) on the card, one
launch a slot a buffer, their plain versions on the CPU. Both kernels keep
one fma chain an output in sender order, so the packed and pytree async
runs stay bit-equal on the card.

An inactive ``DelayModel()`` (delay 0, no timeouts, every rate 1) is
dropped at plan build: the run is the synchronous one bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.pushsum import (PushSumState, _kernel_mix_dense,
                                      _kernel_mix_sparse, _mix_dense,
                                      sparse_mix)
from repro_torch.core.tree_utils import (tree_flatten, tree_leaves,
                                         tree_map, tree_unflatten)
from repro_torch.net.faults import keep_threshold, salted_bits, segment_sum

__all__ = ["DelayModel", "DelayDraws", "Mailbox", "DELAY_SALT"]

# Distinct from FAULT_SALT: faults and delays draw two independent streams.
DELAY_SALT = 0x4E455444  # "NETD"


@functools.lru_cache(maxsize=256)
def _cached(values: tuple, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """A read-only tensor of ``values`` on ``device``, made once: the
    participation repeats with the rates, and a tensor made from host data
    each round would wait for the card."""
    return torch.tensor(values, dtype=dtype, device=device)


class Mailbox(NamedTuple):
    """Message mass in flight, carried beside the state.

    ``cal_s`` / ``cal_a``: arrival calendars with a leading axis of B slots;
    slot k holds what lands k + 1 rounds from now (delay-0 messages mix at
    once). ``inbox_s`` / ``inbox_a``: mass that arrived at a node that was
    not taking part; it joins the state at the node's next active round.
    The ``*_s`` fields have the state's runtime form (a tree of leaves, or
    the packed buffer); the engine packs them with the state.
    """

    cal_s: Any               # leaves (B, N, ...)
    cal_a: torch.Tensor      # (B, N) f32
    inbox_s: Any             # leaves (N, ...)
    inbox_a: torch.Tensor    # (N,) f32


class DelayDraws(NamedTuple):
    """One round's random draws, in the weights' shape ((N, N) dense, (N, K)
    sparse): ``timeout`` bool (before masking with the sent messages),
    ``delay`` int in {0..B}. None where nothing is drawn (rate 0, B = 0)."""

    timeout: torch.Tensor | None = None
    delay: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class DelayModel:
    """Static description of the network's asynchrony.

    ``max_delay``: the staleness bound B. ``timeout_rate``: per-message
    probability of a timeout (its mass goes back to the sender's self
    loop). ``rates``: node i takes part when ``t % rates[i] == 0`` (empty:
    every node every round; one rate a node). ``seed``: a fold for several
    independent delay streams off one session seed.
    """

    max_delay: int = 0
    timeout_rate: float = 0.0
    rates: tuple[int, ...] = ()
    seed: int = 0

    def __post_init__(self):
        if not isinstance(self.max_delay, int) or isinstance(
                self.max_delay, bool) or self.max_delay < 0:
            raise ValueError(
                f"max_delay={self.max_delay!r} must be an int >= 0")
        if not (0.0 <= self.timeout_rate < 1.0):
            raise ValueError(
                f"timeout_rate={self.timeout_rate} must be in [0, 1)")
        for i, r in enumerate(self.rates):
            if not isinstance(r, int) or isinstance(r, bool) or r < 1:
                raise ValueError(
                    f"rates[{i}]={r!r} must be an int >= 1 (node "
                    "participates every r rounds)")

    @property
    def active(self) -> bool:
        return (self.max_delay > 0 or self.timeout_rate > 0.0
                or any(r > 1 for r in self.rates))

    def validate_nodes(self, n_nodes: int) -> None:
        """Raise if ``rates`` does not give one rate a node."""
        if self.rates and len(self.rates) != n_nodes:
            raise ValueError(
                f"DelayModel.rates has {len(self.rates)} entries but the "
                f"topology has N={n_nodes} nodes; give one rate per node "
                "(or leave rates empty for all-every-round)")

    def active_flags(self, t: int, n_nodes: int) -> tuple[bool, ...]:
        """Node i takes part in round ``t`` (on the host)."""
        if not self.rates:
            return (True,) * n_nodes
        self.validate_nodes(n_nodes)
        return tuple(t % r == 0 for r in self.rates)

    def active_mask(self, t: int, n_nodes: int, device=None) -> torch.Tensor:
        """(N,) bool: node taking part in round ``t``."""
        return _cached(self.active_flags(t, n_nodes), torch.bool,
                       torch.device(device or "cpu"))

    def init_mailbox(self, s: Any) -> Mailbox:
        """An empty mailbox in the runtime form of the state ``s``."""
        leaf = tree_leaves(s)[0]
        n, b = leaf.shape[0], self.max_delay
        return Mailbox(
            cal_s=tree_map(lambda x: x.new_zeros((b,) + tuple(x.shape)), s),
            cal_a=torch.zeros((b, n), dtype=torch.float32,
                              device=leaf.device),
            inbox_s=tree_map(torch.zeros_like, s),
            inbox_a=torch.zeros((n,), dtype=torch.float32,
                                device=leaf.device))

    def draw(self, seed: int, t: int, shape: tuple[int, int],
             device=None) -> DelayDraws:
        """Round ``t``'s timeouts and delays from the port's Philox
        stream."""
        count = shape[0] * shape[1]
        timeout = delay = None
        if self.timeout_rate > 0.0:
            bits = salted_bits(seed, DELAY_SALT, self.seed, t, 0, count,
                               device)
            timeout = (bits < keep_threshold(self.timeout_rate)).reshape(
                shape)
        if self.max_delay > 0:
            bits = salted_bits(seed, DELAY_SALT, self.seed, t, 1, count,
                               device)
            delay = ((bits * (self.max_delay + 1)) >> 32).reshape(shape)
        return DelayDraws(timeout=timeout, delay=delay)

    def open_round(
        self, push_old: PushSumState, mail: Mailbox, t: int, *,
        seed: int = 0, draws: DelayDraws | None = None,
        w: torch.Tensor | None = None,
        sparse_idx: torch.Tensor | None = None,
        sparse_vals: torch.Tensor | None = None,
        use_kernels: bool = False,
    ) -> tuple[Callable[[PushSumState], PushSumState], Callable[[], tuple]]:
        """One async round as a ``gossip_fn`` and a ``close``.

        ``dpps_step(gossip_fn=)`` hands ``gossip_fn`` the round's noised
        payload in place of the built-in mix; ``close()`` then gives
        ``(new mailbox, stats)``. The operands are the round's realized
        weights: dense ``w`` or ``sparse_idx`` / ``sparse_vals`` (after
        ``FaultModel.realize*`` when faults compose). ``push_old`` is the
        state before the round: an inactive node keeps it.

        Each active sender j keeps ``w_jj x_j`` plus the mass of its
        timed-out messages; a surviving message with delay d mixes now
        (d = 0) or lands in calendar slot d - 1. Arrivals (calendar slot 0
        plus the immediate messages) and the inbox join an active
        receiver's state, or wait in an inactive one's inbox. Inactive
        senders send nothing and hold their state.

        Stats: ``async_delay_hist`` (B+1,) int32 surviving messages a
        delay; ``async_timeouts`` () int32; ``async_staleness_max`` ()
        int32 (<= B); ``async_participated`` (N,) bool; ``async_active``
        () int32; ``async_mass_mean`` () f32 (state + inbox + calendar mass)
        / N; ``async_inflight_mass`` () f32 inbox + calendar mass.
        """
        if (w is None) == (sparse_idx is None):
            raise ValueError(
                "open_round needs exactly one of w= (dense) or "
                "sparse_idx=/sparse_vals= (padded CSR)")
        out: dict[str, Any] = {}
        b = self.max_delay

        def gossip_fn(push_half: PushSumState) -> PushSumState:
            x_tree, a = push_half.s, push_half.a
            n, dev = a.shape[0], a.device
            flags = self.active_flags(t, n)
            act = _cached(flags, torch.bool, dev)
            # the rows an inactive node holds and an active one clears
            held = _cached(tuple(i for i, f in enumerate(flags) if not f),
                           torch.long, dev)
            live = _cached(tuple(i for i, f in enumerate(flags) if f),
                           torch.long, dev)
            if w is not None:
                shape = (n, n)
                eye = torch.eye(n, dtype=torch.bool, device=dev)
                support = (w > 0.0) & ~eye
                sent = support & act[None, :]           # column j = sender j
                weights = w
                diag_w = torch.diagonal(w)
                colsum = lambda m: m.sum(dim=0)
            else:
                shape = tuple(sparse_idx.shape)
                sender = sparse_idx.long()
                self_slot = sender == torch.arange(n, device=dev)[:, None]
                support = (sparse_vals > 0.0) & ~self_slot
                sent = support & act[sender]
                weights = sparse_vals
                diag_w = (sparse_vals * self_slot).sum(dim=1)
                colsum = lambda m: segment_sum(m, sender, n)
            d = draws if draws is not None else self.draw(seed, t, shape, dev)
            timeout = (d.timeout.to(dev) & sent if d.timeout is not None
                       else torch.zeros(shape, dtype=torch.bool, device=dev))
            dly = (d.delay.to(dev) if d.delay is not None
                   else torch.zeros(shape, dtype=torch.int64, device=dev))
            surv = sent & ~timeout
            w_surv = weights * surv
            slot_w = [w_surv * (dly == k) for k in range(b + 1)]
            keep_c = diag_w + colsum(weights * timeout)  # active senders
            if w is not None:
                mix_s = _kernel_mix_dense if use_kernels else _mix_dense
                mixes = [lambda x, m=m: mix_s(m, x) for m in slot_w]
                mixes_a = [lambda x, m=m: _mix_dense(m, x) for m in slot_w]
            else:
                mix_s = _kernel_mix_sparse if use_kernels else sparse_mix
                mixes = [lambda x, v=v: mix_s(sparse_idx, v, x)
                         for v in slot_w]
                mixes_a = [lambda x, v=v: sparse_mix(sparse_idx, v, x)
                           for v in slot_w]

            def step_leaf(x, old, cal, inbox, mix):
                # The reference's order of operations; A, K and C are fresh
                # buffers of this round, written in place (the inputs are
                # never written: a caller may still hold them).
                bshape = (n,) + (1,) * (x.dim() - 1)
                arrive = mix[0](x)                               # A
                if b > 0:
                    arrive.add_(cal[0])
                arrive.add_(inbox)                  # inbox_tot = inbox + A
                new = keep_c.reshape(bshape).to(x.dtype) * x     # K
                new.add_(arrive)                    # keep + inbox_tot
                if len(held):                       # where(act, new, old)
                    new.index_copy_(0, held, old.index_select(0, held))
                arrive.index_fill_(0, live, 0.0)    # the new inbox
                if b > 0:
                    cal_new = torch.empty_like(cal)              # C
                    for k in range(b - 1):
                        torch.add(cal[k + 1], mix[k + 1](x), out=cal_new[k])
                    torch.add(mix[b](x), 0.0, out=cal_new[b - 1])
                else:
                    cal_new = cal
                return new, arrive, cal_new

            x_leaves, treedef = tree_flatten(x_tree)
            trips = [step_leaf(x, o, c, i, mixes) for x, o, c, i in zip(
                x_leaves, tree_leaves(push_old.s), tree_leaves(mail.cal_s),
                tree_leaves(mail.inbox_s))]
            s_new = tree_unflatten(treedef, [tr[0] for tr in trips])
            inbox_s = tree_unflatten(treedef, [tr[1] for tr in trips])
            cal_s = tree_unflatten(treedef, [tr[2] for tr in trips])
            del trips
            a_new, inbox_a, cal_a = step_leaf(a, a, mail.cal_a, mail.inbox_a,
                                              mixes_a)
            out["mail"] = Mailbox(cal_s=cal_s, cal_a=cal_a, inbox_s=inbox_s,
                                  inbox_a=inbox_a)
            out["stats"] = {
                "async_delay_hist": torch.stack([
                    (surv & (dly == k)).sum().to(torch.int32)
                    for k in range(b + 1)]),
                "async_timeouts": timeout.sum().to(torch.int32),
                "async_staleness_max": torch.where(
                    surv, dly, torch.zeros_like(dly)).max().to(torch.int32),
                "async_participated": act.clone(),  # act is a cached row
                "async_active": act.sum().to(torch.int32),
                "async_mass_mean": (a_new.sum() + inbox_a.sum()
                                    + cal_a.sum()) / n,
                "async_inflight_mass": inbox_a.sum() + cal_a.sum(),
            }
            return PushSumState(s=s_new, a=a_new)

        def close() -> tuple[Mailbox, dict[str, Any]]:
            if "mail" not in out:
                raise RuntimeError(
                    "close() before the gossip ran — open_round's gossip_fn "
                    "must be handed to dpps_step first")
            return out["mail"], out["stats"]

        return gossip_fn, close
