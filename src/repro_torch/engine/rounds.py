"""Multi-round protocol drivers, port of ``repro.engine.rounds``.

The reference scans the round with ``jax.lax.scan``; here the round is a
Python loop, since PyTorch runs eagerly. With ``plan.packed`` the shared
tree is packed into the (N, d_pad) wire buffer before the loop and
unpacked (as views) after it, as the reference does at segment
boundaries; without it the rounds run the pytree runtime.

``hooks`` (:class:`repro_torch.api.hooks.RoundHook`) attach as in the
reference: the round provides what their :class:`TraceSpec` asks for
(``s_half``, the ``wd_*`` stats) and each round's rows are merged through
``capture_rows``, which shows ``s_half`` to the hooks and never emits it.
The host side (``consume``) is the session's.

Noise: round t's bits are a pure function of ``(seed, t, node)`` (Philox,
see :mod:`repro_torch.kernels.ref`), as ``fold_in(key, t)`` makes them in
the reference, so split runs and resumed states continue the same stream.
``bits_at(t) -> (N, d_s) uint32`` feeds explicit bits instead; the
conformance tests use it to hand the port the reference's exact bits.

:func:`run_decode` is the serving loop (the reference's scan-compiled
``run_decode``), one Python iteration a token. :func:`run_segments`
drives a segment runner (``Session.consensus_runner`` /
``segment_runner``: :func:`run_dpps` / :func:`run_partpsp` bound to a
session) chunk by chunk, as ``Session.run`` / ``train`` do;
:func:`stack_rounds` stacks per-round trees for scripts that want them.

Faults (``plan.dynamic``, an active :class:`repro_torch.net.FaultModel`):
each round realizes its masked, column-renormalised W (or edge-list
values) from the nominal ones before the step, and its ``net_*`` rows join
the diagnostics (``net_adj`` only when a hook declares
``needs_adjacency``). Delays (``plan.delays``, an active
:class:`repro_torch.net.DelayModel`): the state carries a message
:class:`Mailbox` (``DPPSState.mail``, packed with the state), each round's
gossip runs through ``DelayModel.open_round`` on the realized weights, and
the ``async_*`` rows join the diagnostics. Both draw from the session seed
and the round (their own Philox streams), so the engine and the loop
driver draw the same; ``fault_draws_at(t)`` / ``delay_draws_at(t)`` feed
explicit draws instead (the tests hand over the reference's).

The private ``_gossip_builder`` / ``_node_ops`` / ``_node0`` arguments are
the seam :mod:`repro_torch.engine.shard` runs the same rounds through on
a rank's row block: the builder turns a round's mixing operands into the
collective ``gossip_fn``, the node ops reduce over every rank, and
``_node0`` (the global node of the block's first row) keys the noise.
Faults and delays are refused beside a builder, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Sequence

import torch

from repro_torch.core.dpps import (LOCAL_NODE_OPS, DPPSConfig, DPPSState,
                                   NodeOps, dpps_step)
from repro_torch.core.packing import PackedLayout
from repro_torch.core.partpsp import PartPSPConfig, PartPSPState, partpsp_step
from repro_torch.core.pushsum import PushSumState
from repro_torch.core.tree_utils import PyTree, tree_map
from repro_torch.engine.plan import ProtocolPlan
from repro_torch.obs.trace import PHASE_FAULTS, PHASE_PACK, PHASE_UNPACK, phase

__all__ = ["run_dpps", "run_partpsp", "run_decode", "run_segments",
           "stack_rounds", "gumbel", "wire_layout"]

BitsAt = Callable[[int], torch.Tensor] | None
NoiseAt = Callable[[int], torch.Tensor] | None
DrawsAt = Callable[[int], Any] | None


def wire_layout(plan: ProtocolPlan, shared: PyTree) -> PackedLayout | None:
    """The packed layout the drivers run ``shared`` under, or None for the
    pytree runtime (``plan.packed`` False). A plan's codec is checked
    against the width here (top-k's uint16 index bound), before any
    round runs."""
    if not plan.packed:
        return None
    layout = PackedLayout.from_tree(shared, lane=plan.lane)
    if plan.wire is not None:
        plan.wire.payload_bytes(layout.d_s)
    return layout


def _pack(state: DPPSState, layout: PackedLayout | None) -> DPPSState:
    """The state with its shared tree (and a mailbox's calendar and inbox,
    which mirror it) packed onto the wire rows."""
    if layout is None:
        return state
    with phase(PHASE_PACK):
        mail = state.mail
        if mail:
            mail = mail._replace(cal_s=layout.pack(mail.cal_s),
                                 inbox_s=layout.pack(mail.inbox_s))
        return state._replace(push=PushSumState(s=layout.pack(state.push.s),
                                                a=state.push.a), mail=mail)


def _unpack(state: DPPSState, layout: PackedLayout | None) -> DPPSState:
    if layout is None:
        return state
    with phase(PHASE_UNPACK):
        mail = state.mail
        if mail:
            mail = mail._replace(cal_s=layout.unpack(mail.cal_s),
                                 inbox_s=layout.unpack(mail.inbox_s))
        return state._replace(
            push=PushSumState(s=layout.unpack(state.push.s), a=state.push.a),
            mail=mail)


def _check_dynamic(plan: ProtocolPlan, gossip_builder) -> None:
    """Refuse a fault-masked plan beside a gossip builder (the reference's
    ``_check_dynamic``)."""
    if plan.dynamic and gossip_builder is not None:
        raise NotImplementedError(
            "fault injection (ProtocolPlan.dynamic) is not implemented for "
            "the sharded engine's collective gossip — static plans shard "
            "(including schedule='sparse'), fault-masked ones do not; run "
            "the fault study on the single-device engine (schedule='sparse' "
            "masks the edge list without stacking dense (T, N, N) weights), "
            "or detach the FaultModel on the mesh")


def _check_async(plan: ProtocolPlan, cfg: DPPSConfig,
                 gossip_builder=None) -> bool:
    """Whether the run carries a mailbox (``plan.delays``); ``cfg`` is
    plan-resolved."""
    if plan.delays is None:
        return False
    if gossip_builder is not None:
        raise NotImplementedError(
            "bounded-delay async gossip (ProtocolPlan.delays) is not "
            "implemented for the sharded engine's collective gossip; run "
            "the async study on the single-device engine, or detach the "
            "DelayModel on the mesh")
    if cfg.wire_dtype != "f32":
        what = (f"wire codec {plan.wire.name!r}" if plan.wire is not None
                else "bf16 wire (wire_dtype='bf16')")
        raise NotImplementedError(
            f"{what} does not compose with the async mailbox runtime: the "
            "mailbox calendars accumulate in-flight mass in f32. Value "
            "codecs (int8, topk:K) DO compose — they encode the payload "
            "before it is enqueued and the calendars stay f32 — so use "
            "one of those, or drop to the raw f32 wire")
    if cfg.sync_interval > 0:
        raise ValueError(
            "sync_interval > 0 with an active DelayModel would average "
            "node states while message mass is still in flight (breaking "
            "conservation); use sync_interval=0")
    return True


def _ensure_mail(state: DPPSState, plan: ProtocolPlan,
                 asynchronous: bool) -> DPPSState:
    """Attach an empty mailbox to an async run's state (a resumed one keeps
    its own); refuse a mailbox on a synchronous run."""
    if asynchronous:
        if not state.mail:
            state = state._replace(mail=plan.delays.init_mailbox(state.push.s))
        return state
    if state.mail:
        raise ValueError(
            "state carries an async Mailbox but the plan has no active "
            "DelayModel — running it synchronously would abandon the "
            "in-flight message mass; keep the DelayModel on the plan (or "
            "drain the mailbox by finishing the async run first)")
    return state


def _ensure_resid(state: DPPSState, plan: ProtocolPlan,
                  layout: PackedLayout | None) -> DPPSState:
    """Attach a stateful codec's zero (N, d_s) residual (a resumed state
    keeps its own); refuse a residual on a run whose codec carries none."""
    codec = plan.wire
    if codec is not None and codec.stateful:
        if layout is None:
            raise ValueError(
                f"wire codec {codec.name!r} needs the packed layout; "
                "build the plan with packed=True")
        if not isinstance(state.resid, torch.Tensor):
            state = state._replace(resid=torch.zeros(
                (state.push.a.shape[0], layout.d_s), dtype=torch.float32,
                device=state.push.a.device))
        return state
    if isinstance(state.resid, torch.Tensor):
        raise ValueError(
            "state carries an error-feedback residual but the plan's wire "
            "codec is not stateful — running it would silently drop the "
            "carried compression error; keep the top-k codec on the plan, "
            "or discard the residual explicitly with "
            "state._replace(resid=())")
    return state


def _realize_faults(plan: ProtocolPlan, kwargs: dict[str, Any], t: int,
                    seed: int, with_adjacency: bool,
                    fault_draws_at: DrawsAt) -> dict[str, Any]:
    """Replace the round's nominal weights in ``kwargs`` by the realized
    ones; return the round's ``net_*`` rows."""
    draws = fault_draws_at(t) if fault_draws_at else None
    with phase(PHASE_FAULTS):
        if "sparse_idx" in kwargs:
            vals, net = plan.faults.realize_sparse(
                kwargs["sparse_idx"], kwargs["sparse_vals"], t, seed=seed,
                draws=draws, with_adjacency=with_adjacency)
            kwargs["sparse_vals"] = vals
            return net
        w, net = plan.faults.realize(kwargs["w"], t, seed=seed, draws=draws,
                                     with_adjacency=with_adjacency)
        kwargs["w"] = w
        return net


def _open_async(plan: ProtocolPlan, kwargs: dict[str, Any],
                push: PushSumState, mail, t: int, seed: int,
                delay_draws_at: DrawsAt):
    """Swap the round's mixing operands (after :func:`_realize_faults`) for
    the DelayModel's ``gossip_fn``; return its ``close``."""
    mix = {name: kwargs.pop(name)
           for name in ("w", "sparse_idx", "sparse_vals") if name in kwargs}
    gossip_fn, close = plan.delays.open_round(
        push, mail, t, seed=seed,
        draws=delay_draws_at(t) if delay_draws_at else None,
        use_kernels=plan.use_kernels, **mix)
    kwargs["gossip_fn"] = gossip_fn
    return close


def _async_merge(st: DPPSState, diag: dict[str, Any], close,
                 needs_wire_stats: bool) -> DPPSState:
    """Fold the round's mailbox and ``async_*`` rows back in."""
    mail, stats = close()
    diag.update(stats)
    if needs_wire_stats:
        # under delays the conserved mass is state + inbox + calendar
        diag["wd_mass_drift"] = (stats["async_mass_mean"] - 1.0).abs()
    return st._replace(mail=mail)


def _round(plan: ProtocolPlan, st: DPPSState, t: int, seed: int, *,
           asynchronous: bool, with_adjacency: bool,
           fault_draws_at: DrawsAt, delay_draws_at: DrawsAt,
           gossip_builder=None, node_ops: NodeOps = LOCAL_NODE_OPS,
           node0: int = 0):
    """Round t's mixing and reduction kwargs for the step (realized, a
    mailbox's ``gossip_fn`` or a builder's), the ``net_*`` rows (or None)
    and the async ``close`` (or None)."""
    kwargs = plan.mix_at(t)
    net = close = None
    if gossip_builder is not None:  # no faults or delays beside it
        kwargs = dict(gossip_fn=gossip_builder(kwargs))
    else:
        net = (_realize_faults(plan, kwargs, t, seed, with_adjacency,
                               fault_draws_at) if plan.dynamic else None)
        close = (_open_async(plan, kwargs, st.push, st.mail, t, seed,
                             delay_draws_at) if asynchronous else None)
    kwargs.update(node_ops=node_ops, node0=node0)
    return kwargs, net, close


def _hooks(hooks: Sequence[Any]):
    """(capture merge, TraceSpec) of a hook pipeline (``repro_torch.api``
    imports this module, so its hooks are imported here, late)."""
    from repro_torch.api.hooks import capture_rows, hook_trace_spec

    hooks = tuple(hooks)
    return (lambda diag: capture_rows(diag, hooks)), hook_trace_spec(hooks)


def _stack(rows: list[dict[str, Any]]) -> dict[str, torch.Tensor]:
    if not rows:
        return {}
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def _draws(wire_draws_at: DrawsAt, noise_draws_at: DrawsAt,
           t: int) -> dict[str, Any]:
    return dict(wire_draws=wire_draws_at(t) if wire_draws_at else None,
                noise_draws=noise_draws_at(t) if noise_draws_at else None)


def stack_rounds(make_round: Callable[[int], PyTree], t0: int,
                 n: int) -> PyTree:
    """Rounds ``t0 .. t0 + n - 1`` of host-made trees stacked leaf by leaf
    on a leading (T,) axis."""
    items = [make_round(t) for t in range(t0, t0 + n)]
    return tree_map(lambda *xs: torch.stack(xs), *items)


def run_segments(run_chunk: Callable, state, batch_at: Callable[[int], Any],
                 seed: int = 0, *, steps: int, chunk: int, start: int = 0,
                 **kwargs) -> Iterator:
    """Drive a segment runner (``Session.consensus_runner`` /
    ``segment_runner``) over ``steps`` rounds in ``chunk``-round segments.

    Yields ``(t0, n, state, traj)`` after each segment: its first round,
    its length (the last may be shorter), the advanced state and its
    per-round rows, as the reference's does. The runner reads round t's
    input from ``batch_at(t)`` (``eps_at`` for consensus) where the
    reference's takes the segment's inputs stacked; ``seed`` keys the
    noise where it takes a key; ``kwargs`` go to every call (the draws
    seams)."""
    for t0 in range(start, start + steps, chunk):
        n = min(chunk, start + steps - t0)
        state, traj = run_chunk(state, batch_at, rounds=n, seed=seed,
                                **kwargs)
        yield t0, n, state, traj


def run_dpps(state: DPPSState, eps_at: Callable[[int], PyTree] | None, *,
             cfg: DPPSConfig, plan: ProtocolPlan, rounds: int, seed: int = 0,
             bits_at: BitsAt = None, hooks: Sequence[Any] = (),
             fault_draws_at: DrawsAt = None, delay_draws_at: DrawsAt = None,
             mechanism: Any = None, wire_draws_at: DrawsAt = None,
             noise_draws_at: DrawsAt = None, _gossip_builder=None,
             _node_ops: NodeOps = LOCAL_NODE_OPS, _node0: int = 0
             ) -> tuple[DPPSState, dict[str, torch.Tensor]]:
    """``rounds`` DPPS rounds from ``state``. ``eps_at(t)`` gives round t's
    perturbation tree (``None``: pure consensus, zero perturbation).
    Returns the final (unpacked) state and the per-round diagnostics, hook
    captures merged, stacked on the device (leaves (T,) / (T, N)).
    ``mechanism`` (a :class:`repro_torch.audit.mechanisms.NoiseMechanism`)
    replaces the Laplace draw; ``wire_draws_at(t)`` / ``noise_draws_at(t)``
    (tests only) feed a round's int8 uniforms / a mechanism's unit
    draws."""
    cfg = plan.resolve_dpps(cfg)
    capture, spec = _hooks(hooks)
    _check_dynamic(plan, _gossip_builder)
    asynchronous = _check_async(plan, cfg, _gossip_builder)
    extra = dict(asynchronous=asynchronous,
                 with_adjacency=spec.needs_adjacency,
                 fault_draws_at=fault_draws_at, delay_draws_at=delay_draws_at,
                 gossip_builder=_gossip_builder, node_ops=_node_ops,
                 node0=_node0)
    layout = wire_layout(plan, state.push.s)
    st = _ensure_resid(_ensure_mail(_pack(state, layout), plan,
                                    asynchronous), plan, layout)
    zeros = None
    rows = []
    with torch.no_grad():
        for _ in range(rounds):
            t = st.t
            if eps_at is None:
                if zeros is None:
                    zeros = tree_map(torch.zeros_like, st.push.s)
                eps = zeros
            else:
                eps = eps_at(t)
            kwargs, net, close = _round(plan, st, t, seed, **extra)
            st, diag = dpps_step(st, eps, cfg, layout, seed=seed,
                                 bits=bits_at(t) if bits_at else None,
                                 return_s_half=spec.needs_s_half,
                                 return_wire_stats=spec.needs_wire_stats,
                                 mechanism=mechanism, tap=spec.tap,
                                 **_draws(wire_draws_at, noise_draws_at, t),
                                 **kwargs)
            if close is not None:
                st = _async_merge(st, diag, close, spec.needs_wire_stats)
            if net is not None:
                diag.update(net)
            rows.append(capture(diag))
    return _unpack(st, layout), _stack(rows)


def run_partpsp(state: PartPSPState, batch_at: Callable[[int], Any], *,
                cfg: PartPSPConfig, partition, loss_fn, plan: ProtocolPlan,
                rounds: int, seed: int = 0, bits_at: BitsAt = None,
                hooks: Sequence[Any] = (), fault_draws_at: DrawsAt = None,
                delay_draws_at: DrawsAt = None, mechanism: Any = None,
                wire_draws_at: DrawsAt = None, noise_draws_at: DrawsAt = None,
                _gossip_builder=None, _node_ops: NodeOps = LOCAL_NODE_OPS,
                _node0: int = 0
                ) -> tuple[PartPSPState, dict[str, torch.Tensor]]:
    """``rounds`` PartPSP training rounds (Alg. 2); ``batch_at(t)`` gives
    round t's node-stacked batch. ``mechanism``, ``wire_draws_at`` and
    ``noise_draws_at`` are as in :func:`run_dpps`."""
    cfg = plan.resolve_partpsp(cfg)
    capture, spec = _hooks(hooks)
    _check_dynamic(plan, _gossip_builder)
    asynchronous = _check_async(plan, cfg.dpps, _gossip_builder)
    extra = dict(asynchronous=asynchronous,
                 with_adjacency=spec.needs_adjacency,
                 fault_draws_at=fault_draws_at, delay_draws_at=delay_draws_at,
                 gossip_builder=_gossip_builder, node_ops=_node_ops,
                 node0=_node0)
    layout = wire_layout(plan, state.dpps.push.s)
    st = state._replace(dpps=_ensure_resid(_ensure_mail(
        _pack(state.dpps, layout), plan, asynchronous), plan, layout))
    rows = []
    with torch.no_grad():
        for _ in range(rounds):
            t = st.dpps.t
            kwargs, net, close = _round(plan, st.dpps, t, seed, **extra)
            st, metrics = partpsp_step(
                st, batch_at(t), cfg=cfg, partition=partition,
                loss_fn=loss_fn, layout=layout, seed=seed,
                bits=bits_at(t) if bits_at else None,
                return_s_half=spec.needs_s_half,
                return_wire_stats=spec.needs_wire_stats,
                mechanism=mechanism, tap=spec.tap,
                **_draws(wire_draws_at, noise_draws_at, t), **kwargs)
            if close is not None:
                st = st._replace(dpps=_async_merge(
                    st.dpps, metrics, close, spec.needs_wire_stats))
            if net is not None:
                metrics.update(net)
            rows.append(capture(metrics))
    return st._replace(dpps=_unpack(st.dpps, layout)), _stack(rows)


def gumbel(generator: torch.Generator, shape: tuple[int, ...],
           device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform on [tiny, 1), as
    ``jax.random.gumbel`` forms it (from other uniforms: a torch generator
    and a JAX key give different numbers)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min_(torch.finfo(u.dtype).tiny)))


def run_decode(decode_fn: Callable, cache: PyTree, tok0: torch.Tensor, *,
               start_pos: int, steps: int, temperature: float = 1.0,
               step_inputs: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               noise_at: NoiseAt = None) -> tuple[torch.Tensor, PyTree]:
    """Autoregressive decode (the serving hot loop), one step an iteration.

    ``decode_fn(cache, step_in, pos) -> (logits (B, V), cache)``. Each step
    samples ``argmax(logits / temperature + g)`` with Gumbel noise g, which
    is what ``jax.random.categorical`` draws. g comes from ``generator`` (a
    ``torch.Generator`` on the logits' device), or from ``noise_at(step) ->
    (B, V)`` when given: the tests feed the reference's own draws through
    it. For token models the sampled token feeds back as the next
    ``step_in``; embedding models pass ``step_inputs`` (steps, B, d_model).
    Returns ((steps, B) sampled tokens, final cache).
    """
    if noise_at is None and generator is None:
        raise ValueError("run_decode needs generator= or noise_at=")
    tok, toks = tok0, []
    with torch.no_grad():
        for step in range(steps):
            step_in = tok if step_inputs is None else step_inputs[step]
            logits, cache = decode_fn(cache, step_in, start_pos + step)
            g = (noise_at(step) if noise_at is not None
                 else gumbel(generator, tuple(logits.shape), logits.device))
            tok = torch.argmax(logits / temperature + g, dim=-1)
            toks.append(tok)
    if not toks:
        return torch.empty((0, tok0.shape[0]), dtype=torch.int64,
                           device=tok0.device), cache
    return torch.stack(toks), cache
