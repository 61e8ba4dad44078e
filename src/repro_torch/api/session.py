"""Session — the front door of the port (mirrors ``repro.api.session``).

:meth:`Session.build` owns the setup block once: the device, the (C',
lambda) calibration (unless the :class:`PrivacySpec` pins them), the
:class:`repro_torch.engine.ProtocolPlan`, the configs stamped with the
plan's choices, the partition and the node-stacked initial parameters.
``run`` drives DPPS consensus, ``train`` PartPSP training; both return a
:class:`repro_torch.api.results.RunReport`, take a
:class:`repro_torch.api.hooks.RoundHook` pipeline (``hooks=``: the privacy
ledger, the budget, metrics, the real sensitivity) and drive it as the
reference's ``_drive`` does. ``train(driver="loop")`` is the per-round
driver over the pytree runtime, the reference's oracle; ``save`` and
``restore`` write and read the full state as a resume payload, in the
reference's files and leaf names. ``serve`` runs a batched
prefill and decode on a :class:`repro_torch.models.transformer.Transformer`
and returns a :class:`repro_torch.api.results.ServeReport`; without a
topology, ``Session.build(model=...)`` builds a serve-only session. A
session built with a topology and ``model=Transformer(cfg)`` trains it
(the model's ``loss_fn`` over every node, :func:`repro_torch.core.partpsp.
node_stacked`) and serves it.

Device rule: ``device=None`` is the CUDA card and raises without one;
``device="cpu"`` runs the plain PyTorch path.

Schedules: ``"dense"``, ``"circulant"`` (chosen by default where the
topology has circulant offsets) and ``"sparse"`` (only when asked for: the
round's padded-CSR edge list, O(edges d) a round, for large networks such
as :class:`repro_torch.net.ErdosRenyiGraph`). ``faults=`` (a
:class:`repro_torch.net.FaultModel`) masks each round's weights ("dynamic"
on the dense form); ``delays=`` (a :class:`repro_torch.net.DelayModel`)
runs bounded-delay async push-sum with a message mailbox in the state.
``wire=`` (a :class:`repro_torch.wire.WireCodec`) compresses the packed
wire after the noise (the bf16 wire, int8, top-k with its error-feedback
residual in the state); the byte accounting of the report, the ledger and
the network stats follows the codec. ``PrivacySpec(mechanism=)`` swaps the
Eq. 8 Laplace draw for an audit-lab mechanism. ``profile`` runs one
segment under ``torch.profiler`` and breaks its device time down by round
phase; ``record`` appends a report to the cross-run registry
(:mod:`repro_torch.obs`).

``run`` / ``train`` take ``start=`` as the reference's do, but the port
reads the first round from the state's counter: ``start`` may only repeat
it (the reference folds that counter into its noise key too, so both runs
continue the same stream).

Typical use::

    session = Session.build(DOutGraph(n_nodes=10, d=2), schedule="dense",
                            privacy=PrivacySpec(b=5.0, gamma_n=1e-3))
    report = session.run(200, values=private_values)
    consensus = session.consensus(report.state)
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch.api.hooks import (RoundHook, RunAbort, RunContext,
                                   capture_rows, hook_trace_spec)
from repro_torch.api.results import RunReport, ServeReport, estimate_wire_bytes
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.dpps import (
    DPPSConfig,
    DPPSState,
    dpps_consensus,
    dpps_init,
    is_sync_round,
)
from repro_torch.core.partition import Partition
from repro_torch.core.partpsp import (
    PartPSPConfig,
    PartPSPState,
    consensus_params,
    make_baseline_config,
    node_stacked,
    partpsp_init,
    partpsp_step,
)
from repro_torch.core.topology import Topology, calibrate_constants
from repro_torch.core.tree_utils import PyTree, tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.engine import ProtocolPlan, run_decode, run_dpps, run_partpsp
from repro_torch.engine.rounds import (_async_merge, _check_async,
                                       _ensure_mail, _round, run_segments)

__all__ = ["PrivacySpec", "ProtocolSession", "Session"]


@dataclasses.dataclass(frozen=True)
class PrivacySpec:
    """The privacy side of a session. ``c_prime`` / ``lam`` default to
    ``None``: calibrated to the topology by :func:`calibrate_constants`."""

    b: float = 5.0
    gamma_n: float = 1.0
    noise: bool = True
    c_prime: float | None = None
    lam: float | None = None
    sensitivity_mode: str = "estimated"
    fixed_sensitivity: float = 0.0
    # a repro_torch.audit.mechanisms.NoiseMechanism or its name; None keeps
    # the built-in draw (bit for bit LaplaceMechanism())
    mechanism: Any = None

    def resolve_mechanism(self) -> Any:
        if isinstance(self.mechanism, str):
            from repro_torch.audit.mechanisms import get_mechanism

            return get_mechanism(self.mechanism)
        return self.mechanism


def _to_device(tree: PyTree, device: torch.device) -> PyTree:
    return tree_map(lambda x: torch.as_tensor(x).to(device), tree)


def _with_t(state: Any, fn: Callable) -> Any:
    """``state`` with its DPPS round counter replaced by ``fn(t)`` (a
    PartPSP or a DPPS state; anything else unchanged)."""
    if isinstance(state, PartPSPState):
        return state._replace(dpps=_with_t(state.dpps, fn))
    if isinstance(state, DPPSState):
        return state._replace(t=fn(state.t))
    return state


def _first_round(start: int | None, t: int) -> int:
    """The run's first round: the state's counter ``t``; ``start`` (the
    reference's argument) may only repeat it."""
    if start is not None and start != t:
        raise ValueError(
            f"start={start} is not the state's round counter t={t}: the port "
            "reads the first round (and the noise, fault and delay streams) "
            "from the state; pass start=None or start=state.t")
    return t


def host_array(v: Any) -> np.ndarray:
    """A trajectory row on the host. numpy has no bf16: a bf16 row (the
    tapped messages of a bf16 wire) comes back as the f32 of its values."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    v = v.detach()
    if v.dtype == torch.bfloat16:
        v = v.to(torch.float32)
    return v.cpu().numpy()


def _host(traj: dict[str, Any]) -> dict[str, np.ndarray]:
    return {k: host_array(v) for k, v in traj.items()}


@dataclasses.dataclass(frozen=True, eq=False)
class ProtocolSession:
    """A frozen, fully derived protocol deployment (see module docstring).
    A serve-only session has no topology, plan or protocol configs."""

    topology: Topology | None
    plan: ProtocolPlan | None
    cfg: DPPSConfig | None               # resolved consensus/protocol config
    train_cfg: PartPSPConfig | None      # resolved training config
    partition: Partition | None
    loss_fn: Callable | None
    init_params: PyTree | None           # node-stacked initial parameters
    seed: int
    algorithm: str
    n_nodes: int
    device: torch.device
    model: Any = None                    # the servable model, if any
    mechanism: Any = None                # the noise mechanism (None: Laplace)

    @classmethod
    def build(
        cls,
        topology: Topology | None = None,
        privacy: PrivacySpec | None = None,
        plan: ProtocolPlan | None = None,
        model: Any = None,
        partition: Any = None,
        *,
        params: PyTree | None = None,
        params_stacked: PyTree | None = None,
        algorithm: str = "partpsp",
        gamma_l: float = 0.05,
        gamma_s: float = 0.05,
        clip: float = 100.0,
        schedule: str | None = None,
        sync_interval: int | str | None = None,
        use_kernels: bool | None = None,
        chunk: int = 50,
        packed: bool = True,
        seed: int = 0,
        device: str | torch.device | None = None,
        faults: Any = None,
        delays: Any = None,
        wire: Any = None,
        wire_dtype: str = "f32",
        mesh: Any = None,
    ) -> "ProtocolSession":
        """Derive a session from topology + privacy + deployment choices.

        ``model`` is one of:

        * a loss ``loss_fn(params, batch) -> (N,)`` over node-stacked params
          and batch (a bare callable), which makes the session trainable;
        * a model with a single-node ``loss_fn(params, batch)`` (a
          :class:`Transformer`): the session trains it through
          :func:`node_stacked`, as the reference vmaps it; with ``prefill``
          / ``init_cache`` / ``decode_step`` it also serves;
        * a servable model without a topology: a serve-only session.

        ``params`` are single-node, broadcast to every node as a view (no
        copy: every node starts from the same values, and each round writes
        new tensors); pass ``params_stacked`` when they already carry the
        node axis. Without either, a trainable model's ``init`` (from a
        ``torch.Generator`` on the session's device seeded with ``seed``)
        is broadcast so. ``partition`` is a :class:`Partition` or a rules
        tuple (unmatched leaves stay local; ``None`` shares every leaf).
        ``packed=False`` runs the engine over the pytree runtime. ``seed``
        keys the noise stream (and the fault and delay streams).
        ``faults`` / ``delays`` (:class:`repro_torch.net.FaultModel` /
        :class:`repro_torch.net.DelayModel`) go to the derived plan; an
        inactive model is dropped. ``wire`` (a
        :class:`repro_torch.wire.WireCodec`) and the older ``wire_dtype``
        go there too: the messages are encoded after the noise, and an
        identity codec is dropped, so the run is the raw f32 one bit for
        bit. None of the three may come beside an explicit ``plan=``.
        ``mesh`` (a ``DeviceMesh``) goes to the derived plan, which checks
        that its gossip shards divide the node count; the sharded runs are
        :func:`repro_torch.engine.shard_run_dpps` / ``shard_run_partpsp``.
        """
        dev = resolve_device(device) if plan is None else plan.device
        if topology is None:
            if not hasattr(model, "prefill"):
                raise ValueError("Session.build needs a topology, or a "
                                 "servable model= for a serve-only session")
            return cls(topology=None, plan=None, cfg=None, train_cfg=None,
                       partition=None, loss_fn=None, init_params=None,
                       seed=int(seed), algorithm=algorithm, n_nodes=0,
                       device=dev, model=model)
        spec = PrivacySpec() if privacy is None else privacy
        n_nodes = topology.n_nodes
        if spec.c_prime is None or spec.lam is None:
            cal_c, cal_l = calibrate_constants(topology)
        c_prime = spec.c_prime if spec.c_prime is not None else cal_c
        lam = spec.lam if spec.lam is not None else cal_l
        if plan is None:
            plan = ProtocolPlan.from_topology(
                topology, schedule=schedule, use_kernels=use_kernels,
                sync_interval=sync_interval, chunk=chunk, packed=packed,
                device=dev, faults=faults, delays=delays,
                wire_dtype=wire_dtype, wire=wire, mesh=mesh)
        else:
            for name, given in (("faults", faults), ("delays", delays)):
                if given is not None:
                    raise ValueError(
                        f"pass {name}= either to Session.build (plan "
                        "derived) or to ProtocolPlan.from_topology — not "
                        "alongside an explicit plan=, which already fixed "
                        "the schedule")
            if wire is not None and getattr(wire, "active", False):
                raise ValueError(
                    "pass wire= either to Session.build (plan derived) or "
                    "to ProtocolPlan.from_topology — not alongside an "
                    "explicit plan=, which already fixed the wire format")
        cfg_sync = sync_interval if isinstance(sync_interval, int) else 0

        train_cfg = part = stacked = None
        if hasattr(model, "loss_fn"):
            loss_fn = node_stacked(model.loss_fn)
        else:
            loss_fn = model if callable(model) else None
        if loss_fn is not None:
            train_cfg = make_baseline_config(
                algorithm, gamma_l=gamma_l, gamma_s=gamma_s, clip=clip,
                b=spec.b, gamma_n=spec.gamma_n, c_prime=c_prime, lam=lam,
                # "dynamic" is the drivers' schedule: the round mixes dense
                schedule=("dense" if plan.schedule == "dynamic"
                          else plan.schedule), sync_interval=cfg_sync,
                sensitivity_mode=spec.sensitivity_mode)
            dpps = train_cfg.dpps
            if not spec.noise and algorithm != "sgp":
                dpps = dataclasses.replace(dpps, noise=False)
            if spec.sensitivity_mode == "fixed" and algorithm != "pedfl":
                dpps = dataclasses.replace(
                    dpps, fixed_sensitivity=spec.fixed_sensitivity)
            train_cfg = plan.resolve_partpsp(
                dataclasses.replace(train_cfg, dpps=dpps))
            cfg = train_cfg.dpps
            if params is None and params_stacked is None \
                    and hasattr(model, "init"):
                params = model.init(
                    torch.Generator(device=dev).manual_seed(int(seed)),
                    device=dev)
            if params_stacked is not None:
                stacked = _to_device(params_stacked, dev)
            elif params is not None:
                stacked = tree_map(
                    lambda x: x[None].expand((n_nodes,) + tuple(x.shape)),
                    _to_device(params, dev))
            if stacked is not None:
                rules = ((".*", "shared"),) if partition is None else partition
                part = (rules if isinstance(rules, Partition) else
                        Partition.from_rules(stacked, tuple(rules),
                                             default="local"))
        else:
            cfg = plan.resolve_dpps(DPPSConfig(
                b=spec.b, gamma_n=spec.gamma_n, noise=spec.noise,
                c_prime=c_prime, lam=lam, sync_interval=cfg_sync,
                sensitivity_mode=spec.sensitivity_mode,
                fixed_sensitivity=spec.fixed_sensitivity))
        return cls(topology=topology, plan=plan, cfg=cfg, train_cfg=train_cfg,
                   partition=part, loss_fn=loss_fn, init_params=stacked,
                   seed=int(seed), algorithm=algorithm, n_nodes=n_nodes,
                   device=dev, model=model,
                   mechanism=spec.resolve_mechanism())

    # -- state ---------------------------------------------------------------

    def _attach_mail(self, state: DPPSState) -> DPPSState:
        """An async session's states carry their (empty) mailbox from round
        0, and a stateful codec's their zero residual, so a fresh state and
        a restore template have one structure."""
        delays = self.plan.delays
        if delays is not None and not state.mail:
            state = state._replace(mail=delays.init_mailbox(state.push.s))
        codec = self.plan.wire
        if codec is not None and codec.stateful \
                and not isinstance(state.resid, torch.Tensor):
            d_s = sum(x[0].numel() for x in tree_leaves(state.push.s))
            state = state._replace(resid=torch.zeros(
                (self.n_nodes, d_s), dtype=torch.float32, device=self.device))
        return state

    def consensus_state(self, values: PyTree) -> DPPSState:
        """Protocol state over per-node private ``values`` (node-stacked)."""
        return self._attach_mail(dpps_init(_to_device(values, self.device),
                                           self.cfg))

    def _fresh_train_state(self) -> PartPSPState:
        if self.partition is None or self.init_params is None:
            raise ValueError("training needs model= and params= at build time")
        return partpsp_init(self.init_params, self.partition, self.train_cfg)

    def train_state(self) -> PartPSPState:
        """Fresh PartPSP state from the session's initial parameters."""
        state = self._fresh_train_state()
        return state._replace(dpps=self._attach_mail(state.dpps))

    def consensus(self, state: DPPSState) -> PyTree:
        """Protocol output s-bar (Alg. 1 Output) of a consensus run."""
        return dpps_consensus(state)

    def consensus_view(self, state: PartPSPState, node: int = 0) -> PyTree:
        """Network-average shared params merged with ``node``'s local ones."""
        return tree_map(lambda x: x[node],
                        consensus_params(state, self.partition))

    def save_consensus(self, path: str, state: PartPSPState, *,
                       step: int = 0, metadata: dict | None = None) -> None:
        """Persist the protocol's output for serving: s-bar and node 0's
        local params (:meth:`consensus_view`), a single-node params tree
        that :func:`repro_torch.checkpoint.load_checkpoint` restores into a
        fresh model's (and the reference's loader too)."""
        save_checkpoint(path, self.consensus_view(state, 0), step=step,
                        metadata=metadata)

    def save(self, path: str, state: Any, *, step: int = 0,
             metadata: dict | None = None) -> None:
        """Persist a full protocol or training state (the resume payload):
        the leaves under the reference's names (``.dpps/.push/.s/0``, ...,
        ``.dpps/.t``, ``.local/0``, ...), the round counter as the int32 0-d
        array the reference writes."""
        save_checkpoint(path, _with_t(state, lambda t: np.asarray(
            t, dtype=np.int32)), step=step, metadata=metadata)

    def restore(self, path: str, template: Any = None) -> tuple[Any, dict]:
        """Restore a state written by :meth:`save` (or by the reference's
        ``Session.save``) into ``template``'s structure (default: a fresh
        :meth:`train_state`), on the session's device -> (state, meta). The
        round counter comes back as the host int the drivers fold into the
        noise stream, so a restored run continues the same Philox stream."""
        if template is None:
            template = self.train_state()
        state, meta = load_checkpoint(path, template, device=self.device)
        return _with_t(state, lambda t: int(t)), meta

    # -- drivers -------------------------------------------------------------

    @property
    def _protected(self) -> bool:
        return bool(self.cfg.noise and self.cfg.gamma_n > 0)

    def epsilon_spent(self, rounds: int, *, start: int = 0) -> float:
        """Composed epsilon of rounds [start, start + rounds) (sync rounds
        spend none)."""
        if not self._protected or rounds <= 0:
            return 0.0
        protected = sum(1 for t in range(start, start + rounds)
                        if not is_sync_round(t, self.cfg.sync_interval))
        return protected * self.cfg.epsilon_per_round

    def _context(self, rounds: int, algorithm: str,
                 d_s: int = 0) -> RunContext:
        return RunContext(cfg=self.cfg, plan=self.plan, n_nodes=self.n_nodes,
                          rounds=rounds, algorithm=algorithm,
                          protected=self._protected, d_s=d_s)

    def _drive(self, segments: Iterator, hooks: tuple, d_s: int,
               start: int) -> RunReport:
        """The shared host loop, as the reference's ``_drive``: hooks
        consume each segment's trajectory (host numpy) at its boundary; a
        :class:`RunAbort` from a hook stops the run, and the report carries
        the rounds done with ``aborted=True``; every hook's ``finish`` runs
        in a ``finally`` and its ``finish_run`` once the report exists.

        The first segment's wall time (it includes the kernels' build or
        load on first use) is ``compile_s``, everything after ``run_s``.
        The card is synchronized at the first segment's end, at every
        segment's end where a hook consumes (it reads the rows on the host)
        and, for a hook with ``segment_span``, before each boundary is
        stamped; otherwise the rows stay on the card until the run ends.
        """
        t_start = time.perf_counter()
        compile_s = 0.0
        trajs: list[dict[str, Any]] = []
        state, done, aborted, reason = None, start, False, None
        span_hooks = [h for h in hooks if hasattr(h, "segment_span")]
        seg_start = t_start
        try:
            for t0, n, state, traj in segments:
                done = t0 + n
                first = not trajs
                exec_end = None
                if first or span_hooks:
                    self._sync()
                    exec_end = time.perf_counter()
                    if first:
                        compile_s = exec_end - t_start
                if hooks:
                    traj = _host(traj)
                trajs.append(traj)
                for h in hooks:
                    h.consume(traj, t0=t0)
                if span_hooks:
                    consume_end = time.perf_counter()
                    for h in span_hooks:
                        h.segment_span(t0=t0, n=n, start=seg_start,
                                       execute_end=exec_end,
                                       consume_end=consume_end,
                                       compiled=first)
                    seg_start = consume_end
        except RunAbort as e:
            aborted, reason = True, str(e)
        finally:
            for h in hooks:
                h.finish()
        trajs = [_host(t) for t in trajs]
        trajectory = ({k: np.concatenate([t[k] for t in trajs])
                       for k in trajs[0]} if trajs else {})
        executed = done - start
        network = None
        for h in hooks:
            stats_fn = getattr(h, "network_stats", None)
            if stats_fn is not None:
                network = stats_fn()
        report = RunReport(
            state=state, trajectory=trajectory, rounds=executed,
            epsilon_spent=self.epsilon_spent(executed, start=start),
            wire_bytes=estimate_wire_bytes(self.plan, self.n_nodes, d_s,
                                           executed),
            compile_s=compile_s,
            run_s=time.perf_counter() - t_start - compile_s, aborted=aborted,
            abort_reason=reason, network=network)
        for h in hooks:
            finish_run = getattr(h, "finish_run", None)
            if finish_run is not None:
                finish_run(report)
        return report

    def run(self, rounds: int, *, values: PyTree | None = None,
            state: DPPSState | None = None,
            eps_at: Callable[[int], PyTree] | None = None,
            bits_at: Callable[[int], Any] | None = None,
            hooks: Iterable[RoundHook] = (), start: int | None = None,
            fault_draws_at: Callable[[int], Any] | None = None,
            delay_draws_at: Callable[[int], Any] | None = None,
            wire_draws_at: Callable[[int], Any] | None = None,
            noise_draws_at: Callable[[int], Any] | None = None) -> RunReport:
        """``rounds`` DPPS rounds from ``values`` (fresh) or ``state``.

        ``eps_at(t)`` gives the perturbation tree of round t (``None``:
        pure consensus). ``bits_at(t)`` feeds explicit noise bits instead of
        the seeded Philox stream (tests only): the (N, d_s) uint32 wire row,
        or, under ``packed=False``, one tensor a leaf. ``fault_draws_at(t)``
        / ``delay_draws_at(t)`` feed a round's fault or delay draws
        (:class:`repro_torch.net.FaultDraws` / ``DelayDraws``; tests only);
        ``wire_draws_at(t)`` the int8 codecs' (N, d_s) uniforms and
        ``noise_draws_at(t)`` the (N, d_s) unit draws of a noise row drawn
        outside the fused perturbation (a mechanism's; tests
        only). ``hooks`` consume at every segment boundary. ``start`` (None:
        the state's counter) must equal the state's counter.
        """
        if self.plan is None:
            raise ValueError("run() needs a session built with a topology")
        if state is None:
            if values is None:
                raise ValueError("run() needs values= (fresh) or state=")
            # no mailbox yet: the drivers attach an async run's empty one,
            # which then dies with the first round instead of staying held
            # here (three buffers of the state's size at B = 2)
            state = dpps_init(_to_device(values, self.device), self.cfg)
        start = _first_round(start, state.t)
        hooks = tuple(hooks)
        d_s = sum(x[0].numel() for x in tree_leaves(state.push.s))
        for h in hooks:
            h.prepare(self._context(rounds, "dpps", d_s))

        segments = run_segments(
            self.consensus_runner(hooks), state, eps_at, self.seed,
            steps=rounds, chunk=self.plan.chunk, start=start,
            bits_at=bits_at, fault_draws_at=fault_draws_at,
            delay_draws_at=delay_draws_at, wire_draws_at=wire_draws_at,
            noise_draws_at=noise_draws_at)
        return self._drive(segments, hooks, d_s, start)

    def train(self, rounds: int, batch_at: Callable[[int], Any], *,
              state: PartPSPState | None = None,
              bits_at: Callable[[int], Any] | None = None,
              hooks: Iterable[RoundHook] = (), start: int | None = None,
              driver: str = "engine",
              fault_draws_at: Callable[[int], Any] | None = None,
              delay_draws_at: Callable[[int], Any] | None = None,
              wire_draws_at: Callable[[int], Any] | None = None,
              noise_draws_at: Callable[[int], Any] | None = None
              ) -> RunReport:
        """``rounds`` PartPSP rounds (Alg. 2); ``batch_at(t)`` gives round
        t's node-stacked batch.

        ``driver="engine"`` runs ``plan.chunk``-round segments through
        :func:`repro_torch.engine.run_partpsp`; ``driver="loop"`` the
        per-round driver over the pytree runtime (one-round segments,
        whatever ``plan.packed`` says), the reference's oracle. Both draw
        round t's noise, faults and delays from ``(seed, t)``, so their
        trajectories agree. The loop refuses a wire codec and the bf16
        wire (the pytree runtime carries the raw f32 wire). ``start`` and
        the ``*_draws_at`` seams are as in :meth:`run`.
        """
        if self.loss_fn is None:
            raise ValueError("training needs a topology and a loss model= at "
                             "build time")
        if driver not in ("engine", "loop"):
            raise ValueError(f"unknown driver {driver!r}")
        if state is None:
            state = self._fresh_train_state()  # no mailbox: as in run()
        start = _first_round(start, state.dpps.t)
        hooks = tuple(hooks)
        d_s = self.partition.d_shared()
        for h in hooks:
            h.prepare(self._context(rounds, self.algorithm, d_s))

        if driver == "loop":
            stream = self._loop_segments(state, batch_at, rounds, start,
                                         hooks, bits_at, fault_draws_at,
                                         delay_draws_at, noise_draws_at)
        else:
            stream = run_segments(
                self.segment_runner(hooks), state, batch_at, self.seed,
                steps=rounds, chunk=self.plan.chunk, start=start,
                bits_at=bits_at, fault_draws_at=fault_draws_at,
                delay_draws_at=delay_draws_at, wire_draws_at=wire_draws_at,
                noise_draws_at=noise_draws_at)
        return self._drive(stream, hooks, d_s, start)

    def _loop_segments(self, state: PartPSPState, batch_at, rounds: int,
                       start: int, hooks: tuple, bits_at, fault_draws_at,
                       delay_draws_at, noise_draws_at):
        """The per-round driver as a stream of one-round segments: the
        pytree runtime (no packed layout) with each round's mixing operands,
        so time-varying topologies rotate, realized by the plan's faults and
        run through its delays' mailbox as the engine does, and the hooks'
        captures merged through :func:`capture_rows` on each round's
        diagnostics."""
        spec = hook_trace_spec(hooks)
        plan = self.plan
        if plan.wire is not None:
            raise ValueError(
                f"the loop driver runs the pytree path; wire codec "
                f"{plan.wire.name!r} needs the packed buffer — use "
                f"driver='engine'")
        if self.train_cfg.dpps.wire_dtype != "f32":
            raise ValueError("the loop driver runs the pytree path; "
                             "wire_dtype='bf16' needs driver='engine'")
        asynchronous = _check_async(plan, self.train_cfg.dpps)
        st = state._replace(dpps=_ensure_mail(state.dpps, plan,
                                              asynchronous))
        for t in range(start, start + rounds):
            with torch.no_grad():
                kwargs, net, close = _round(
                    plan, st.dpps, t, self.seed, asynchronous=asynchronous,
                    with_adjacency=spec.needs_adjacency,
                    fault_draws_at=fault_draws_at,
                    delay_draws_at=delay_draws_at)
                st, m = partpsp_step(
                    st, batch_at(t), cfg=self.train_cfg,
                    partition=self.partition, loss_fn=self.loss_fn,
                    layout=None, seed=self.seed,
                    bits=bits_at(t) if bits_at else None,
                    return_s_half=spec.needs_s_half,
                    return_wire_stats=spec.needs_wire_stats,
                    mechanism=self.mechanism, tap=spec.tap,
                    noise_draws=noise_draws_at(t) if noise_draws_at else None,
                    **kwargs)
                if close is not None:
                    st = st._replace(dpps=_async_merge(
                        st.dpps, m, close, spec.needs_wire_stats))
                if net is not None:
                    m.update(net)
                rows = capture_rows(m, hooks)
            yield t, 1, st, {k: v[None] for k, v in rows.items()}

    # -- the runners the drivers call ----------------------------------------

    def _cached_runner(self, kind: str, hooks: tuple, build: Callable):
        """One runner a (kind, hook pipeline), built once: the key holds
        the hook objects themselves, as the reference's does."""
        cache = self.__dict__.get("_runners")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_runners", cache)
        key = (kind, hooks)
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def consensus_runner(self, hooks: Iterable[RoundHook] = ()) -> Callable:
        """The segment function :meth:`run` drives: :func:`repro_torch.
        engine.run_dpps` bound to the session's configs, plan, mechanism
        and ``hooks``; call it ``(state, eps_at, rounds=, seed=, ...)``.
        The reference's is jitted with its state donated; this one is the
        plain function (the drivers never write into the state they are
        given)."""
        if self.plan is None:
            raise ValueError("consensus_runner() needs a session built with "
                             "a topology")
        hooks = tuple(hooks)
        return self._cached_runner("dpps", hooks, lambda: functools.partial(
            run_dpps, cfg=self.cfg, plan=self.plan, hooks=hooks,
            mechanism=self.mechanism))

    def segment_runner(self, hooks: Iterable[RoundHook] = ()) -> Callable:
        """The training segment function :meth:`train` drives:
        :func:`repro_torch.engine.run_partpsp` bound as
        :meth:`consensus_runner` binds ``run_dpps``; call it ``(state,
        batch_at, rounds=, seed=, ...)`` (the reference's takes the
        segment's batches stacked, :func:`repro_torch.engine.stack_rounds`;
        the port's reads round t's from ``batch_at(t)``)."""
        if self.loss_fn is None:
            raise ValueError("training needs a topology and a loss model= at "
                             "build time")
        hooks = tuple(hooks)
        return self._cached_runner("partpsp", hooks, lambda: functools.partial(
            run_partpsp, cfg=self.train_cfg, partition=self.partition,
            loss_fn=self.loss_fn, plan=self.plan, hooks=hooks,
            mechanism=self.mechanism))

    def step_fn(self, t: int = 0) -> Callable:
        """One PartPSP round over the pytree runtime with round ``t``'s
        nominal mixing operands bound (the loop driver's primitive):
        ``step(state, batch, seed=..., bits=...) -> (state, metrics)``."""
        if self.loss_fn is None:
            raise ValueError("training needs a topology and a loss model= at "
                             "build time")
        step = functools.partial(
            partpsp_step, cfg=self.train_cfg, partition=self.partition,
            loss_fn=self.loss_fn, mechanism=self.mechanism,
            **self.plan.mix_at(t))

        def run(state: PartPSPState, batch: Any, **kwargs):
            with torch.no_grad():
                return step(state, batch, **kwargs)
        return run

    # -- profiling -----------------------------------------------------------

    def profile(self, rounds: int = 50, *, values: PyTree | None = None,
                state: Any = None,
                batch_at: Callable[[int], Any] | None = None,
                hooks: Iterable[RoundHook] = (), seed: int | None = None,
                trace_dir: str | None = None):
        """Profile one segment: the wall-clock split and the per-phase
        device-time breakdown (a :class:`repro_torch.obs.ProfileReport`).

        Runs one ``min(rounds, plan.chunk)``-round segment of consensus
        (``values=`` / ``state=``) or of PartPSP training (``batch_at=``)
        under ``torch.profiler`` (CUDA activity on the card) and attributes
        its device time to the :func:`repro_torch.obs.phase` ranges
        (:func:`repro_torch.obs.trace.phase_breakdown`). ``seed`` keys the
        noise stream (default: the session's), as the reference's ``key``.
        ``hooks`` shape the run through their captures, as in :meth:`run`;
        their ``consume`` does not run. The passed state is not changed.

        ``note`` says so when the trace holds fewer of the port's kernels
        than the segment launched: the profiler drops device events in a
        process that has run for a while (PERF.md §7), and the breakdown
        is then partial.
        Eager PyTorch traces nothing, so ``trace_s`` is 0.0; ``compile_s``
        is one warm-up round (it builds and loads the kernels on first
        use), ``execute_s`` the profiled segment. The drivers never write
        into the state they are given, so the warm-up runs from the passed
        state itself and its result is dropped: a copy would cost another
        state's memory (20 GB for llama3.2-1b's training state at N = 4).
        ``trace_dir`` keeps the profiler's Chrome trace there
        (``trace.json``).
        """
        from repro_torch.kernels import ops as kops
        from repro_torch.obs.trace import ProfileReport, phase_breakdown

        if self.plan is None:
            raise ValueError("profile() needs a session built with a "
                             "topology")
        seed = self.seed if seed is None else int(seed)
        hooks = tuple(hooks)
        n = min(rounds, self.plan.chunk)
        if batch_at is not None:
            if state is None:
                state = self._fresh_train_state()

            runner = self.segment_runner(hooks)

            def segment(st, k):
                return runner(st, batch_at, rounds=k, seed=seed)
        else:
            if state is None:
                if values is None:
                    raise ValueError("profile() needs values=/state= "
                                     "(consensus) or batch_at= (training)")
                state = dpps_init(_to_device(values, self.device), self.cfg)

            runner = self.consensus_runner(hooks)

            def segment(st, k):
                return runner(st, None, rounds=k, seed=seed)

        t0 = time.perf_counter()
        segment(state, 1)
        self._sync()
        compile_s = time.perf_counter() - t0

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        launched = sum(kops.launch_counts().values())
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=activities) as prof:
            segment(state, n)
            self._sync()
        execute_s = time.perf_counter() - t0
        launched = sum(kops.launch_counts().values()) - launched
        events = prof.events()
        phases, device_total_s, note = phase_breakdown(
            events, device=self.device.type)
        # each counted launch is at least one kernel of the port's own
        # namespace on the card: fewer in the trace means the profiler
        # dropped device events, and the breakdown is partial
        seen = sum(1 for e in events if "repro_torch::" in e.name
                   and e.device_type != torch.autograd.DeviceType.CPU)
        if note is None and seen < launched:
            note = (f"the profiler recorded {seen} of the segment's "
                    f"{launched} kernel launches; the breakdown is partial")
        if trace_dir is not None:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        return ProfileReport(
            rounds=n, backend=f"torch-{self.device.type}", trace_s=0.0,
            compile_s=compile_s, execute_s=execute_s, phases=phases,
            device_total_s=device_total_s, trace_dir=trace_dir, note=note)

    # -- cross-run registry --------------------------------------------------

    def _fingerprint(self) -> str:
        """A stable hash of the session's config and plan scalars: the
        registry's comparability stamp for session records (two runs with
        the same fingerprint and scale are the same deployment)."""
        import hashlib
        import json

        plan, cfg = self.plan, self.cfg
        desc = {
            "algorithm": self.algorithm,
            "n_nodes": self.n_nodes,
            "schedule": getattr(plan, "schedule", None),
            "packed": getattr(plan, "packed", None),
            "wire_dtype": getattr(plan, "wire_dtype", None),
            "chunk": getattr(plan, "chunk", None),
            "period": getattr(plan, "period", None),
            "sync_interval": getattr(cfg, "sync_interval", None),
            "b": getattr(cfg, "b", None),
            "gamma_n": getattr(cfg, "gamma_n", None),
            "noise": getattr(cfg, "noise", None),
            "faults": repr(getattr(plan, "faults", None)),
            "delays": repr(getattr(plan, "delays", None)),
            "wire": repr(getattr(plan, "wire", None)),
        }
        blob = json.dumps(desc, sort_keys=True, default=str).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def record(self, report: RunReport, *, name: str,
               history: str = "BENCH_history.jsonl",
               extra: dict[str, float] | None = None):
        """Append this run to the cross-run registry as bench
        ``session/<name>``, with the session's scale (n_nodes, d_s, rounds,
        schedule, packed, backend, algorithm) and fingerprint; ``python -m
        repro_torch.obs.registry check`` then gates later runs of the same
        deployment against it (us a round, wire bytes, epsilon). The
        backend is ``"torch-<device type>"``, so the port's records never
        share a scale key with the JAX package's. ``extra`` adds the
        caller's metrics. Returns the appended
        :class:`repro_torch.obs.registry.RunRecord`."""
        from repro_torch.obs.registry import RunRecord, append_record

        if self.plan is None:
            raise ValueError("record() needs a session built with a "
                             "topology")
        push = getattr(report.state, "push", None)
        if push is None and report.state is not None:
            push = getattr(getattr(report.state, "dpps", None), "push", None)
        d_s = 0
        if push is not None:
            d_s = sum(int(np.prod(x.shape[1:])) if x.dim() > 1 else 1
                      for x in tree_leaves(push.s))
        chunk = getattr(self.plan, "chunk", 0) or 0
        steady = max(report.rounds - chunk, 0)
        backend = f"torch-{self.device.type}"
        scale = {
            "n_nodes": self.n_nodes, "d_s": d_s,
            "rounds": report.rounds,
            "schedule": getattr(self.plan, "schedule", None),
            "packed": getattr(self.plan, "packed", None),
            "backend": backend,
            "algorithm": self.algorithm,
        }
        rec = RunRecord.from_report(
            name, report, scale=scale, fingerprint=self._fingerprint(),
            backend=backend, steady_rounds=steady, extra=extra)
        append_record(rec, history)
        return rec

    # -- serving -------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, params: PyTree, batch: dict[str, Any], *, gen: int,
              temperature: float = 1.0,
              generator: torch.Generator | None = None,
              step_inputs: torch.Tensor | None = None,
              noise_at: Callable[[int], torch.Tensor] | None = None,
              enc: torch.Tensor | None = None) -> ServeReport:
        """Batched prefill + decode of ``gen`` tokens on ``params``.

        ``batch`` holds ``tokens`` (B, S) or, for embedding-input models,
        ``embeds`` (B, S, d_model); those models also need ``step_inputs``
        (gen - 1, B, d_model). The first token is the prefill's argmax; the
        other gen - 1 are sampled by :func:`repro_torch.engine.run_decode`
        with Gumbel noise from ``generator`` (default: a generator on the
        session's device seeded with its seed) or from ``noise_at(step)``.
        ``enc`` is a cross-attention model's image embeddings (B, M,
        d_model) for the decode steps; its prefill reads them from
        ``batch["image_embeds"]``, as the reference's does.

        The reference prefills into a prompt-sized cache and grafts it into
        a prompt + gen one; the port allocates the prompt + gen cache first
        and prefill writes the prompt's K/V into it, so no second copy of
        the cache is made (2.1 GB for llama3.2-1b at a 32k prompt).
        """
        model = self.model
        if model is None or not hasattr(model, "prefill"):
            raise ValueError("serve() needs a servable model= at build time "
                             "(prefill/init_cache/decode_step)")
        ref = batch["tokens"] if "tokens" in batch else batch["embeds"]
        b, prompt_len = ref.shape[0], ref.shape[1]
        steps = gen - 1
        cfg = getattr(model, "cfg", None)
        if (getattr(cfg, "input_mode", None) == "embeddings" and steps > 0
                and step_inputs is None):
            raise ValueError("embedding-input models need step_inputs= "
                             "of shape (gen-1, B, d_model)")
        if generator is None and noise_at is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.seed)

        with torch.no_grad():
            self._sync()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, batch,
                                          capacity=prompt_len + gen)
            self._sync()
            prefill_s = time.perf_counter() - t0

            t0 = time.perf_counter()
            tok = torch.argmax(logits, dim=-1)
            if steps > 0:
                toks, cache = run_decode(
                    lambda c, step_in, pos: model.decode_step(
                        params, c, step_in, pos, enc),
                    cache, tok, start_pos=prompt_len, steps=steps,
                    temperature=temperature, step_inputs=step_inputs,
                    generator=generator, noise_at=noise_at)
                tokens = torch.cat([tok[:, None], toks.T], dim=1)
            else:
                tokens = tok[:, None]
            self._sync()
        return ServeReport(tokens=tokens, prefill_s=prefill_s,
                           decode_s=time.perf_counter() - t0, steps=steps,
                           logits=logits, cache=cache)


Session = ProtocolSession
