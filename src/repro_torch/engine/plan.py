"""ProtocolPlan — deployment choices derived from the topology, port of
``repro.engine.plan``.

* Schedule: ``circulant`` whenever the topology exposes circulant offsets
  (d-Out and EXP do), unless ``schedule="dense"`` forces the paper-faithful
  ``W @ s``; ``dense`` for non-circulant topologies. ``sparse`` (only when
  asked for, never chosen automatically) mixes over each round's padded
  CSR edge list: O(edges d) a round instead of O(N^2 d), for large
  networks.
* ``dynamic``: dense with faults, selected by attaching an active
  :class:`repro_torch.net.FaultModel` (``faults=``) to a non-sparse plan.
  The nominal W is stacked as for dense, and each round masks and
  column-renormalises it (``FaultModel.realize``). A sparse plan with
  faults stays ``sparse`` and masks its edge list in place
  (``FaultModel.realize_sparse``); no dense W is stacked. An inactive
  model is dropped: the plan is the fault-free one.
* ``delays`` (an active :class:`repro_torch.net.DelayModel`): each round's
  gossip runs through ``DelayModel.open_round`` with a message mailbox
  beside the state. It needs the dense or sparse weights (``schedule=None``
  means dense), composes with faults (the realized W feeds the mailbox)
  and takes no sync rounds. An inactive model is dropped.
* Time-varying topologies: circulant plans hold the superset offsets and a
  (period, K) weight table; dense plans a (period, N, N) stack of W;
  sparse plans (period, N, K) int32 / f32 stacks of the edge lists, with K
  the largest in-degree over the period (no dense W is stacked).
* Kernel routing: ``use_kernels=None`` picks the CUDA kernels on a CUDA
  device and the plain versions on the CPU (:mod:`repro_torch.device`).
* ``sync_interval="auto"`` syncs every ``max(2, 2 * period)`` rounds.
* ``packed`` (default True): the drivers run the packed (N, d_pad) wire
  buffer; ``packed=False`` runs the pytree runtime (one pass a leaf), the
  reference's bit-equivalence oracle.
* ``wire`` (a :class:`repro_torch.wire.WireCodec`): the wire codec, applied
  to the packed buffer after the noise. An inactive codec is dropped; an
  active one stamps ``wire_dtype`` (``Bf16Codec`` -> "bf16") and needs
  ``packed``. ``from_topology(wire_dtype="bf16")`` is the older spelling
  of ``wire=Bf16Codec()``: it warns once a process (DeprecationWarning) and
  a ``wire_dtype`` that contradicts ``wire`` raises. The bf16 wire does not
  compose with delays (the mailbox accumulates in f32); value codecs do.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.dpps import DPPSConfig
from repro_torch.core.packing import LANE
from repro_torch.core.partpsp import PartPSPConfig
from repro_torch.core.topology import Topology, padded_csr
from repro_torch.device import resolve_device, resolve_use_kernels

__all__ = ["ProtocolPlan"]

_WARNED: set[str] = set()


def _warn_once(key: str, msg: str) -> None:
    """One DeprecationWarning a process for ``key``."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    import warnings

    warnings.warn(msg, DeprecationWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class ProtocolPlan:
    """Static protocol-execution choices plus their per-round operands.

    Fields: ``schedule`` ("dense" | "circulant" | "sparse" | "dynamic"),
    ``period``,
    ``offsets`` and ``mix_weights`` (P, K) for circulant plans, ``ws``
    (P, N, N) f32 for dense ones, ``sparse_idx`` (P, N, K) int32 and
    ``sparse_vals`` (P, N, K) f32 for sparse ones, ``use_kernels``,
    ``sync_interval`` (None keeps the config's), ``chunk`` (rounds between
    host syncs of the trajectory), ``packed``, ``device``, ``faults`` (the
    active FaultModel, or None), ``delays`` (the active DelayModel, or
    None), ``wire_dtype`` ("f32" | "bf16") and ``wire`` (the active
    WireCodec, or None).
    """

    schedule: str
    period: int
    device: torch.device
    offsets: tuple[int, ...] | None = None
    mix_weights: torch.Tensor | None = None
    ws: torch.Tensor | None = None
    sparse_idx: torch.Tensor | None = None
    sparse_vals: torch.Tensor | None = None
    use_kernels: bool = False
    sync_interval: int | None = None
    chunk: int = 50
    packed: bool = True
    faults: Any = None  # repro_torch.net.FaultModel (duck-typed: no import)
    delays: Any = None  # repro_torch.net.DelayModel (duck-typed: no import)
    wire_dtype: str = "f32"
    wire: Any = None    # repro_torch.wire.WireCodec (duck-typed: no import)

    def __post_init__(self):
        # as the inactive fault and delay models are dropped; an active
        # codec's dtype stamps wire_dtype
        if self.wire is not None and not getattr(self.wire, "active", False):
            object.__setattr__(self, "wire", None)
        if self.wire is not None:
            codec_dtype = getattr(self.wire, "wire_dtype", "f32")
            if self.wire_dtype == "f32" and codec_dtype != "f32":
                object.__setattr__(self, "wire_dtype", codec_dtype)
            elif self.wire_dtype != codec_dtype:
                raise ValueError(
                    f"wire codec {self.wire.name!r} implies wire_dtype="
                    f"{codec_dtype!r} but the plan says "
                    f"{self.wire_dtype!r}")
            if not self.packed:
                raise ValueError(
                    f"wire codec {self.wire.name!r} requires packed=True "
                    "(compression is a pass over the packed (N, d_s) "
                    "buffer; the pytree oracle carries the raw f32 wire)")
        if self.wire_dtype not in ("f32", "bf16"):
            raise ValueError(f"unknown wire_dtype {self.wire_dtype!r}")
        if self.wire_dtype != "f32" and not self.packed:
            raise ValueError("wire_dtype='bf16' requires packed=True "
                             "(the packed layout is what makes the wire "
                             "format a single cast)")
        if self.schedule == "dynamic" and self.faults is None:
            raise ValueError("schedule='dynamic' is selected by attaching "
                             "an active FaultModel (faults=), not by hand")
        if self.delays is not None and self.schedule == "circulant":
            raise ValueError(
                "bounded-delay async gossip needs the dense or sparse "
                "weight form (per-message delay draws break circulant "
                "structure); build the plan with schedule='dense' or "
                "'sparse'")

    @property
    def dynamic(self) -> bool:
        """Whether each round masks the weights with the fault model (the
        dense W for "dynamic", the edge list for "sparse")."""
        return (self.schedule == "dynamic"
                or (self.schedule == "sparse" and self.faults is not None))

    @classmethod
    def from_topology(cls, topo: Topology, *, schedule: str | None = None,
                      use_kernels: bool | None = None,
                      sync_interval: int | str | None = None, chunk: int = 50,
                      packed: bool = True, device=None, faults: Any = None,
                      delays: Any = None, wire_dtype: str = "f32",
                      wire: Any = None, mesh: Any = None) -> "ProtocolPlan":
        """The plan of ``topo``: ``schedule=None`` picks circulant where the
        topology has offsets; ``faults`` / ``delays`` / ``wire`` attach an
        active fault model, delay model or wire codec (inactive ones are
        dropped; see the module docstring). With a ``mesh`` (a
        ``DeviceMesh``, :mod:`repro_torch.launch.mesh`) its gossip-axis
        extent must divide the node count, so the node axis shards evenly
        (:mod:`repro_torch.engine.shard`)."""
        if wire is not None and not getattr(wire, "active", False):
            wire = None  # the identity codec: the raw packed wire
        if wire_dtype != "f32":
            _warn_once(
                "wire_dtype",
                "ProtocolPlan.from_topology(wire_dtype='bf16') is "
                "deprecated; pass wire=repro_torch.wire.Bf16Codec() "
                "(CLI: --wire bf16)")
            if wire is None:
                from repro_torch.wire import Bf16Codec

                wire = Bf16Codec()
            elif getattr(wire, "wire_dtype", "f32") != wire_dtype:
                raise ValueError(
                    f"conflicting wire settings: wire_dtype={wire_dtype!r} "
                    f"vs codec {wire.name!r}")
            wire_dtype = "f32"  # __post_init__ stamps it from the codec
        if (wire is not None and delays is not None
                and getattr(delays, "active", False)
                and getattr(wire, "wire_dtype", "f32") != "f32"):
            raise ValueError(
                f"wire codec {wire.name!r} (a dtype-cast codec) does not "
                "compose with the async mailbox runtime: the mailbox "
                "calendars accumulate in-flight mass in f32. Use a "
                "value codec (int8, topk) — those encode before enqueue "
                "and the calendars stay f32 — or drop delays=")
        if schedule not in (None, "dense", "circulant", "sparse"):
            raise ValueError(f"unknown schedule {schedule!r} (dynamic is "
                             "selected by passing faults=, not schedule=)")
        if faults is not None and not faults.active:
            faults = None  # inactive model: the fault-free plan
        if faults is not None and schedule == "circulant":
            raise ValueError(
                "fault injection needs the dense or sparse weight form "
                "(masked edges break circulant structure); drop "
                "schedule='circulant' — the plan stacks the topology's "
                "per-round W (or its edge list under schedule='sparse')")
        if delays is not None and not delays.active:
            delays = None  # inactive model: the synchronous plan
        if delays is not None:
            if schedule == "circulant":
                raise ValueError(
                    "bounded-delay async gossip needs the dense or sparse "
                    "weight form (per-message delay draws break circulant "
                    "structure); use schedule='dense' or 'sparse'")
            delays.validate_nodes(topo.n_nodes)
            if sync_interval not in (None, 0):
                raise ValueError(
                    "sync_interval with an active DelayModel would average "
                    "node states while message mass is still in flight "
                    "(breaking conservation); use sync_interval=0")
        dev = resolve_device(device)
        use_kernels = resolve_use_kernels(use_kernels, dev)
        period = int(getattr(topo, "period", 1))
        per_round = []
        for t in range(period):
            if topo.offsets(t) is None:
                per_round = None
                break
            per_round.append(topo.mixing_weights(t))
        if faults is not None:
            if schedule != "sparse":
                schedule, per_round = "dynamic", None
        elif schedule is None:
            if delays is not None:
                schedule, per_round = "dense", None
            else:
                schedule = "circulant" if per_round is not None else "dense"
        if schedule == "circulant" and per_round is None:
            raise ValueError(f"{type(topo).__name__} is not circulant; use "
                             "schedule='dense'")
        if mesh is not None:
            from repro_torch.launch.mesh import n_gossip_nodes

            n_shards = n_gossip_nodes(mesh)
            if topo.n_nodes % max(n_shards, 1) != 0:
                raise ValueError(
                    f"n_nodes={topo.n_nodes} not divisible by the mesh's "
                    f"{n_shards} gossip shards")
        offsets = mix_weights = ws = sparse_idx = sparse_vals = None
        if schedule == "sparse":
            # each round's W once: a random sequence draws it anew per call
            dense = [topo.weight_matrix(t) for t in range(period)]
            k = max(int((w > 0.0).sum(axis=1).max()) for w in dense)
            pairs = [padded_csr(w, k) for w in dense]
            del dense
            sparse_idx = torch.as_tensor(np.stack([i for i, _ in pairs]),
                                         dtype=torch.int32, device=dev)
            sparse_vals = torch.as_tensor(np.stack([v for _, v in pairs]),
                                          dtype=torch.float32, device=dev)
        elif schedule == "circulant":
            superset = tuple(sorted({o for offs, _ in per_round for o in offs}))
            rows = np.zeros((period, len(superset)), np.float32)
            col = {o: i for i, o in enumerate(superset)}
            for t, (offs, wts) in enumerate(per_round):
                for o, wv in zip(offs, wts):
                    rows[t, col[o]] += wv
            offsets = superset
            mix_weights = torch.as_tensor(rows, device=dev)
        else:
            ws = torch.stack([topo.weight_matrix_torch(t, device=dev)
                              for t in range(period)])
        if sync_interval == "auto":
            sync_interval = max(2, 2 * period)
        return cls(schedule=schedule, period=period, device=dev,
                   offsets=offsets, mix_weights=mix_weights, ws=ws,
                   sparse_idx=sparse_idx, sparse_vals=sparse_vals,
                   use_kernels=use_kernels, sync_interval=sync_interval,
                   chunk=chunk, packed=packed, faults=faults, delays=delays,
                   wire_dtype=wire_dtype, wire=wire)

    @property
    def lane(self) -> int:
        """Column alignment of the packed buffer: 128 for the kernels, 1
        for the plain path (``repro.engine.rounds.wire_layout``)."""
        return LANE if self.use_kernels else 1

    def mix_at(self, t: int) -> dict[str, Any]:
        """``dpps_step`` mixing kwargs for round ``t``; a dynamic plan gives
        the nominal weights, which the drivers realize with its faults."""
        r = t % self.period
        if self.schedule == "circulant":
            return dict(offsets=self.offsets, mix_weights=self.mix_weights[r])
        if self.schedule == "sparse":
            return dict(sparse_idx=self.sparse_idx[r],
                        sparse_vals=self.sparse_vals[r])
        return dict(w=self.ws[r])

    def resolve_dpps(self, cfg: DPPSConfig) -> DPPSConfig:
        # "dynamic" is the drivers' schedule; the round mixes the realized W
        # as dense does
        updates: dict[str, Any] = dict(
            schedule="dense" if self.schedule == "dynamic" else self.schedule,
            use_kernels=self.use_kernels, wire_dtype=self.wire_dtype,
            wire=self.wire)
        if self.sync_interval is not None:
            updates["sync_interval"] = int(self.sync_interval)
        return dataclasses.replace(cfg, **updates)

    def resolve_partpsp(self, cfg: PartPSPConfig) -> PartPSPConfig:
        return dataclasses.replace(cfg, dpps=self.resolve_dpps(cfg.dpps))
