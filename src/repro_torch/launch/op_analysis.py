"""Loop-aware roofline terms of one step, counted op by op on the meta device:
the port's counterpart of ``repro.launch.hlo_analysis``.

The reference lowers a step to XLA HLO and costs the text. The port has no
HLO: :func:`analyze_step` runs the step eagerly on meta tensors (no data,
no allocation) under one counting ``TorchDispatchMode`` (:class:`CostMode`)
and reads every aten op as it dispatches:

    FLOPs          ``torch.utils.flop_counter``'s formulas (the matmuls,
                   convolutions and attention ops; elementwise ops count
                   none, as the reference's dots-only count), plus each
                   hand-written kernel's own count, charged by its
                   wrapper's meta path (``repro_torch.kernels.ops``)
    HBM bytes      operand plus output bytes of each aten op, eager running
                   one kernel an op; views and metadata ops are skipped (the
                   reference's ``_SKIP_OPS``), and an in-place write into a
                   window is charged the window, since only the view's
                   elements are counted
    collectives    operand bytes and calls of each c10d op that dispatches,
                   by kind (an all-gather's operand is the rank's input,
                   not the gathered output); none on one card unless a
                   process group runs the step (the sharded engine), or
                   the model axis charges them on meta
                   (:func:`repro_torch.core.loops.charge_collective`)
    peak memory    the bytes of the storages alive at once: the step's
                   inputs, then every new output storage until it dies
                   (autograd's saved tensors keep theirs alive)

Loops. XLA's own count takes a ``while`` body once; the reference costs it
once and multiplies by its trip count. The port's counterparts of those
bodies are Python loops, which a dispatch mode would see unrolled: the
time loops of ``models/ssm.py`` and the node loop standing in for the
reference's ``vmap``. Both go through :mod:`repro_torch.core.loops`, which
under this mode runs a representative iteration at a scale (the mode
multiplies every count by :attr:`CostMode.scale`) and keeps the memory the
unrolled loop would hold. The raw counts (``raw_flops`` / ``raw_bytes``)
take each op once, as XLA's ``cost_analysis`` would.

``analyze_hlo_text`` has no counterpart: there is no HLO.

Per card (the step runs on one):
    compute    = flops / the card's peak for the step's dtype
    memory     = bytes / HBM bandwidth
    collective = collective bytes / NVLink bandwidth
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry


__all__ = ["HardwareSpec", "HW", "CostMode", "CollectiveCount",
           "RooflineTerms", "analyze_step"]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """NVIDIA H100 SXM's published peaks (dense, no sparsity)."""

    f32_flops: float = 67e12     # f32 on the CUDA cores
    tf32_flops: float = 495e12   # dense TF32 on the tensor cores
    bf16_flops: float = 989e12   # dense bf16 / f16 on the tensor cores
    hbm_bw: float = 3.35e12      # HBM3, bytes/s
    link_bw: float = 900e9       # NVLink, bytes/s, both directions
    memory_bytes: float = 80e9   # HBM capacity

    def peak_flops(self, dtype: str = "float32") -> float:
        """The compute peak of a step in ``dtype``: bf16 / f16 on the tensor
        cores, f32 on the CUDA cores (the port's matmuls run with TF32
        off)."""
        if dtype in ("bfloat16", "float16"):
            return self.bf16_flops
        return self.f32_flops


HW = HardwareSpec()

# The queries FlopCounterMode passes through untouched, so counting here
# sees exactly the ops it sees.
_QUERIES = {getattr(torch.ops.aten, name).default for name in (
    "sym_is_contiguous", "is_contiguous", "is_strides_like_format",
    "is_non_overlapping_and_dense", "size", "sym_size", "stride",
    "sym_stride", "storage_offset", "sym_storage_offset", "numel",
    "sym_numel", "dim") if hasattr(torch.ops.aten, name)}
_QUERIES |= {torch.ops.aten.is_contiguous.memory_format,
             torch.ops.prim.layout.default}

# no device work: allocation, aliasing and metadata
_NO_BYTES = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default, torch.ops.aten.detach.default,
    torch.ops.aten.lift_fresh.default, torch.ops.aten.alias.default,
    torch.ops.aten._unsafe_view.default, torch.ops.aten.set_.source_Storage,
    torch.ops.aten.set_.source_Storage_storage_offset,
    torch.ops.aten.resize_.default, torch.ops.aten._local_scalar_dense.default,
    torch.ops.prim.device.default,
}

# c10d op name -> the reference's collective kind
_COLLECTIVES = {
    "allreduce": "all-reduce", "all_reduce": "all-reduce",
    "allgather": "all-gather", "all_gather": "all-gather",
    "reduce_scatter": "reduce-scatter", "alltoall": "all-to-all",
    "all_to_all": "all-to-all", "broadcast": "broadcast",
    "send": "collective-permute", "recv": "collective-permute",
}


def _collective(func) -> str | None:
    if func.namespace not in ("c10d", "_c10d_functional"):
        return None
    # "_allgather_base_" is what all_gather_into_tensor dispatches
    name = func._schema.name.split("::")[-1].lstrip("_")
    return next((kind for key, kind in _COLLECTIVES.items()
                 if name.startswith(key)), None)


def _coll_charge(func, kind: str | None, args, kwargs) -> int | None:
    """The operand bytes of a c10d op of ``kind`` (None: not one to count):
    its input tensors (an all-gather's or reduce-scatter's second argument:
    what the rank contributes), every tensor argument for the others. A
    permute is counted once, at its send: a receive is not counted."""
    if kind is None or func._schema.name.split("::")[-1].startswith("recv"):
        return None
    operands = args[1] if kind in ("all-gather", "reduce-scatter") \
        else (args, kwargs)
    return sum(_nbytes(t) for t in tree_flatten(operands)[0]
               if isinstance(t, torch.Tensor))


class CollectiveCount(TorchDispatchMode):
    """Counts the c10d collectives dispatched while it is on (``calls`` and
    operand ``bytes`` by the reference's kind) and runs every op as it is:
    unlike :class:`CostMode` it decomposes nothing and tracks no storage,
    so a run on the card under it computes what it computes without it."""

    def __init__(self):
        super().__init__()
        self.calls: dict[str, int] = defaultdict(int)
        self.bytes: dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _collective(func)
        nbytes = _coll_charge(func, kind, args, kwargs)
        if nbytes is not None:
            self.calls[kind] += 1
            self.bytes[kind] += nbytes
        return func(*args, **kwargs)


# ops whose decompose() gave NotImplemented (it depends on the op alone)
_OPAQUE: set = set()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class _Storage:
    nbytes: int
    mult: int
    ref: Any
    serial: int            # a storage's key (its address) outlives it
    dropped: bool = False


@dataclasses.dataclass
class _Region:
    mult: int
    backward: bool
    start: int
    high: int
    first: int                 # the serial of its first new storage
    keys: set = dataclasses.field(default_factory=set)
    deferred: int = 0
    anon: int = 0


class CostMode(TorchDispatchMode):
    """Counts the aten ops dispatched while it is on, on ``device`` (the
    step's device: meta for a dry run). Every count is multiplied by
    :attr:`scale`, which the loop rule sets; ``raw_*`` take each op once.
    With ``loop_rule=False`` the loops run unrolled under it."""

    def __init__(self, device, *, loop_rule: bool = True):
        super().__init__()
        self.device = torch.device(device)
        self.loop_rule = loop_rule
        self.scale = 1
        self.aten_flops = 0.0
        self.raw_flops = 0.0
        self.op_bytes = 0.0
        self.raw_bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.launches: dict[str, int] = defaultdict(int)
        self.coll: dict[str, float] = defaultdict(float)
        self.coll_calls: dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self._storages: dict[int, _Storage] = {}
        self._serial = 0
        self._regions: list[_Region] = []

    # -- counting -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES or isinstance(func,
                                          torch._ops.HigherOrderOperator):
            return NotImplemented
        if func not in _OPAQUE and func is not torch.ops.prim.device.default:
            # FlopCounterMode's own step: an op with a composite
            # decomposition is counted as its parts
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            _OPAQUE.add(func)
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor) and t.device == self.device]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor) and t.device == self.device]
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            f = float(count(*args, **kwargs, out_val=out))
            self.aten_flops += f * self.scale
            self.raw_flops += f
        kind = _collective(func)
        nbytes = _coll_charge(func, kind, args, kwargs)
        if nbytes is not None:
            self.coll[kind] += nbytes * self.scale
            self.coll_calls[kind] += self.scale
        if not (func.is_view or func in _NO_BYTES or kind is not None):
            b = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.op_bytes += b * self.scale
            self.raw_bytes += b
        if outs:
            seen = {self._key(t) for t in ins}
            for t in outs:
                if self._key(t) not in seen:
                    self._track(t)
        return out

    def charge_kernel(self, kernel: str, flops: float, nbytes: float) -> None:
        """One launch of a hand-written kernel (from its wrapper's meta
        path), standing for as many as the scale says."""
        self.kernel_flops += flops * self.scale
        self.kernel_bytes += nbytes * self.scale
        self.launches[kernel] += self.scale

    def charge_collective(self, kind: str, nbytes: float) -> None:
        """One c10d collective of ``kind`` counted without a call (the
        model axis on meta tensors), as :meth:`__torch_dispatch__` counts
        one that dispatches."""
        self.coll[kind] += nbytes * self.scale
        self.coll_calls[kind] += self.scale

    def charge_bytes(self, nbytes: float) -> None:
        """Bytes of an op counted without running it (the loop rule's
        repeated stack)."""
        self.op_bytes += nbytes * self.scale
        self.raw_bytes += nbytes

    # -- memory -------------------------------------------------------------
    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def track_inputs(self, tree) -> None:
        """Count the storages of the step's inputs as alive."""
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor) and t.device == self.device:
                self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        ref = weakref.ref(st, lambda _, key=key: self._died(key))
        self._serial += 1
        self._storages[key] = _Storage(st.nbytes(), 1, ref, self._serial)
        self.live += st.nbytes()
        for r in self._regions:
            r.keys.add((key, self._serial))
        self._observe(self.live)

    def _died(self, key: int) -> None:
        s = self._storages.pop(key, None)
        if s is None or s.dropped:
            return
        back = next((r for r in reversed(self._regions) if r.backward), None)
        if back is not None and s.mult > 1 and s.serial < back.first:
            # a forward storage of the iteration: the unrolled backward
            # frees one iteration's copy here, the others in their own
            # iterations, by the region's end
            self.live -= s.nbytes
            back.deferred += s.nbytes * (s.mult - 1)
        else:
            self.live -= s.nbytes * s.mult

    def _observe(self, value: int) -> None:
        if value > self.peak:
            self.peak = value
        for r in self._regions:
            if value > r.high:
                r.high = value

    def begin_region(self, mult: int, backward: bool = False) -> _Region:
        """Open a region whose ops stand for ``mult`` iterations."""
        r = _Region(mult, backward, self.live, self.live, self._serial + 1)
        self._regions.append(r)
        return r

    def end_region(self, r: _Region) -> None:
        """Close ``r``: the unrolled loop's last iteration would run with
        ``mult - 1`` more iterations' net bytes alive; add them."""
        self._regions.remove(r)
        delta = self.live - r.start
        self._observe(r.high + max(0, (r.mult - 1) * delta))
        self.live -= r.deferred
        r.anon = (r.mult - 1) * delta + r.deferred
        self.live += r.anon
        self._observe(self.live)

    def materialize(self, r: _Region, exclude=()) -> None:
        """Give each storage allocated in ``r`` and still alive (but those
        of ``exclude``) its ``mult`` copies, in place of the region's
        anonymous bytes."""
        skip = {self._key(t) for t in exclude if isinstance(t, torch.Tensor)}
        added = 0
        for key, serial in r.keys:
            s = self._storages.get(key)
            if s is None or s.serial != serial or s.dropped or key in skip:
                continue
            added += s.nbytes * s.mult * (r.mult - 1)
            s.mult *= r.mult
        self.live += added - r.anon
        r.anon = 0
        self._observe(self.live)

    def drop(self, tensors) -> None:
        """Free ``tensors``' storages now, every copy (the unrolled loop's
        iteration gradients die once stacked); their later death is not
        counted again."""
        for t in tensors:
            if not isinstance(t, torch.Tensor) or t.device != self.device:
                continue
            s = self._storages.get(self._key(t))
            if s is not None and not s.dropped:
                self.live -= s.nbytes * s.mult
                s.dropped = True


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str                    # the port: "nodes<N>" on one card
    flops: float                 # per card, loop-aware (aten + kernels)
    bytes_accessed: float        # per card HBM traffic estimate, loop-aware
    coll_bytes: dict[str, float]
    peak_memory_bytes: float
    model_flops: float
    raw_flops: float = 0.0       # aten ops each counted once (no loop rule)
    raw_bytes: float = 0.0
    aten_flops: float = 0.0      # flop_counter's formulas, loop-aware
    kernel_flops: float = 0.0    # the hand-written kernels' own counts
    kernel_bytes: float = 0.0
    launches: dict[str, int] = dataclasses.field(default_factory=dict)
    compute_dtype: str = "float32"
    coll_calls: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def coll_total(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def t_compute(self) -> float:
        return self.flops / HW.peak_flops(self.compute_dtype)

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HW.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_total / HW.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def row(self) -> dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "coll_bytes_per_chip": self.coll_total,
            "coll_breakdown": {k: v for k, v in self.coll_bytes.items() if v},
            "peak_memory_gib": self.peak_memory_bytes / 2**30,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_per_chip": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "raw_flops": self.raw_flops,
            "raw_bytes": self.raw_bytes,
            "aten_flops": self.aten_flops,
            "kernel_flops": self.kernel_flops,
            "kernel_bytes": self.kernel_bytes,
            "launches": dict(self.launches),
            "compute_dtype": self.compute_dtype,
        }


def analyze_step(fn: Callable, *args, arch: str, shape: str, nodes: int,
                 model_flops: float, compute_dtype: str = "float32",
                 loop_rule: bool = True) -> RooflineTerms:
    """``fn(*args)`` once under a :class:`CostMode` on the args' device
    (meta for a dry run) -> its roofline terms. ``loop_rule=False`` runs
    the loops unrolled (the rule's check)."""
    tensors = [t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)]
    device = tensors[0].device if tensors else torch.device("meta")
    mode = CostMode(device, loop_rule=loop_rule)
    mode.track_inputs(args)
    with mode:
        out = fn(*args)
    del out
    return RooflineTerms(
        arch=arch, shape=shape, mesh=f"nodes{nodes}",
        flops=mode.aten_flops + mode.kernel_flops,
        bytes_accessed=mode.op_bytes + mode.kernel_bytes,
        coll_bytes=dict(mode.coll), peak_memory_bytes=float(mode.peak),
        model_flops=model_flops, raw_flops=mode.raw_flops,
        raw_bytes=mode.raw_bytes, aten_flops=mode.aten_flops,
        kernel_flops=mode.kernel_flops, kernel_bytes=mode.kernel_bytes,
        launches=dict(mode.launches), compute_dtype=compute_dtype,
        coll_calls=dict(mode.coll_calls))
