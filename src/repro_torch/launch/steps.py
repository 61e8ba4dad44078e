"""Step builders (port of ``repro.launch.steps``): arch spec + mesh (or node
count) -> the PartPSP training step or the prefill / decode step, with
meta-device stand-ins of its inputs and its loop-aware cost.

The reference takes a mesh and derives its node count from the mesh's
gossip axes (``n_gossip_nodes``); :func:`build_train_plan` takes a
``DeviceMesh`` of ("data", "model") dims so too (:mod:`repro_torch.launch.
mesh`): its plan is one rank's, the rank's block of N / D node rows
(``engine.shard``'s seams over "data") of its shard of the model
(``models.parallel`` over "model", the protocol's norms finished over it:
``core.dpps.ColumnOps``), the reference's ``train_state_shardings``
applied by rank; or an int node count, which the dry run's ``--nodes``
gives (``model_shards=M``: rank 0 of M with no process group, for the dry
run's meta count). :func:`build_serve_plan`
takes the mesh whose "model" dim splits the served model (tensor and
expert parallelism, :mod:`repro_torch.models.parallel`), or an int M
(the dry run's ``--model-shards``: rank 0's step counted on meta, no
process group). A step is one process's, one rank's: there are no
``in_shardings`` / ``out_shardings`` (the sharded engine,
:mod:`repro_torch.engine.shard`, runs the node axis over ranks; a serve
plan's ``init_args`` give the rank's shard, what the reference's
``in_shardings`` would place on its device). The
reference's ``jitted()`` / ``lower()`` become :meth:`TrainPlan.
abstract_args` (the meta state, batch and seed: the reference's
``_abstract_state`` and ``batch_specs``) and :meth:`TrainPlan.cost`
(:func:`repro_torch.launch.op_analysis.analyze_step` of ``step_fn`` on
them, the kernels routed as on the card). ``step_fn`` runs on real tensors,
on the card unless they lie on the CPU.

Used by ``launch/dryrun.py`` and by ``chip_smoke.py`` (phases 29, 31).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import (INPUT_SHAPES, ArchSpec, ShapeSpec,
                                 serve_batch_specs, train_batch_specs)
from repro_torch.core.dpps import LOCAL_COLUMN_OPS, ColumnOps, DPPSConfig
from repro_torch.core.partition import Partition
from repro_torch.core.partpsp import (PartPSPConfig, PartPSPState,
                                      node_stacked, partpsp_init, partpsp_step)
from repro_torch.core.topology import DOutGraph, Topology, derive_constants
from repro_torch.core.tree_utils import tree_map
from repro_torch.device import resolve_device, resolve_use_kernels
from repro_torch.launch.flops import model_flops
from repro_torch.launch.mesh import (as_model_axis, gossip_axes, model_axis,
                                     n_gossip_nodes)
from repro_torch.launch.op_analysis import RooflineTerms, analyze_step
from repro_torch.models.parallel import ModelAxis
from repro_torch.models.transformer import Transformer

__all__ = ["TrainPlan", "ServePlan", "build_train_plan", "build_serve_plan"]


def _shape(shape_name: str, shape: ShapeSpec | None) -> ShapeSpec:
    return INPUT_SHAPES[shape_name] if shape is None else shape


def _init_params(model: Transformer, device, seed: int):
    dev = torch.device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    return model.init(gen.manual_seed(int(seed)), device=dev)


@dataclasses.dataclass
class TrainPlan:
    """Everything needed to cost or run one PartPSP training step."""

    arch: ArchSpec
    model: Transformer
    partition: Partition
    cfg: PartPSPConfig
    topology: Topology
    shape: ShapeSpec
    n_nodes: int
    batch_specs: Any
    # a rank's plan (build_train_plan on a DeviceMesh): the mesh, and the
    # column ops of its shard of the shared leaves
    mesh: Any = None
    columns: ColumnOps = LOCAL_COLUMN_OPS
    # the dry run's rank of a data dim without a mesh: its N / D node rows,
    # the gossip's collectives charged on meta
    data_shards: int = 1
    # the mix arguments and the data seams, made once a device
    _mix: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def data(self) -> tuple[Any, int, int]:
        """(group, size, rank) of the mesh's gossip ("data") dim; (None, D,
        0) without a mesh (``data_shards`` D, the dry run's rank 0)."""
        if self.mesh is None:
            return None, self.data_shards, 0
        (name,) = gossip_axes(self.mesh)
        size = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))[name]
        return self.mesh.get_group(name), size, self.mesh.get_local_rank(name)

    @property
    def block(self) -> int:
        """The node rows this plan's process holds (N / D over a mesh)."""
        return self.n_nodes // self.data[1]

    def init_state(self, device=None, seed: int = 0) -> PartPSPState:
        """A node-stacked state on ``device`` (the card by default): the
        model's ``init`` from ``seed``, one copy for each node (the
        reference's ``_abstract_state`` holds N copies, as every state after
        the first round does). A rank's plan: its node rows of its shard of
        that state."""
        params = _init_params(self.model, resolve_device(device), seed)
        n = self.block
        stacked = tree_map(
            lambda x: x[None].expand((n,) + tuple(x.shape)).contiguous(),
            params)
        del params
        return partpsp_init(stacked, self.partition, self.cfg)

    def abstract_args(self) -> tuple:
        """(meta state, meta batch, seed) that ``step_fn`` takes."""
        return self.init_state("meta"), self.batch_specs, 0

    def step_fn(self, state: PartPSPState, batch: Any, seed: int = 0,
                bits=None) -> tuple[PartPSPState, dict]:
        """One PartPSP round on ``state``'s device (the kernels on the card
        and on meta, the plain versions on the CPU); ``bits`` are the
        noise bits of each shared leaf (default: the Philox draw of
        ``seed``). A rank's plan runs its round on its part of the state
        and of the batch (its node rows): with a data dim above 1 over
        ``engine.shard``'s seams (the mix's all-gather and W rows, the
        node reductions' all-reduces, the noise keyed by global node), and
        its norms finished over "model" (``columns``)."""
        dev = state.dpps.push.a.device
        kernels = resolve_use_kernels(None, dev)
        cfg = dataclasses.replace(self.cfg, dpps=dataclasses.replace(
            self.cfg.dpps, use_kernels=kernels))
        return partpsp_step(state, batch, cfg=cfg, partition=self.partition,
                            loss_fn=node_stacked(self.model.loss_fn),
                            seed=seed, bits=bits, columns=self.columns,
                            **self.mix_args(dev), **self._data_seams(
                                dev, kernels))

    def _data_seams(self, device, kernels: bool) -> dict:
        """``engine.shard``'s seams over a data dim above 1 (its gossip
        builder, node ops and ``node0``), made once a device; none
        otherwise."""
        group, size, rank = self.data
        if size == 1:
            return {}
        key = ("seams", str(device), kernels)
        if key not in self._mix:
            from repro_torch.engine.plan import ProtocolPlan
            from repro_torch.engine.shard import (sharded_gossip_builder,
                                                  sharded_node_ops)

            proto = ProtocolPlan.from_topology(
                self.topology, schedule=self.cfg.dpps.schedule,
                use_kernels=kernels, device=device)
            gossip = sharded_gossip_builder(proto, group, size, rank)
            self._mix[key] = dict(
                gossip_fn=gossip(self.mix_args(device)),
                node_ops=sharded_node_ops(group, self.n_nodes),
                node0=rank * self.block)
        return self._mix[key]

    def mix_args(self, device) -> dict:
        """The round's mix arguments on ``device``: circulant offsets and
        weights, or the dense W."""
        key = str(device)
        if key not in self._mix:
            if self.cfg.dpps.schedule == "circulant":
                offsets, wts = self.topology.mixing_weights(0)
                self._mix[key] = dict(offsets=offsets, mix_weights=(
                    torch.as_tensor(wts, dtype=torch.float32, device=device)))
            else:
                self._mix[key] = dict(w=self.topology.weight_matrix_torch(
                    0, device=device))
        return self._mix[key]

    def cost(self) -> RooflineTerms:
        """The step's roofline terms, counted on meta tensors: one rank's
        over a model axis (and its data dim's node rows), its collectives
        charged as the ranks would issue them."""
        m = self.model.axis.size
        terms = analyze_step(
            self.step_fn, *self.abstract_args(), arch=self.arch.name,
            shape=self.shape.name, nodes=self.n_nodes,
            model_flops=model_flops(self.arch, self.shape) / (
                m * self.data[1]),
            compute_dtype=self.model.cfg.param_dtype)
        if m > 1:
            terms.mesh = f"nodes{self.n_nodes}+model{m}"
        return terms


@dataclasses.dataclass
class ServePlan:
    """One prefill or decode step of the consensus model: the whole model's,
    or, over a model axis (``model.axis``), one rank's on its shard."""

    arch: ArchSpec
    model: Transformer
    kind: str                    # "prefill" | "decode"
    shape: ShapeSpec
    batch_specs: Any
    cache_dtype: str | None = None

    def step_fn(self, params, *args, capacity: int | None = None):
        """prefill: ``(params, batch)`` -> (last logits, cache), the cache of
        ``capacity`` slots (default the prompt's); decode: ``(params,
        cache, token, pos[, image_embeds])`` -> (logits, cache), the cache
        written in place. Without grad, as ``Session.serve``. Over a model
        axis: the rank's step on its shard, every rank's logits the whole
        vocabulary's, bit for bit alike."""
        with torch.no_grad():
            if self.kind == "prefill":
                return self.model.prefill(params, args[0], capacity=capacity)
            cache, token, pos, *enc = args
            return self.model.decode_step(params, cache, token, pos,
                                          enc=enc[0] if enc else None)

    def init_args(self, device=None, seed: int = 0, params=None) -> tuple:
        """``step_fn``'s arguments on ``device`` (the card by default; meta
        for the dry run): the model's ``init`` from ``seed`` (over a model
        axis the rank's shard of the whole draw), or the rank's shard of
        the whole model's ``params`` (e.g. the converted reference's);
        inputs drawn from ``seed`` (tokens uniform over the vocabulary,
        embeddings normal x 0.1) for the whole batch, of which the rank
        keeps its rows over "data"; a zero cache of ``seq_len`` slots, and
        a decode step at the cache's last slot."""
        dev = resolve_device(device)
        params = _init_params(self.model, dev, seed) if params is None \
            else self.model.shard_params(params)
        gen = None if dev.type == "meta" else \
            torch.Generator(device=dev).manual_seed(int(seed) + 1)
        b, s = self.shape.global_batch, self.shape.seq_len
        rows = self.model.axis.batch_rows(b)

        def draw(spec):
            if dev.type == "meta":
                return spec[rows]
            if spec.dtype == torch.int32:
                x = torch.randint(0, self.model.cfg.vocab_size,
                                  tuple(spec.shape), generator=gen,
                                  device=dev, dtype=torch.int32)
            else:
                x = torch.randn(tuple(spec.shape), generator=gen,
                                device=dev).mul_(0.1)
            return x[rows]

        if self.kind == "prefill":
            return params, {k: draw(v) for k, v in self.batch_specs.items()}
        cache = self.model.init_cache(
            rows.stop - rows.start, s, getattr(torch, self.cache_dtype)
            if self.cache_dtype else None, device=dev)
        extra = (draw(self.batch_specs["image_embeds"]),) \
            if "image_embeds" in self.batch_specs else ()
        return (params, cache, draw(self.batch_specs["token"]), s - 1) + extra

    def abstract_args(self) -> tuple:
        return self.init_args("meta")

    def cost(self) -> RooflineTerms:
        """One rank's roofline terms (the whole model's without an axis),
        counted on meta tensors; the collectives of a model axis charged
        as the ranks would issue them."""
        m = self.model.axis.size
        terms = analyze_step(
            self.step_fn, *self.abstract_args(), arch=self.arch.name,
            shape=self.shape.name, nodes=1,
            model_flops=model_flops(self.arch, self.shape) / (
                m * self.model.axis.data_size),
            compute_dtype=self.model.cfg.param_dtype)
        if m > 1:
            terms.mesh = f"model{m}"
        return terms


def build_train_plan(
    arch: ArchSpec,
    n_nodes: Any = 16,
    *,
    shape_name: str = "train_4k",
    shape: ShapeSpec | None = None,
    cfg: PartPSPConfig | None = None,
    topology: Topology | None = None,
    schedule: str | None = None,
    param_dtype: str | None = None,   # SPerf knob: e.g. "bfloat16"
    two_pass: bool | None = None,     # SPerf knob: False = fused grads
    nodes: int | None = None,
    model_shards: int = 1,
    model_rank: int = 0,
    data_shards: int = 1,
) -> TrainPlan:
    """The reference's plan. ``n_nodes`` is the node count, or a mesh whose
    gossip axes give it, as the reference's ``mesh`` does (``nodes``
    replaces that count: N / D node rows a data rank). A
    ``DeviceMesh`` of ("data", "model") dims makes the plan its rank's:
    the rank's node rows and its shard of the model
    (:mod:`repro_torch.models.parallel`: every group kind, by whole
    heads; an M that does not divide a leaf dim the reference's pspecs
    put on "model" raises), the
    model's data dim 1 (each node routes its own batch). An
    int with ``model_shards`` M > 1 is rank ``model_rank`` of M with no
    process group, and ``data_shards`` D > 1 its N / D node rows (the
    gossip's all-gathers and the node reductions charged, not issued),
    for the dry run's meta count only.
    ``shape`` (a ``ShapeSpec`` of kind "train") replaces ``shape_name``."""
    mesh, axis = None, as_model_axis(
        ModelAxis(size=model_shards, rank=model_rank) if model_shards > 1
        else None)
    if _is_device_mesh(n_nodes):
        mesh = n_nodes
        axis = dataclasses.replace(model_axis(mesh), data_size=1,
                                   data_rank=0, data_group=None)
    if not isinstance(n_nodes, int):
        n_nodes = n_gossip_nodes(n_nodes)
    n_nodes = nodes or n_nodes
    if mesh is not None and n_nodes % n_gossip_nodes(mesh):
        raise ValueError(f"node count {n_nodes} must divide evenly over "
                         f"{n_gossip_nodes(mesh)} gossip shards")
    shape = _shape(shape_name, shape)
    assert shape.kind == "train", shape
    model_cfg = arch.model
    if param_dtype is not None:
        model_cfg = dataclasses.replace(model_cfg, param_dtype=param_dtype)
    model = Transformer(model_cfg, axis=axis)
    topo = topology or DOutGraph(n_nodes=n_nodes, d=2)
    if cfg is None:
        c_prime, lam = derive_constants(topo)
        cfg = PartPSPConfig(
            gamma_l=0.05, gamma_s=0.05, clip=100.0,
            dpps=DPPSConfig(b=1.0, gamma_n=0.01, c_prime=c_prime, lam=lam,
                            schedule=schedule or "dense"))
    if schedule is not None:
        cfg = dataclasses.replace(cfg, dpps=dataclasses.replace(
            cfg.dpps, schedule=schedule))
    if two_pass is not None:
        cfg = dataclasses.replace(cfg, two_pass=two_pass)

    # the partition from the node-stacked parameter shapes (meta, no copy;
    # a rank's shard shapes over a model axis)
    params = _init_params(model, "meta", 0)
    stacked = tree_map(lambda x: x[None].expand((n_nodes,) + tuple(x.shape)),
                       params)
    partition = Partition.from_rules(stacked, arch.shared_rules,
                                     default="local")
    batch_specs = train_batch_specs(arch, shape, n_nodes)
    columns = LOCAL_COLUMN_OPS
    if mesh is not None or axis.size > 1:
        from repro_torch.launch.sharding import train_columns

        block = n_nodes // (n_gossip_nodes(mesh) if mesh is not None
                            else data_shards)
        batch_specs = tree_map(lambda x: x[:block], batch_specs)
        counted, col_maps = train_columns(model, partition, axis)
        columns = ColumnOps(col_sum=axis.sum_columns, counted=counted,
                            col_maps=col_maps)
    elif data_shards > 1:
        batch_specs = tree_map(lambda x: x[:n_nodes // data_shards],
                               batch_specs)
    if mesh is None and n_nodes % data_shards:
        raise ValueError(f"node count {n_nodes} must divide evenly over "
                         f"{data_shards} gossip shards")
    return TrainPlan(arch=arch, model=model, partition=partition, cfg=cfg,
                     topology=topo, shape=shape, n_nodes=n_nodes,
                     batch_specs=batch_specs, mesh=mesh, columns=columns,
                     data_shards=1 if mesh is not None else data_shards)


def _is_device_mesh(x) -> bool:
    """Whether ``x`` is a ``DeviceMesh`` (a rank's mesh, with process
    groups), not a node count or an object that only names its dims."""
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(x, DeviceMesh)


def build_serve_plan(arch: ArchSpec, mesh: Any = None, *,
                     shape_name: str,
                     shape: ShapeSpec | None = None,
                     param_dtype: str | None = None,
                     cache_dtype: str | None = None,
                     carry_cache: bool = False) -> ServePlan:
    """The prefill or decode plan of ``shape_name`` (or ``shape``). The
    prefill runs flash attention, as ``Session.serve`` does on the card.
    ``carry_cache`` sets ``decode_cache_in_carry`` as the reference's plan
    does, and changes no op: the port's decode takes that path's layout
    whatever the flag says.

    ``mesh`` (a ``DeviceMesh`` of ("data", "model") dims) makes the plan
    this rank's: its model is split over the "model" dim
    (:mod:`repro_torch.models.parallel`: every group kind, by whole heads
    whatever H; an M that does not divide a leaf dim the reference's
    pspecs put on "model" raises), its batch (and a VLM's image
    embeddings) over "data"; a decode of global batch 1 (long_500k) sets
    the reference's ``shard_seq``: each KV cache's slots over "data"
    instead, the batch and the recurrent states whole on every data rank.
    An int M is rank 0 of M with no process group, and a ``ModelAxis``
    without groups names a rank of a (data, model) mesh, for the dry run's
    meta count only; None (the default) is the whole model on one
    process, today's plan."""
    shape = _shape(shape_name, shape)
    assert shape.kind in ("prefill", "decode"), shape
    model_cfg = dataclasses.replace(arch.model, flash_prefill=True)
    if param_dtype is not None:
        model_cfg = dataclasses.replace(model_cfg, param_dtype=param_dtype)
    if carry_cache:
        model_cfg = dataclasses.replace(model_cfg, decode_cache_in_carry=True)
    axis = as_model_axis(mesh)
    if shape.kind == "decode" and shape.global_batch == 1:
        # long_500k: the KV slots over "data" (the reference's shard_seq)
        axis = dataclasses.replace(axis, shard_seq=True)
    return ServePlan(arch=arch,
                     model=Transformer(model_cfg, axis=axis),
                     kind=shape.kind, shape=shape,
                     batch_specs=serve_batch_specs(arch, shape),
                     cache_dtype=cache_dtype)
