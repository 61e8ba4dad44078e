"""Production meshes on ``torch.distributed`` (port of ``repro.launch.mesh``).

Functions, not module constants: importing this module touches no process
group. A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims, over the ranks of the default process group, which the caller
initialises (``init_process_group`` with its own address, world size and
rank: nothing here discovers a cluster).

Single pod : (data=16, model=16) = 256 ranks
Multi-pod  : (pod=2, data=16, model=16) = 512 ranks

The decentralized gossip axes are ("data",) single-pod and ("pod", "data")
multi-pod (32 nodes); "model" is tensor/expert parallelism inside each
node. The sharded engine (:mod:`repro_torch.engine.shard`) runs the node
axis over the gossip axes; serving and training run the model dim
(:func:`model_axis`, :mod:`repro_torch.models.parallel`; a training
rank's plan, ``launch.steps.build_train_plan(arch, mesh)``, runs both).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "gossip_axes", "n_gossip_nodes",
           "make_host_mesh", "model_axis", "as_model_axis"]


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def _mesh(device_type: str, shape: tuple[int, ...], axes: tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over the first 256 (512 multi-pod) ranks of the
    default process group; raises, as the reference does, when the world
    is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = _world_size()
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} devices, have {have} — the port's "
            "dry run (launch/dryrun.py) costs one node's step on the meta "
            "device instead")
    return _mesh(device_type, shape, axes)


def gossip_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the decentralized node dimension is sharded over."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def n_gossip_nodes(mesh) -> int:
    size = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(size[a] for a in gossip_axes(mesh))


def make_host_mesh(n_nodes: int = 1, device_type: str = "cpu",
                   shape: tuple[int, int] = (1, 1)):
    """A ("data", "model") mesh of ``shape`` over every rank of the default
    process group, for tests, examples and ``chip_smoke.py``. The default
    (1, 1) needs a group of one rank (a single process holds every node:
    no collective has a peer). ``device_type`` names the mesh's devices
    only: a gloo mesh of "cpu" serves CUDA tensors too (gloo all-reduces
    them, staged through the host)."""
    need = math.prod(shape)
    if _world_size() != need:
        ranks = "one rank" if need == 1 else f"{need} ranks"
        raise RuntimeError(f"make_host_mesh{tuple(shape)} needs a default "
                           f"process group of {ranks}, have {_world_size()}")
    return _mesh(device_type, tuple(shape), ("data", "model"))


def model_axis(mesh):
    """This rank's :class:`repro_torch.models.parallel.ModelAxis` of
    ``mesh``: the group, size and rank of its "model" dim, and of its one
    gossip ("data") dim (a mesh of several gossip axes is refused, as the
    sharded engine refuses it)."""
    from repro_torch.models.parallel import ModelAxis

    names = mesh.mesh_dim_names
    data = gossip_axes(mesh)
    if "model" not in names or len(data) > 1:
        raise NotImplementedError(
            f"the model axis needs a mesh of ('data', 'model') dims, got "
            f"{names}")
    size = dict(zip(names, mesh.shape))
    kw = {}
    if data:
        kw = dict(data_size=size[data[0]],
                  data_rank=mesh.get_local_rank(data[0]),
                  data_group=mesh.get_group(data[0]))
    return ModelAxis(size=size["model"], rank=mesh.get_local_rank("model"),
                     group=mesh.get_group("model"), **kw)


def as_model_axis(mesh):
    """``mesh`` as a model axis: None (no axis), an int M (rank 0 of M with
    no process group: the dry run's meta count), a ``ModelAxis``, or a
    ``DeviceMesh`` (:func:`model_axis`)."""
    from repro_torch.models.parallel import NO_AXIS, ModelAxis

    if mesh is None:
        return NO_AXIS
    if isinstance(mesh, ModelAxis):
        return mesh
    if isinstance(mesh, int):
        return ModelAxis(size=mesh)
    return model_axis(mesh)

