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
node, which the port does not run yet (:mod:`repro_torch.engine.shard`
shards the node axis only).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "gossip_axes", "n_gossip_nodes",
           "make_host_mesh"]


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


def make_host_mesh(n_nodes: int = 1, device_type: str = "cpu"):
    """Degenerate one-rank ("data", "model") = (1, 1) mesh for tests and
    examples; needs a default process group of one rank (a single process
    holds every node: no collective has a peer)."""
    if _world_size() != 1:
        raise RuntimeError("make_host_mesh needs a default process group of "
                           f"one rank, have {_world_size()}")
    return _mesh(device_type, (1, 1), ("data", "model"))

