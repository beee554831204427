"""Device meshes and shardings over `torch.distributed`.

Counterpart of `spateo_tpu.parallel.mesh` (`:32-110`). A mesh is a
`torch.distributed.device_mesh.DeviceMesh` whose dimension names are the JAX
package's axis names (``"data"``, ``"model"``), over the ranks of the
default process group: one process a device, on ``cuda:{local_rank %
device_count}`` or, for ``device="cpu"``, on the CPU. Without a process
group a one-rank mesh needs no launcher: `create_mesh` starts a one-rank
group itself (NCCL on the card, gloo on the CPU), as JAX always has a mesh.

The shardings are DTensor placements, one per mesh dimension:
`row_sharding` shards dim 0 over one axis (``[Shard(0)]`` on a 1-D mesh),
`pairwise_sharding` dims 0 and 1 over two (``[Shard(0), Shard(1)]``),
`replicated` replicates (``[Replicate()]``). `shard_rows` returns a
`DTensor` and the row count; unlike the JAX package it pads nothing, since a
DTensor holds uneven shards.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..errors import MeshError
from ._collectives import set_rank_device


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _one_rank_group(device_type: str) -> None:
    """A one-rank default process group in this process, if there is none:
    NCCL for the card, gloo for the CPU. A backend that fails raises."""
    if dist.is_initialized():
        return
    set_rank_device(device_type)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", store=dist.HashStore(), rank=0,
                            world_size=1)


def create_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("data", "model"),
    devices: Optional[Sequence[int]] = None,
    device="cuda",
):
    """A `DeviceMesh` of `shape` over `devices`, the ranks of the default
    process group (all of them by default), named `axis_names`, on `device`
    ("cuda" or "cpu").

    If `shape` is None, all ranks go on the first axis and the others get
    size 1. Raises MeshError if the shape does not cover the ranks or has
    another number of axes than names. With no process group, the mesh has
    one rank, and a one-rank group is started for it."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = torch.device(device).type
    ranks = list(devices) if devices is not None else list(range(_world()))
    n = len(ranks)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise MeshError(f"mesh shape {shape} does not cover {n} devices")
    if len(shape) != len(axis_names):
        raise MeshError(f"mesh shape {shape} has {len(shape)} axes but {len(axis_names)} names given")
    _one_rank_group(device_type)
    set_rank_device(device_type)
    return DeviceMesh(device_type, torch.tensor(ranks, dtype=torch.int64).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def _dim(mesh, axis: str) -> int:
    names = list(mesh.mesh_dim_names or ())
    if axis not in names:
        raise MeshError(f"mesh has no axis {axis!r} (axes {names})")
    return names.index(axis)


def mesh_axis_size(mesh, axis: str) -> int:
    return int(mesh.size(_dim(mesh, axis)))


def row_sharding(mesh, axis: str = "data", ndim: int = 2):
    """Shard dim 0 over `axis`, replicate over the other axes (`ndim` is the
    JAX package's and unused: a placement does not name the array's rank)."""
    from torch.distributed.tensor import Replicate, Shard

    d = _dim(mesh, axis)
    return [Shard(0) if i == d else Replicate() for i in range(mesh.ndim)]


def pairwise_sharding(mesh, row_axis: str = "data", col_axis: str = "model"):
    """2D sharding for NA x NB pairwise blocks: dim 0 over `row_axis`, dim 1
    over `col_axis`."""
    from torch.distributed.tensor import Replicate, Shard

    r, c = _dim(mesh, row_axis), _dim(mesh, col_axis)
    return [Shard(0) if i == r else Shard(1) if i == c else Replicate() for i in range(mesh.ndim)]


def replicated(mesh):
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in range(mesh.ndim)]


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n (static-shape padding helper)."""
    return ((n + m - 1) // m) * m


def pad_rows(x, multiple: int, fill=0.0):
    """Pad dim 0 of `x` (a tensor or an array) up to a multiple, returning
    (padded tensor, original_n)."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    target = pad_to_multiple(max(n, 1), multiple)
    if target == n:
        return x, n
    pad = torch.full((target - n,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad]), n


def shard_rows(x, mesh=None, axis: str = "data"):
    """`x` as a `DTensor` on the mesh with dim 0 sharded over `axis`, from the
    same full `x` on every rank (DTensor's blocks: `torch.chunk` order).
    Returns (dtensor, original_n); nothing is padded."""
    from torch.distributed.tensor import distribute_tensor

    from ..configuration import config
    from ._collectives import mesh_device

    mesh = mesh if mesh is not None else config.mesh
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(mesh_device(mesh))
    return distribute_tensor(t, mesh, row_sharding(mesh, axis, t.dim())), int(t.shape[0])


def local_device_count() -> int:
    """This host's cards."""
    return torch.cuda.device_count()


def device_count() -> int:
    """Devices over all processes: one a rank of the default process group
    (1 without one)."""
    return _world()
