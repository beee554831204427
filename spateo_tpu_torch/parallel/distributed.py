"""Multi-process initialisation and cross-process utilities over
`torch.distributed`.

Counterpart of `spateo_tpu.parallel.distributed` (`:47-144`). One process
runs each device. The same program runs on every rank:

    import spateo_tpu_torch as stt
    stt.parallel.initialize_distributed()            # torchrun's RANK, WORLD_SIZE, MASTER_ADDR
    mesh = stt.parallel.global_mesh(("data",))       # every rank of every host
    # ... each rank's rows into a DTensor with make_global_array ...

`initialize_distributed` reads the environment that ``torchrun`` sets, or
takes the coordinator's ``host:port`` (or an ``init_method`` URL such as
``file:///path/store``), the world size and this process's rank. The
backend is the caller's: NCCL for ranks on the card and gloo for ranks on
the CPU when `backend` is None; gloo on the card when asked (several ranks
sharing one card). A backend that fails raises; nothing moves to another
backend on its own.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..logging import logger_manager as lm
from ._collectives import all_reduce, set_rank_device

_initialized = False


def is_distributed() -> bool:
    """Whether this process joined a process group of more than one rank
    through `initialize_distributed`."""
    return _initialized


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> None:
    """Join the default process group.

    With no arguments, the environment decides: ``RANK``, ``WORLD_SIZE``
    and ``MASTER_ADDR`` (as ``torchrun`` sets them) join it by ``env://``;
    without them this is one process, and nothing is started (a one-rank
    mesh starts its own group). Otherwise `coordinator_address` is the
    rank-0 ``host:port`` (``tcp://``) or an ``init_method`` URL, or comes
    from ``COORDINATOR_ADDRESS``; `num_processes` is the world size and
    `process_id` this rank. `local_device_ids[0]` is this rank's card
    (default ``local_rank % device_count``). `backend` None picks NCCL for
    ``device="cuda"`` and gloo for ``"cpu"``. Later calls do nothing."""
    global _initialized
    if _initialized or dist.is_initialized():
        return
    device_type = torch.device(device).type
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if coordinator_address is None and num_processes is None and "COORDINATOR_ADDRESS" not in os.environ:
        if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            lm.main_debug("single-process environment: distributed initialization not needed")
            return
        _set_device(device_type, local_device_ids)
        dist.init_process_group(backend, init_method="env://")
    else:
        address = coordinator_address or os.environ["COORDINATOR_ADDRESS"]
        init_method = address if "://" in address else f"tcp://{address}"
        if num_processes is None or process_id is None:
            raise ValueError("initialize_distributed: a coordinator needs num_processes and process_id")
        _set_device(device_type, local_device_ids, int(process_id))
        dist.init_process_group(backend, init_method=init_method, world_size=int(num_processes),
                                rank=int(process_id))
    _initialized = dist.is_initialized() and dist.get_world_size() > 1
    if dist.is_initialized():
        lm.main_info(f"distributed: rank {dist.get_rank()} of {dist.get_world_size()}, backend "
                     f"{dist.get_backend()}, device {device_type}")


def _set_device(device_type: str, local_device_ids, rank: Optional[int] = None) -> None:
    if device_type != "cuda":
        return
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    elif rank is not None and "LOCAL_RANK" not in os.environ:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        set_rank_device("cuda")


def global_mesh(axis_names: Tuple[str, ...] = ("data",), shape: Optional[Tuple[int, ...]] = None, device="cuda"):
    """A mesh over every rank of the default process group (every device of
    every host). With one axis all ranks land on it; an explicit `shape`
    must multiply out to the world size. The first axis is the one to shard
    rows over."""
    from ..errors import MeshError
    from .mesh import create_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise MeshError(f"mesh shape {tuple(shape)} does not multiply out to {n} devices")
    return create_mesh(tuple(shape), tuple(axis_names), device=device)


def make_global_array(local_rows, mesh, axis_name: str = "data"):
    """A row-sharded `DTensor` from each rank's own rows (`DTensor.from_local`),
    for data too large to replicate. The blocks must be DTensor's own
    (`torch.chunk` order of the total rows), else MeshError."""
    from torch.distributed.tensor import DTensor

    from ..errors import MeshError
    from ._collectives import RowShard, mesh_device
    from .mesh import row_sharding

    t = torch.as_tensor(np.asarray(local_rows) if not isinstance(local_rows, torch.Tensor) else local_rows)
    t = t.to(mesh_device(mesh)).contiguous()
    sh = RowShard(mesh, 0, axis_name)
    counts = np.zeros(sh.world, np.int64)
    counts[sh.rank] = t.shape[0]
    (counts_t,) = sh.sum(torch.as_tensor(counts, device=t.device))
    counts = counts_t.cpu().numpy()
    n = int(counts.sum())
    chunk = -(-n // sh.world) if sh.world else 0
    expect = [max(0, min(chunk, n - q * chunk)) for q in range(sh.world)]
    if list(counts) != expect:
        raise MeshError(f"make_global_array: rows per rank {counts.tolist()} are not the blocks {expect} a DTensor "
                        f"of {n} rows holds")
    shape = (n,) + tuple(t.shape[1:])
    stride = tuple(int(s) for s in torch.empty(shape, device="meta").stride())
    return DTensor.from_local(t, mesh, row_sharding(mesh, axis_name, t.dim()), run_check=False, shape=shape,
                              stride=stride)


def process_allgather(x) -> np.ndarray:
    """Each process's `x` (the same shape on every process) stacked as
    [num_processes, ...] on every process; for host-side metadata (rows per
    shard, flags). One process returns ``x[None]``."""
    a = np.asarray(x)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return a[None]
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.as_tensor(a.astype(np.uint8) if a.dtype == bool else a).to(dev)
    buf = torch.zeros((world,) + tuple(t.shape), dtype=t.dtype, device=dev)
    buf[rank] = t
    out = all_reduce(buf).cpu().numpy()
    return out.astype(bool) if a.dtype == bool else out
