"""Row sharding over one axis of a device mesh, and the collectives of the
sharded paths (private).

A sharded function of the port is SPMD: every rank of the mesh calls it with
the same full host input and gets the same full host result. In between,
rank r of the sharded axis owns block r of the rows, in `torch.tensor_split`
order (blocks may be uneven, and may be empty). Only two collectives are
used, `all_reduce` and `broadcast`, which NCCL and gloo both take on CUDA
tensors; the rest is built from them:

- `RowShard.gather_rows` (an all-gather): each rank writes its block into a
  zeroed buffer of all the rows and the group sums it. ``x + 0`` is exact,
  so every rank holds the same bits.
- `RowShard.halo` (the halo exchange): the rows each rank asks for by
  global index, gathered the same way over the union of what the ranks ask
  for. A row may lie any number of ranks away, so a block thinner than a
  halo works.
- `RowShard.sum`: each rank writes its partial sums into its own slot of a
  zeroed [world, n] buffer, the group sums it, and every rank adds the slots
  in rank order. Every rank gets the same bits, which a stop test or a
  replicated solve needs: ranks whose tests diverged would hang.

`STATS` counts the collectives and the bytes they reduce; with
``STATS["timed"]`` set, it also adds their seconds, the card synchronised
before and after each one.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

#: Collectives run in this process: calls, bytes reduced, and seconds when
#: ``timed`` is set.
STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "timed": False}


def reset_stats(timed: bool = False) -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0, timed=bool(timed))


def local_rank() -> int:
    """This process's rank on its host: ``LOCAL_RANK`` as launchers set it,
    else the global rank (one host), else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def set_rank_device(device_type: str) -> torch.device:
    """Select this rank's card, ``cuda:{local_rank % device_count}``, and
    return the rank's device (the CPU for ``"cpu"``)."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"a mesh runs on 'cuda' or 'cpu', not {device_type!r}")
    index = local_rank() % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def check_device(mesh, device) -> None:
    """Raise if `mesh` is not a `DeviceMesh`, or a caller's `device` is of
    another type than the mesh's."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed.device_mesh.DeviceMesh, got {type(mesh).__name__}")
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(f"device {device!r} and a mesh on {mesh.device_type!r}: the mesh sets where the ranks run")


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on in `mesh`."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def _exchange_dtype(dtype: torch.dtype) -> torch.dtype:
    # masks travel as float32: every backend reduces it on every device
    return torch.float32 if dtype == torch.bool else dtype


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def all_reduce(buf: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """`dist.all_reduce` in place, counted in `STATS` (and timed)."""
    STATS["calls"] += 1
    STATS["bytes"] += buf.numel() * buf.element_size()
    if not STATS["timed"]:
        dist.all_reduce(buf, op=op, group=group)
        return buf
    _sync(buf.device)
    t0 = time.perf_counter()
    dist.all_reduce(buf, op=op, group=group)
    _sync(buf.device)
    STATS["seconds"] += time.perf_counter() - t0
    return buf


def broadcast(buf: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """`dist.broadcast` in place from the group's rank `src`, counted in
    `STATS` (and timed)."""
    STATS["calls"] += 1
    STATS["bytes"] += buf.numel() * buf.element_size()
    t0 = time.perf_counter() if STATS["timed"] else None
    if t0 is not None:
        _sync(buf.device)
    dist.broadcast(buf, src=dist.get_global_rank(group, src) if group is not None else src, group=group)
    if t0 is not None:
        _sync(buf.device)
        STATS["seconds"] += time.perf_counter() - t0
    return buf


def block_bounds(n: int, world: int) -> np.ndarray:
    """[world + 1] row offsets of the blocks `torch.tensor_split` makes of n
    rows: the first ``n % world`` blocks hold one row more."""
    sizes = np.full(world, n // world, np.int64)
    sizes[: n % world] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


class RowShard:
    """Rows 0..n-1 split over the mesh axis `axis` (its first by default).

    ``lo:hi`` are this rank's rows, ``bounds`` every rank's offsets, `device`
    the rank's device. The other axes of the mesh hold replicas that compute
    the same thing."""

    def __init__(self, mesh, n: int, axis=None):
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed.device_mesh.DeviceMesh, got {type(mesh).__name__}")
        names = list(mesh.mesh_dim_names or ())
        dim = 0 if axis is None else (names.index(axis) if isinstance(axis, str) else int(axis))
        self.group = mesh.get_group(dim)
        self.world = int(mesh.size(dim))
        self.rank = int(mesh.get_local_rank(dim))
        self.device = mesh_device(mesh)
        self.n = int(n)
        self.bounds = block_bounds(self.n, self.world)
        self.lo, self.hi = int(self.bounds[self.rank]), int(self.bounds[self.rank + 1])
        self._plans = {}

    @property
    def rows_local(self) -> int:
        return self.hi - self.lo

    def take(self, x):
        """This rank's rows of `x` (the first axis)."""
        return x[self.lo : self.hi]

    # -- reductions ----------------------------------------------------------
    def sum(self, *parts: torch.Tensor):
        """The sum over ranks of each tensor in `parts` (one dtype), added in
        rank order: the same bits on every rank. One collective for all of
        them; returns a tuple shaped as `parts`."""
        if self.world == 1:
            return tuple(parts)
        flat = torch.cat([p.reshape(-1) for p in parts])
        buf = torch.zeros((self.world, flat.numel()), dtype=flat.dtype, device=flat.device)
        buf[self.rank] = flat
        all_reduce(buf, group=self.group)
        acc = buf[0]
        for r in range(1, self.world):
            acc = acc + buf[r]
        out, o = [], 0
        for p in parts:
            out.append(acc[o : o + p.numel()].reshape(p.shape))
            o += p.numel()
        return tuple(out)

    def stack(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's `x` (one shape on every rank) as [world, ...], on
        every rank."""
        dt = x.dtype
        buf = torch.zeros((self.world,) + tuple(x.shape), dtype=_exchange_dtype(dt), device=x.device)
        buf[self.rank] = x
        if self.world > 1:
            all_reduce(buf, group=self.group)
        return buf.to(dt)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        if self.world == 1:
            return x
        return all_reduce(x.clone(), dist.ReduceOp.MIN, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        if self.world == 1:
            return x
        return all_reduce(x.clone(), dist.ReduceOp.MAX, self.group)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """`x` as rank `src` of the axis holds it, on every rank."""
        if self.world == 1:
            return x
        dt = x.dtype
        buf = x.to(_exchange_dtype(dt)).contiguous().clone()
        return broadcast(buf, src, self.group).to(dt)

    # -- row exchanges -------------------------------------------------------
    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's block stacked into all n rows, on every rank."""
        if self.world == 1:
            return local
        dt = local.dtype
        buf = torch.zeros((self.n,) + tuple(local.shape[1:]), dtype=_exchange_dtype(dt), device=local.device)
        buf[self.lo : self.hi] = local
        return all_reduce(buf, group=self.group).to(dt)

    def _rows_plan(self, wanted: Sequence[np.ndarray], device):
        """How to hand each rank the global rows it asks for (`wanted[q]`,
        the same list on every rank): the union of the lists, the rows of it
        this rank owns, and where this rank's own list lies in it."""
        want = np.asarray(wanted[self.rank], np.int64)
        union = np.unique(np.concatenate([np.asarray(w, np.int64) for w in wanted])) if self.world > 1 else want
        mine = np.nonzero((union >= self.lo) & (union < self.hi))[0]
        dev = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        return dict(n=len(union), mine=dev(mine), src=dev(union[mine] - self.lo),
                    take=dev(np.searchsorted(union, want) if self.world > 1 else want - self.lo))

    def _exchange(self, local: torch.Tensor, plan: dict) -> torch.Tensor:
        if self.world == 1:
            return local[plan["take"]]
        dt = local.dtype
        buf = torch.zeros((plan["n"],) + tuple(local.shape[1:]), dtype=_exchange_dtype(dt), device=local.device)
        if plan["n"]:
            buf[plan["mine"]] = local[plan["src"]].to(buf.dtype)
            all_reduce(buf, group=self.group)
        return buf[plan["take"]].to(dt)

    def halo_index(self, depth: int, reflect: bool = False):
        """Per rank, the global rows of its block widened by `depth` on each
        side: clipped to [0, n), or with ``reflect`` mirrored about the
        raster's edges as `ops.image._reflect_pad` pads (row -1 is row 0)."""
        out = []
        for q in range(self.world):
            idx = np.arange(self.bounds[q] - depth, self.bounds[q + 1] + depth)
            if reflect:
                idx = np.where(idx < 0, -idx - 1, idx)
                idx = np.where(idx >= self.n, 2 * self.n - 1 - idx, idx)
            else:
                idx = idx[(idx >= 0) & (idx < self.n)]
            out.append(idx)
        return out

    def halo(self, local: torch.Tensor, depth: int, reflect: bool = False):
        """This rank's rows widened by `depth` rows (see `halo_index`); only
        rows outside each rank's own block travel. Returns (rows, top), where
        ``rows[top:top + rows_local]`` are this rank's own. The exchange plan
        is kept for the next call with the same depth."""
        key = (depth, reflect, local.device)
        plan = self._plans.get(key)
        if plan is None:
            idx_all = self.halo_index(depth, reflect)
            outside = [i[(i < self.bounds[q]) | (i >= self.bounds[q + 1])] for q, i in enumerate(idx_all)]
            idx = idx_all[self.rank]
            own = (idx >= self.lo) & (idx < self.hi)
            dev = lambda a: torch.as_tensor(a, dtype=torch.int64, device=local.device)
            plan = self._plans[key] = dict(
                rows=self._rows_plan(outside, local.device), n=len(idx), own=dev(np.nonzero(own)[0]),
                own_src=dev(idx[own] - self.lo), ext=dev(np.nonzero(~own)[0]),
                top=depth if reflect else self.lo - max(self.lo - depth, 0),
            )
        got = self._exchange(local, plan["rows"])
        out = torch.empty((plan["n"],) + tuple(local.shape[1:]), dtype=local.dtype, device=local.device)
        out[plan["own"]] = local[plan["own_src"]]
        out[plan["ext"]] = got
        return out, plan["top"]
