"""Heat-equation solvers of digitization: the Jacobi raster solve and the
graph heat equation.

Counterpart of `spateo_tpu.ops.stencil`. `jacobi_solve` runs blocks of
`check_every` Jacobi sweeps (`ops.jacobi_cuda.jacobi_block`: the CUDA kernel
on the card, the plain version on the CPU) and after each block the masked
relative L2 change, exactly as the JAX package's `lax.while_loop` does: the
state starts at (f, it=0, err=inf), the loop runs while ``err > max_err and
it <= max_itr``, and each block adds `check_every` to `it`, so `it` may
overshoot `max_itr` by up to one block. On the card the kernel's last launch
of a block computes the change's sums itself (f64, fixed order) and a small
kernel writes `err` on the device; on the CPU `_rel_change` computes it.
Each block ends with one read of `err` by the host: a solve makes
``it / check_every`` reads, and one more copies the result back
(`profiler.sync_audit` counts them: ``it / check_every`` under "float", one
under "array").
`graph_heat_solve` is the same loop over a neighbour graph in plain
PyTorch (XLA only in the JAX package). `jacobi_solve_sharded` splits the
raster's rows over the ranks of a `torch.distributed` mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bridge import _to_device
from .jacobi_cuda import jacobi_block
from .jacobi_cuda import rel_change_reference as _rel_change


def _heat_loop(step_block, x0: torch.Tensor, max_err: float, max_itr: int, check_every: int):
    """The JAX package's while_loop on the host: blocks of `check_every`
    steps until the relative change is at most `max_err` or `it` passes
    `max_itr`. `step_block(x)` returns the next state and its relative
    change (a 0-d tensor, read once per block). `max_err` is compared in
    float32, as JAX compares it."""
    max_err = float(np.float32(max_err))
    x, it, err = x0, 0, float("inf")
    while err > max_err and it <= max_itr:
        x, err_t = step_block(x)
        err, it = float(err_t), it + check_every
    return x, it, err


def jacobi_solve(
    init_field: np.ndarray,
    border: np.ndarray,
    mask: np.ndarray,
    max_err: float = 1e-10,
    max_itr: int = 100_000,
    check_every: int = 100,
    device="cuda",
):
    """Solve the Dirichlet-boundary heat equation on a raster.

    `border != 0` marks the Dirichlet pixels, which keep their values in
    `init_field`, as does the outermost ring; `mask` is the domain of the
    L2 norm. Returns (field * mask as numpy, iterations, final_err).

    On the card `err` is summed in f64, on the CPU and in the JAX package in
    f32; the two agree within 1e-5 relative
    (tests/test_torch_kernel_plans.py), so an `err` within that margin of
    `max_err` can stop the loop one block apart on the card and in JAX."""
    f0 = _to_device(np.asarray(init_field, np.float32), device)
    frozen = _to_device(np.asarray(border) != 0, device)
    mk = _to_device(np.asarray(mask, np.float32), device)
    # the pixels a sweep moves: the interior window minus the Dirichlet set
    upd = torch.zeros(f0.shape, dtype=torch.uint8, device=f0.device)
    upd[1:-1, 1:-1] = 1
    upd[frozen] = 0
    n = int(check_every)
    f, it, err = _heat_loop(lambda x: jacobi_block(x, upd, n, weight=mk), f0, max_err, int(max_itr), n)
    return (f * mk).numpy(force=True), int(it), float(err)


def _adjacency_slots(n: int, adj_rows: np.ndarray, adj_cols: np.ndarray):
    """[n, K] neighbour indices (padded with the node itself) and a 0/1 mask,
    each row's neighbours in the order they appear in the edge list."""
    rows = np.asarray(adj_rows, np.int64)
    cols = np.asarray(adj_cols, np.int64)
    counts = np.bincount(rows, minlength=n)
    K = max(int(counts.max()) if len(counts) else 0, 1)
    order = np.argsort(rows, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(rows)) - starts[rows[order]]
    adj_indices = np.tile(np.arange(n)[:, None], (1, K))
    adj_mask = np.zeros((n, K), np.float32)
    adj_indices[rows[order], slot] = cols[order]
    adj_mask[rows[order], slot] = 1.0
    return adj_indices, adj_mask


def graph_heat_solve(
    n: int,
    adj_rows: np.ndarray,
    adj_cols: np.ndarray,
    boundary_lower: np.ndarray,
    boundary_upper: np.ndarray,
    lh: float = 1.0,
    hh: float = 100.0,
    max_err: float = 1e-8,
    max_itr: int = 100_000,
    device="cuda",
):
    """Heat equation on a general graph (digitize_general): Dirichlet values
    `lh` and `hh` at the lower and upper node sets, every other node the
    mean of its neighbours, checked every 50 steps. Returns (values as
    numpy, iterations, err)."""
    check_every = 50
    adj_indices, adj_mask = _adjacency_slots(n, adj_rows, adj_cols)
    values0 = np.zeros(n, np.float32)
    values0[np.asarray(boundary_lower, int)] = lh
    values0[np.asarray(boundary_upper, int)] = hh
    fixed = np.zeros(n, bool)
    fixed[np.asarray(boundary_lower, int)] = True
    fixed[np.asarray(boundary_upper, int)] = True
    v0, idx, am, fx = (_to_device(x, device) for x in (values0, adj_indices, adj_mask, fixed))
    deg = torch.clamp_min(torch.sum(am, dim=1), 1.0)

    def block(v_old):
        v = v_old
        for _ in range(check_every):
            v = torch.where(fx, v0, torch.sum(v[idx] * am, dim=1) / deg)
        return v, _rel_change(v, v_old)

    v, it, err = _heat_loop(block, v0, max_err, int(max_itr), check_every)
    return v.cpu().numpy(), int(it), float(err)


def _halo_depth(check_every: int, cap: int = 100) -> int:
    """Sweeps between two halo exchanges of the sharded solve: the largest
    divisor of `check_every` up to `cap`, so that every block of
    `check_every` sweeps ends on an exchange. An exchange costs a collective
    (milliseconds with gloo); `h` halo rows a side cost 2h rows of sweeps a
    rank (microseconds at 2048 columns on the card), hence the deep halo."""
    return max(h for h in range(1, min(cap, check_every) + 1) if check_every % h == 0)


def jacobi_solve_sharded(
    init_field: np.ndarray,
    border: np.ndarray,
    mask: np.ndarray,
    max_err: float = 1e-10,
    max_itr: int = 100_000,
    check_every: int = 100,
    mesh=None,
    device="cuda",
):
    """Multi-device Jacobi solve (counterpart of
    `spateo_tpu.ops.stencil.jacobi_solve_sharded`, `:229-281`): the raster's
    rows split over the mesh's first axis (`parallel.create_mesh(device=
    device)` when `mesh` is None), every rank calling it with the whole
    raster and getting the whole answer.

    Each rank runs `jacobi_block` (the CUDA kernel on the card) on its rows
    plus `h` halo rows on each side for `h` sweeps, `h` the largest divisor
    of `check_every` up to 100, then keeps its own rows and exchanges the
    halos again. A stale halo row spoils one more row inward each sweep, so
    after `h` sweeps the own rows are exactly the serial sweeps': the
    answer equals `jacobi_solve`'s bit for bit on every pixel. The raster's
    outermost rows and columns stay pinned, as the serial kernel never
    updates them. After each block the masked relative change is two sums
    over own rows in float64, added over the ranks in rank order (the same
    bits on every rank, so every rank stops at the same block). One rank
    runs `jacobi_solve` itself, as the JAX package does."""
    import torch

    from ..parallel._collectives import RowShard
    from ..parallel.mesh import create_mesh

    mesh = mesh if mesh is not None else create_mesh(device=device)
    f0 = np.asarray(init_field, np.float32)
    H, W = f0.shape
    sh = RowShard(mesh, H)
    if sh.world <= 1:
        return jacobi_solve(init_field, border, mask, max_err=max_err, max_itr=max_itr, check_every=check_every,
                            device=sh.device)
    bd = np.asarray(border) != 0
    mk = np.asarray(mask, np.float32)
    # the pixels a sweep moves: the interior window minus the Dirichlet set
    upd = np.zeros((H, W), np.uint8)
    upd[1:-1, 1:-1] = 1
    upd[bd] = 0
    n = int(check_every)
    h = _halo_depth(n)
    idx = sh.halo_index(h)[sh.rank]
    upd_ext = _to_device(np.ascontiguousarray(upd[idx]), sh.device)
    w = _to_device(np.ascontiguousarray(sh.take(mk)), sh.device)

    def block(f_own):
        f = f_own
        for _ in range(n // h):
            ext, top = sh.halo(f, h)
            f = jacobi_block(ext, upd_ext, h)[top : top + sh.rows_local]
        sums = torch.stack([(((f - f_own) ** 2) * w).double().sum(), ((f * f) * w).double().sum()])
        d2, n2 = sh.sum(sums)[0]
        return f, torch.sqrt(d2 / torch.clamp_min(n2, 1e-30)).to(torch.float32)

    f, it, err = _heat_loop(block, _to_device(np.ascontiguousarray(sh.take(f0)), sh.device), max_err, int(max_itr), n)
    return sh.gather_rows(f * w).numpy(force=True), int(it), float(err)
