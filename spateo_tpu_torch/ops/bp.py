"""Sum-product belief propagation on a binary 2D grid MRF.

Counterpart of `spateo_tpu.ops.bp`. Binary states {background, cell}; node
potentials are the NB conditionals; the edge potential is Potts
[[p, q], [q, p]]. The standard 4-neighbourhood on a CUDA tensor runs the
hand-written fused iteration (`ops.bp_cuda`); any other neighbourhood, and
any CPU tensor, runs `_bp_kernel`, the generic version in plain PyTorch.
`_bp_kernel_sharded` runs either iteration on one rank's rows of a raster
split over the ranks of a `torch.distributed` mesh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .bp_cuda import OFFSETS4, bp_kernel, bp_step
from .image import circle


def create_neighbor_offsets(neighborhood: np.ndarray) -> np.ndarray:
    """Neighbourhood mask -> (D, 2) array of (dy, dx) offsets (centre removed)."""
    for s in neighborhood.shape:
        if s % 2 == 0:
            raise ValueError("`neighborhood` must have odd dimension sizes")
    neighborhood = np.asarray(neighborhood).astype(bool).copy()
    center = tuple((np.array(neighborhood.shape) - 1) // 2)
    neighborhood[center] = False
    coords = np.argwhere(neighborhood)
    return (coords - np.array(center)).astype(np.int16)


def _use_cuda_bp(offsets, tensor: torch.Tensor) -> bool:
    """True for a CUDA tensor with the standard 4-neighbourhood: the fused
    kernel then runs, and a failure to build or launch it raises. False for
    a CPU tensor or any other neighbourhood."""
    return tensor.device.type == "cuda" and set(map(tuple, offsets)) == set(OFFSETS4)


def _shift2d(arr: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """Shift a [H, W, C] array by (dy, dx): out[y, x] = arr[y - dy, x - dx],
    with `fill` where that falls outside."""
    H, W = arr.shape[0], arr.shape[1]
    out = torch.full_like(arr, fill)
    ys, yd = (slice(0, H - dy), slice(dy, H)) if dy >= 0 else (slice(-dy, H), slice(0, H + dy))
    xs, xd = (slice(0, W - dx), slice(dx, W)) if dx >= 0 else (slice(-dx, W), slice(0, W + dx))
    out[yd, xd] = arr[ys, xs]
    return out


def _bp_iter(phi: torch.Tensor, M: torch.Tensor, offsets, psi: torch.Tensor) -> torch.Tensor:
    """One synchronous iteration for any neighbourhood: M [D, H, W, 2], where
    M[d] is the incoming message INTO each pixel from its neighbour at
    -offsets[d], 0.5 where that neighbour is outside the raster."""
    rev = tuple(offsets.index((-dy, -dx)) for (dy, dx) in offsets)
    prod = phi * torch.prod(M, dim=0)  # [H,W,2]
    new_msgs = []
    for d, (dy, dx) in enumerate(offsets):
        # message from pixel i to neighbour j = i + (dy, dx), excluding
        # j's own previous message into i (direction rev[d])
        excl = prod / torch.clamp_min(M[rev[d]], 1e-30)
        out = excl @ psi
        out = out / torch.clamp_min(torch.sum(out, dim=-1, keepdim=True), 1e-30)
        new_msgs.append(_shift2d(out, dy, dx, 0.5))
    return torch.stack(new_msgs)


def _bp_belief(phi: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    belief = phi * torch.prod(M, dim=0)
    belief = belief / torch.clamp_min(torch.sum(belief, dim=-1, keepdim=True), 1e-30)
    return belief[..., 1]


def _bp_kernel(
    phi: torch.Tensor,  # [H, W, 2] node potentials (normalised)
    offsets: Tuple[Tuple[int, int], ...],
    p: float,
    q: float,
    precision: float,
    max_iter: int,
) -> torch.Tensor:
    """Loopy-BP marginals for any neighbourhood, with the L2 delta checked
    after every iteration."""
    H, W, _ = phi.shape
    psi = torch.tensor([[p, q], [q, p]], dtype=torch.float32, device=phi.device)
    M = torch.full((len(offsets), H, W, 2), 0.5, dtype=torch.float32, device=phi.device)
    i, delta = 0, float("inf")
    while i < max_iter and delta >= precision:
        M_new = _bp_iter(phi, M, offsets, psi)
        delta = float(torch.sqrt(torch.sum((M_new - M) ** 2)))
        M = M_new
        i += 1
    return _bp_belief(phi, M)


def bp_halo(offsets) -> int:
    """Rows a sharded BP needs from each side: the neighbourhood's reach."""
    return max(abs(int(dy)) for dy, _ in offsets)


def _bp_kernel_sharded(
    phi_ext: torch.Tensor,  # [rows, W, 2]: this rank's rows with bp_halo(offsets) halo rows
    top: int,  # phi_ext[top:top + sh.rows_local] are this rank's rows
    sh,  # parallel._collectives.RowShard over the raster's rows
    offsets: Tuple[Tuple[int, int], ...],
    p: float,
    q: float,
    precision: float,
    max_iter: int,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Loopy-BP marginals of this rank's rows, the raster's rows split over
    the ranks of `sh`. Each iteration exchanges the halo rows of the
    messages, runs one iteration on the widened rows and keeps this rank's:
    for the 4-neighbourhood `bp_step` (the CUDA kernel on a CUDA tensor, its
    plain version on a CPU tensor, f32 messages), else `_bp_iter`. The delta
    is taken after every iteration: the squared change of this rank's rows
    summed in float64 (both states of a message), added over the ranks in
    rank order and square-rooted, the same bits on every rank, so every rank
    stops at the same iteration (the fused loop's sqrt(2) is the second
    state). `stats` receives ``n_iter``."""
    n_own, W = sh.rows_local, phi_ext.shape[1]
    own = slice(top, top + n_own)
    depth = bp_halo(offsets)
    fused = set(map(tuple, offsets)) == set(OFFSETS4)
    dev = phi_ext.device
    if fused:
        phi_pl = torch.movedim(phi_ext, -1, 0).to(torch.float32).contiguous()  # [2, rows, W]
        M = torch.full((4, n_own, W), 0.5, dtype=torch.float32, device=dev)
    else:
        psi = torch.tensor([[p, q], [q, p]], dtype=torch.float32, device=dev)
        M = torch.full((len(offsets), n_own, W, 2), 0.5, dtype=torch.float32, device=dev)
    i, delta = 0, float("inf")
    while i < max_iter and delta >= precision:
        ext, t = sh.halo(M.transpose(0, 1), depth)  # rows first
        ext = ext.transpose(0, 1).contiguous()
        M_new = (bp_step(phi_pl, ext, p, q) if fused else _bp_iter(phi_ext, ext, offsets, psi))[:, t : t + n_own]
        d2 = torch.sum((M_new.to(torch.float64) - M.to(torch.float64)) ** 2)
        (d2,) = sh.sum(d2 * 2.0 if fused else d2)
        delta = float(torch.sqrt(d2))
        M = M_new.contiguous()
        i += 1
    if stats is not None:
        stats["n_iter"] = i
    if not fused:
        return _bp_belief(phi_ext[own], M)
    phi0, phi1 = phi_pl[0, own], phi_pl[1, own]
    belief0 = phi0 * M[0] * M[1] * M[2] * M[3]
    belief1 = phi1 * (1.0 - M[0]) * (1.0 - M[1]) * (1.0 - M[2]) * (1.0 - M[3])
    return belief1 / torch.clamp_min(belief0 + belief1, 1e-30)


def _cell_marginals_t(
    background: torch.Tensor,
    cell: torch.Tensor,
    neighborhood: Optional[np.ndarray] = None,
    p: float = 0.6,
    q: float = 0.4,
    precision: float = 1e-5,
    max_iter: int = 100,
) -> torch.Tensor:
    """`cell_marginals` on tensors: the marginals on their device. A CUDA
    tensor with the 4-neighbourhood takes `bp_kernel` (f32 messages, the
    delta read after every iteration), as the JAX package takes its Pallas
    loop on a TPU."""
    if cell.shape != background.shape:
        raise ValueError("`cell_probs` and `background_probs` must have the same shape")
    neighborhood = (neighborhood > 0) if neighborhood is not None else circle(3).astype(bool)
    if cell.dim() != neighborhood.ndim:
        raise ValueError("`neighborhood` and `cell_probs` must have the same number of dimensions")
    offsets = tuple(map(tuple, create_neighbor_offsets(neighborhood).tolist()))
    phi = torch.stack([background.to(torch.float32), cell.to(torch.float32)], dim=-1)
    phi = phi / torch.clamp_min(torch.sum(phi, dim=-1, keepdim=True), 1e-30)
    if _use_cuda_bp(offsets, phi):
        return bp_kernel(phi, float(p), float(q), float(precision), int(max_iter))
    return _bp_kernel(phi, offsets, float(p), float(q), float(precision), int(max_iter))


def cell_marginals(
    background_probs: np.ndarray,
    cell_probs: np.ndarray,
    neighborhood: Optional[np.ndarray] = None,
    p: float = 0.6,
    q: float = 0.4,
    precision: float = 1e-5,
    max_iter: int = 100,
    device="cuda",
) -> np.ndarray:
    """Marginal P(cell) per pixel by loopy BP on `device`; a host array."""
    up = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return _cell_marginals_t(up(background_probs), up(cell_probs), neighborhood, p, q, precision, max_iter).cpu().numpy()


def _run_bp_t(background: torch.Tensor, cell: torch.Tensor, k: int = 3, square: bool = False, p: float = 0.6,
              q: float = 0.4, precision: float = 1e-6, max_iter: int = 100) -> torch.Tensor:
    """`run_bp` on tensors."""
    neighborhood = np.ones((k, k)) if square else circle(k)
    return _cell_marginals_t(background, cell, neighborhood, p, q, precision, max_iter)


def run_bp(
    background_cond: np.ndarray,
    cell_cond: np.ndarray,
    k: int = 3,
    square: bool = False,
    p: float = 0.6,
    q: float = 0.4,
    precision: float = 1e-6,
    max_iter: int = 100,
    device="cuda",
) -> np.ndarray:
    """Marginal P(cell) with a size-k circular/square neighbourhood."""
    neighborhood = np.ones((k, k)) if square else circle(k)
    return cell_marginals(
        background_cond, cell_cond, neighborhood=neighborhood, p=p, q=q, precision=precision, max_iter=max_iter,
        device=device,
    )
