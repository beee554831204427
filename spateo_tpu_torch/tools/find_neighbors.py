"""Spatial kernel weights (capability parity: reference
spateo/tools/find_neighbors.py), the part MuSIC needs.

Counterpart of `spateo_tpu.tools.find_neighbors`: `_kernel_weights_batch`
and `_conditioned_kernel_weights_batch` build a [Q, N] block of weights on
the device of their inputs in one pass of tensor ops, and `get_wi_batch`
builds all N rows, block by block, into a host array (`get_wi_batch_tensor`
keeps them on the device). The per-sample numpy
path (`calculate_distance`, `local_dist`, `Kernel`, `get_wi`) is copied.

The distances keep the JAX package's matmul form and operand order,
``|q|^2 + |c|^2 - 2 q.c^T``; at nearly coincident points either package's
distance is the square root of a cancellation residual, so the two agree
there only to rounding (see `tests/test_torch_music.py`). A query's own
column is pinned to an exact 0 with `self_idx`.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from scipy.sparse import csr_matrix

from ..core.bridge import to_device


def calculate_distance(position: np.ndarray, dist_metric: str = "euclidean") -> np.ndarray:
    """Full pairwise distance matrix (parity: find_neighbors.py:28)."""
    from scipy.spatial.distance import cdist

    return cdist(position, position, metric=dist_metric)


def local_dist(coords_i: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Distances from one sample to all samples (parity: find_neighbors.py:35)."""
    return np.sqrt(((coords_i[None, :] - coords) ** 2).sum(axis=1))


def _distances(query: torch.Tensor, coords: torch.Tensor, self_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """[Q, N] euclidean distances in the JAX package's matmul form and
    operand order; `self_idx[q]` is the column set to exactly 0 in row q."""
    d2 = (query**2).sum(1)[:, None] + (coords**2).sum(1)[None, :] - 2 * (query @ coords.T)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    if self_idx is not None:
        cols = torch.arange(coords.shape[0], device=coords.device)
        dist = torch.where(self_idx[:, None] == cols[None, :], 0.0, dist)
    return dist


def _bandwidth(dist: torch.Tensor, bw, fixed: bool, exclude_self: bool, eps: float) -> torch.Tensor:
    """The kernel's bandwidth on the device: `bw` itself when `fixed`, else
    each row's (bw + exclude_self)-th smallest distance (0-based) times
    `eps`; NaN where a row has no such entry, as `take_along_axis` fills."""
    if fixed:
        # a 0-d device tensor, so that `dist / bandwidth` is a true division
        # (a Python or host scalar divisor becomes a multiply by its reciprocal)
        return torch.full((), float(bw), dtype=dist.dtype, device=dist.device)
    k = int(bw) + (1 if exclude_self else 0)
    if k >= dist.shape[1]:
        return torch.full((dist.shape[0], 1), float("nan"), dtype=dist.dtype, device=dist.device)
    kth = torch.topk(dist, k + 1, dim=1, largest=False, sorted=True).values[:, k : k + 1]
    return kth * eps


def _apply_kernel(bw_dist: torch.Tensor, function: str, exclude_self: bool, normalize: bool,
                  threshold: float) -> torch.Tensor:
    """The kernel of the bandwidth-scaled distances, with the reference's cuts
    (find_neighbors.py:505: 0 outside the bandwidth, then below `threshold`)."""
    if exclude_self:
        bw_dist = torch.where(bw_dist == 0.0, bw_dist.amax(dim=1, keepdim=True), bw_dist)
    x = bw_dist
    if function == "triangular":
        k_val = 1 - x
    elif function == "uniform":
        k_val = torch.ones_like(x) * 0.5
    elif function == "quadratic":
        k_val = (3.0 / 4) * (1 - x**2)
    elif function == "bisquare":
        k_val = (1 - x**2) ** 2
    elif function == "gaussian":
        k_val = torch.exp(-0.5 * x**2)
    elif function == "exponential":
        k_val = torch.exp(-x)
    else:
        raise ValueError(f"Unsupported kernel function {function}")
    k_val = torch.where(x > 1, 0.0, k_val)
    k_val = torch.where(k_val < threshold, 0.0, k_val)
    if normalize:
        nnz = (k_val > 0).sum(dim=1, keepdim=True)
        k_val = k_val / torch.clamp(nnz, min=1)
    return k_val


def _kernel_weights_batch(
    query: torch.Tensor,  # [Q, D] query positions
    coords: torch.Tensor,  # [N, D] all positions
    bw: Union[float, int],  # scalar (fixed) or int neighbor count (adaptive)
    function: str = "bisquare",
    fixed: bool = True,
    exclude_self: bool = False,
    normalize: bool = False,
    threshold: float = 1e-5,
    eps: float = 1.0000001,
    self_idx: Optional[torch.Tensor] = None,  # [Q] global column of each query's self
) -> torch.Tensor:
    """Kernel weights for a block of query samples, [Q, N], on the device of
    `query` (parity: the per-sample `Kernel` of reference
    find_neighbors.py:392, batched; `spateo_tpu` `_kernel_weights_batch`)."""
    dist = _distances(query, coords, self_idx)
    bandwidth = _bandwidth(dist, bw, fixed, exclude_self, eps)
    return _apply_kernel(dist / bandwidth, function, exclude_self, normalize, threshold)


def _conditioned_kernel_weights_batch(
    query: torch.Tensor,  # [Q, D] query positions (spatial or expression space)
    coords: torch.Tensor,  # [N, D] all positions (same space)
    bw: Union[float, int],  # scalar (fixed) or int neighbor count (adaptive)
    ct_query: torch.Tensor,  # [Q] int cell-type codes of the queries
    ct_all: torch.Tensor,  # [N] int cell-type codes of all samples
    cond_ct: torch.Tensor,  # [Q] bool: restrict this query to same-cell-type neighbors
    cov_all: Optional[torch.Tensor] = None,  # [N] bool: samples "of interest" (cov mask)
    cond_cov: Optional[torch.Tensor] = None,  # [Q] bool: apply the cov mask for this query
    function: str = "bisquare",
    fixed: bool = True,
    exclude_self: bool = False,
    normalize: bool = False,
    threshold: float = 1e-5,
    eps: float = 1.0000001,
    self_idx: Optional[torch.Tensor] = None,  # [Q] global column of each query's self
) -> torch.Tensor:
    """Batched kernel weights with the reference's hurdle-style conditioning
    (reference find_neighbors.py:481-490): per query, distances to samples of
    another cell type (where `cond_ct`) or failing the cov condition (where
    `cond_cov`) are pushed to that query's largest distance before the kernel
    is applied; the bandwidth comes from the unconditioned distances. One
    [Q, N] pass on the device of `query`, for MuSIC's per-cell
    `get_wi(i, cov=..., ct=...)` loop (reference MuSIC.py:2744)."""
    dist = _distances(query, coords, self_idx)
    bandwidth = _bandwidth(dist, bw, fixed, exclude_self, eps)
    max_d = dist.amax(dim=1, keepdim=True)
    mask = cond_ct[:, None] & (ct_all[None, :] != ct_query[:, None])
    dist = torch.where(mask, max_d, dist)
    if cov_all is not None and cond_cov is not None:
        dist = torch.where(cond_cov[:, None] & (~cov_all[None, :]), max_d, dist)
    return _apply_kernel(dist / bandwidth, function, exclude_self, normalize, threshold)


class Kernel:
    """Spatial kernel weights for one sample (parity surface:
    reference find_neighbors.py:392)."""

    def __init__(
        self,
        i: int,
        data,
        bw,
        cov: Optional[np.ndarray] = None,
        ct: Optional[np.ndarray] = None,
        expr_mat: Optional[np.ndarray] = None,
        fixed: bool = True,
        exclude_self: bool = False,
        function: str = "triangular",
        threshold: float = 1e-5,
        eps: float = 1.0000001,
        sparse_array: bool = False,
        normalize_weights: bool = False,
        use_expression_neighbors: bool = False,
    ):
        data = np.asarray(data)
        if use_expression_neighbors:
            dist = local_dist(np.asarray(expr_mat)[i], np.asarray(expr_mat))
            function = "uniform"
        else:
            dist = local_dist(data[i], data)
        self.function = function.lower()
        if fixed:
            self.bandwidth = float(bw)
        else:
            offset = 1 if exclude_self else 0
            self.bandwidth = np.partition(dist, int(bw) + offset)[int(bw) + offset] * eps
        max_dist = np.max(dist)
        if cov is not None and ct is not None:
            if cov[i] == 1:
                dist = np.where(np.asarray(ct) != ct[i], max_dist, dist)
        elif cov is not None:
            dist = np.where(np.asarray(cov) == 0, max_dist, dist)
        elif ct is not None:
            dist = np.where(np.asarray(ct) != ct[i], max_dist, dist)
        bw_dist = dist / self.bandwidth
        if exclude_self:
            bw_dist = np.where(bw_dist == 0.0, np.max(bw_dist), bw_dist)
        k = self._kernel_functions(bw_dist)
        k[bw_dist > 1] = 0
        k[k < threshold] = 0
        if normalize_weights:
            nnz = np.count_nonzero(k)
            k = k / max(nnz, 1)
        self.kernel = csr_matrix(k) if sparse_array else k

    def _kernel_functions(self, x):
        f = self.function
        if f == "triangular":
            return 1 - x
        if f == "uniform":
            return np.ones(x.shape) * 0.5
        if f == "quadratic":
            return (3.0 / 4) * (1 - x**2)
        if f == "bisquare":
            return (1 - x**2) ** 2
        if f == "gaussian":
            return np.exp(-0.5 * x**2)
        if f == "exponential":
            return np.exp(-x)
        raise ValueError(f"Unsupported kernel function {f}")


def get_wi(
    i: int,
    n_samples: int,
    coords: np.ndarray,
    cov: Optional[np.ndarray] = None,
    ct: Optional[np.ndarray] = None,
    expr_mat: Optional[np.ndarray] = None,
    fixed_bw: bool = True,
    exclude_self: bool = False,
    kernel: str = "gaussian",
    bw: Union[float, int] = 100,
    threshold: float = 1e-5,
    sparse_array: bool = False,
    normalize_weights: bool = False,
    use_expression_neighbors: bool = False,
) -> csr_matrix:
    """Kernel weights for one sample, on the host (parity: find_neighbors.py:534)."""
    if bw == 0:
        raise ValueError("Bandwidth cannot be 0.")
    k = Kernel(
        i,
        coords,
        bw,
        cov=cov,
        ct=ct,
        expr_mat=expr_mat,
        fixed=fixed_bw,
        exclude_self=exclude_self,
        function=kernel,
        threshold=threshold,
        sparse_array=sparse_array,
        normalize_weights=normalize_weights,
        use_expression_neighbors=use_expression_neighbors,
    ).kernel
    return k if sparse_array else csr_matrix(k)


def _wi_blocks(coords, bw, fixed_bw, exclude_self, kernel, normalize_weights, block, device):
    """The rows of `get_wi_batch`'s weights, `block` query rows at a time:
    (first row, [rows, N] float32 tensor on `device`)."""
    coords_d = to_device(np.asarray(coords, np.float32), device)
    for s in range(0, coords_d.shape[0], block):
        q = coords_d[s : s + block]
        yield s, _kernel_weights_batch(
            q,
            coords_d,
            bw,
            function=kernel,
            fixed=fixed_bw,
            exclude_self=exclude_self,
            normalize=normalize_weights,
            self_idx=torch.arange(s, s + q.shape[0], device=coords_d.device),
        )


def get_wi_batch(
    coords: np.ndarray,
    bw: Union[float, int],
    fixed_bw: bool = True,
    exclude_self: bool = False,
    kernel: str = "bisquare",
    normalize_weights: bool = False,
    block: int = 2048,
    device="cuda",
) -> np.ndarray:
    """Kernel weights of all samples, [N, N] float32 on the host, computed
    on `device` in blocks of `block` query rows (each block copied to the
    host once)."""
    n = len(coords)
    out = np.zeros((n, n), np.float32)
    for s, W in _wi_blocks(coords, bw, fixed_bw, exclude_self, kernel, normalize_weights, block, device):
        out[s : s + W.shape[0]] = W.cpu().numpy()
    return out


def get_wi_batch_tensor(
    coords: np.ndarray,
    bw: Union[float, int],
    fixed_bw: bool = True,
    exclude_self: bool = False,
    kernel: str = "bisquare",
    normalize_weights: bool = False,
    block: int = 2048,
    device="cuda",
) -> torch.Tensor:
    """`get_wi_batch`'s weights kept on `device` as one [N, N] float32
    tensor, for callers that fit from them there."""
    n = len(coords)
    out = None
    for s, W in _wi_blocks(coords, bw, fixed_bw, exclude_self, kernel, normalize_weights, block, device):
        if out is None:
            out = torch.empty((n, n), dtype=W.dtype, device=W.device)
        out[s : s + W.shape[0]] = W
    return out
