"""Spatial kernel weights and neighbour graphs (capability parity:
reference spateo/tools/find_neighbors.py).

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

The neighbour graphs (`neighbors`, `construct_nn_graph`) take their kNN
from `knn`, on the device, in place of scikit-learn's `NearestNeighbors`:
difference-form distances in float64, each row ordered by distance, then by
index. Queried with the fitted points, every point is its own first
neighbour (distance 0), as `kneighbors_graph(X)` counts it. Where two
points tie at a row's k-th distance scikit-learn's trees keep either; the
port keeps the lower index (`tests/test_torch_cluster.py` pins it on a
lattice). `radius_neighbors` (and `radius_neighbors_graph`) stand in for
scikit-learn's radius queries with their ``dist <= r`` test on the squared
distance (`tests/test_torch_external.py` holds them to scikit-learn's on a
lattice at radii on its distances).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from scipy.sparse import csr_matrix

from ..core.anndata import AnnData
from ..core.bridge import _to_device
from ..logging import logger_manager as lm

#: Entries of one [rows, n] block of distances `knn` sorts at a time.
KNN_ELEMS = 1 << 25


def calculate_distance(position: np.ndarray, dist_metric: str = "euclidean") -> np.ndarray:
    """Full pairwise distance matrix (parity: find_neighbors.py:28)."""
    from scipy.spatial.distance import cdist

    return cdist(position, position, metric=dist_metric)


def local_dist(coords_i: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Distances from one sample to all samples (parity: find_neighbors.py:35)."""
    return np.sqrt(((coords_i[None, :] - coords) ** 2).sum(axis=1))


def jaccard_index(row_i: np.ndarray, array: np.ndarray) -> np.ndarray:
    """Jaccard index of one binary row vs all rows (parity: find_neighbors.py:51)."""
    row_i = row_i.astype(bool)
    array = array.astype(bool)
    inter = (array & row_i).sum(axis=1)
    union = (array | row_i).sum(axis=1)
    return inter / np.maximum(union, 1)


def normalize_adj(adj: np.ndarray, exclude_self: bool = True) -> np.ndarray:
    """Symmetric degree normalization D^-1/2 (A) D^-1/2 (parity:
    find_neighbors.py:67)."""
    adj = np.asarray(adj, dtype=float)
    if exclude_self:
        adj = adj - np.diag(np.diag(adj))
    d = adj.sum(axis=1)
    d_inv_sqrt = np.where(d > 0, 1.0 / np.sqrt(d), 0.0)
    return adj * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]


def adj_to_knn(adj: np.ndarray, n_neighbors: int = 15) -> Tuple[np.ndarray, np.ndarray]:
    """Dense adjacency -> (indices, weights) of the top-n entries per row
    (parity: find_neighbors.py:94)."""
    adj = np.asarray(adj)
    idx = np.argsort(-adj, axis=1)[:, :n_neighbors]
    wts = np.take_along_axis(adj, idx, axis=1)
    return idx, wts


def knn_to_adj(knn_indices: np.ndarray, knn_weights: np.ndarray) -> csr_matrix:
    """(indices, weights) -> sparse adjacency (parity: find_neighbors.py:126)."""
    n, k = knn_indices.shape
    rows = np.repeat(np.arange(n), k)
    return csr_matrix((knn_weights.ravel(), (rows, knn_indices.ravel())), shape=(n, n))


def knn(X: np.ndarray, k: int, device="cuda", metric: str = "euclidean",
        Y: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Each point's k nearest points among `X`, itself included (or, with
    `Y`, each row of `Y`'s among `X`): ([n, k] int64 indices, [n, k] float64
    distances) on the host, each row ordered by distance, then by index.

    The euclidean distances are sqrt(sum_d (x_d - y_d)^2) in float64 on
    `device` (`torch.cdist` in its difference form, the form of
    scikit-learn's trees); another metric's come from scipy's `cdist` on the
    host. Rows go `KNN_ELEMS // n` at a time through a stable sort, so equal
    distances keep their index order; the result is copied to the host once."""
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    Y = X if Y is None else np.asarray(Y, dtype=np.float64).reshape(-1, X.shape[1])
    n = len(X)
    k = min(int(k), n)
    Xd = _to_device(X, device)
    Yd = Xd if Y is X else _to_device(Y, device)
    idx = torch.empty((len(Y), k), dtype=torch.int64, device=Xd.device)
    dist = torch.empty((len(Y), k), dtype=torch.float64, device=Xd.device)
    rows = max(1, KNN_ELEMS // max(n, 1))
    for s in range(0, len(Y), rows):
        if metric == "euclidean":
            D = torch.cdist(Yd[s : s + rows], Xd, compute_mode="donot_use_mm_for_euclid_dist")
        else:
            from scipy.spatial.distance import cdist

            D = _to_device(cdist(Y[s : s + rows], X, metric=metric), device)
        D, order = torch.sort(D, dim=1, stable=True)
        idx[s : s + rows] = order[:, :k]
        dist[s : s + rows] = D[:, :k]
    return idx.cpu().numpy(), dist.cpu().numpy()


def radius_neighbors(X: np.ndarray, radius: float, device="cuda") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The points of `X` within `radius` of each point (itself included):
    (indptr [n + 1], indices, distances) on the host, a row's neighbours by
    index, as scikit-learn's ``radius_neighbors(X, sort_results=False)``
    gives the set.

    scikit-learn's trees keep a point when its squared distance, summed over
    the dimensions in order in float64, is ``<= radius**2``; the test here is
    the same, on `device`, `KNN_ELEMS // n` rows at a time, with one host read
    a block. The distance is the square root of that sum."""
    X = np.asarray(X, dtype=np.float64)
    X = X[:, None] if X.ndim == 1 else X
    Xd = _to_device(X, device)
    r2 = float(radius) * float(radius)
    rows = max(1, KNN_ELEMS // max(len(X), 1))
    counts, cols, dists = [], [], []
    for s in range(0, len(X), rows):
        d2 = torch.zeros((len(Xd[s : s + rows]), len(X)), dtype=torch.float64, device=Xd.device)
        for j in range(X.shape[1]):
            d2 += (Xd[s : s + rows, j, None] - Xd[None, :, j]) ** 2
        hit = d2 <= r2
        r, c = hit.nonzero(as_tuple=True)
        counts.append(hit.sum(1).cpu().numpy())
        cols.append(c.cpu().numpy())
        dists.append(torch.sqrt(d2[r, c]).cpu().numpy())
    indptr = np.concatenate([[0], np.cumsum(np.concatenate(counts))]) if counts else np.zeros(1, np.int64)
    empty = np.zeros(0)
    return (indptr.astype(np.int64), np.concatenate(cols).astype(np.int64) if cols else empty.astype(np.int64),
            np.concatenate(dists) if dists else empty)


def radius_neighbors_graph(X: np.ndarray, radius: float, mode: str = "connectivity", device="cuda") -> csr_matrix:
    """scikit-learn's ``NearestNeighbors(radius=radius).fit(X).
    radius_neighbors_graph(X, mode=mode)`` from `radius_neighbors`."""
    indptr, cols, dists = radius_neighbors(X, radius, device=device)
    data = dists if mode == "distance" else np.ones(len(cols))
    return csr_matrix((data, cols, indptr), shape=(len(indptr) - 1, len(np.asarray(X))))


def _knn_graph(idx: np.ndarray, data: np.ndarray, n: int) -> csr_matrix:
    """scikit-learn's `kneighbors_graph` layout: row i holds its k
    neighbours in neighbour order."""
    rows, k = idx.shape
    return csr_matrix((np.ravel(data), idx.ravel(), np.arange(0, rows * k + 1, k)), shape=(rows, n))


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
    coords_d = _to_device(np.asarray(coords, np.float32), device)
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


def find_bw_for_n_neighbors(
    adata: AnnData,
    coords_key: str = "spatial",
    n_anchors: Optional[int] = None,
    target_n_neighbors: int = 6,
    initial_bw: Optional[float] = None,
    chunk_size: int = 1000,
    exclude_self: bool = False,
    normalize_distances: bool = False,
    verbose: bool = True,
    max_iterations: int = 100,
    alpha: float = 0.5,
) -> float:
    """Bandwidth such that the average cell has ~`target_n_neighbors` within
    it (parity: find_neighbors.py:215): the mean k-th neighbour distance of
    the anchor cells, by the host cKDTree as in the JAX package."""
    coords = np.asarray(adata.obsm[coords_key], dtype=float)
    rng = np.random.default_rng(0)
    n_use = len(coords) if n_anchors is None else min(n_anchors, len(coords))
    anchors = rng.choice(len(coords), n_use, replace=False)
    from scipy.spatial import cKDTree

    tree = cKDTree(coords)
    kth = tree.query(coords[anchors], k=target_n_neighbors + 1)[0][:, -1]
    bw = float(np.mean(kth))
    if verbose:
        lm.main_info(f"Estimated bandwidth for ~{target_n_neighbors} neighbors: {bw:.4f}")
    return bw


def find_threshold_distance(
    adata: AnnData,
    coords_key: str = "X_pca",
    n_neighbors: int = 10,
    chunk_size: int = 1000,
    normalize_distances: bool = False,
    device="cuda",
) -> float:
    """Distance beyond which there is a dramatic increase in the average
    distance to the remaining nearest neighbors (parity:
    find_neighbors.py:336-387): the max over cells of mean + 3 std of the
    n_neighbors smallest distances, self-distance included, with the
    optional shared-nonzero-column normalization."""
    coords = np.asarray(adata.obsm[coords_key], dtype=float)
    if normalize_distances:
        n_nonzeros = {i: set(np.nonzero(coords[i, :])[0]) for i in range(coords.shape[0])}
    else:
        n_nonzeros = None
    chunks = []
    for i in range(0, coords.shape[0], chunk_size):
        chunks.append(calculate_distances_chunk(coords[i : i + chunk_size], i, coords, n_nonzeros=n_nonzeros,
                                                device=device))
    distances = np.concatenate(chunks, axis=0)
    k_nearest = np.sort(distances)[:, :n_neighbors]
    return float(np.max(k_nearest.mean(axis=1) + 3 * k_nearest.std(axis=1)))


def construct_nn_graph(
    adata: AnnData,
    spatial_key: str = "spatial",
    dist_metric: str = "euclidean",
    n_neighbors: int = 8,
    exclude_self: bool = True,
    make_symmetrical: bool = False,
    save_id: Union[bool, str] = False,
    device="cuda",
) -> None:
    """KNN graph into `.obsp['adj']` (parity: find_neighbors.py:609), the
    neighbours from `knn` on `device`."""
    position = np.asarray(adata.obsm[spatial_key], dtype=float)
    k = n_neighbors + (1 if exclude_self else 0)
    idx, _ = knn(position, min(k, len(position)), device=device, metric=dist_metric)
    rows = np.repeat(np.arange(len(position)), idx.shape[1])
    cols = idx.ravel()
    if exclude_self:
        keep = rows != cols
        rows, cols = rows[keep], cols[keep]
    adj = csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(len(position), len(position)))
    if make_symmetrical:
        adj = adj.maximum(adj.T)
    adata.obsp["adj"] = adj
    if save_id:
        adata.obs[save_id if isinstance(save_id, str) else "nn_id"] = np.arange(adata.n_obs)


def neighbors(
    adata: AnnData,
    basis: str = "pca",
    spatial_key: str = "spatial",
    n_neighbors_method: str = "ball_tree",
    n_pca_components: int = 30,
    n_neighbors: int = 10,
    device="cuda",
) -> Tuple[csr_matrix, AnnData]:
    """Expression or spatial KNN graph (parity: find_neighbors.py:672), the
    neighbours from `knn` on `device`. Returns (connectivities, adata);
    distances and connectivities go to `.obsp`, the neighbour indices to
    `.uns`. `n_neighbors_method` is recorded (every method finds the same
    neighbours)."""
    if basis == "spatial":
        X_data = np.asarray(adata.obsm[spatial_key], dtype=float)
    else:
        if "X_pca" not in adata.obsm:
            from .dimensionality_reduction import pca

            pca(adata, n_pca_components=n_pca_components, device=device)
        X_data = np.asarray(adata.obsm["X_pca"])[:, :n_pca_components]
    k = min(n_neighbors, adata.n_obs)
    indices, dists = knn(X_data, k, device=device)
    prefix = "spatial_" if basis == "spatial" else "expression_"
    adata.obsp[f"{prefix}distances"] = _knn_graph(indices, dists, len(X_data))
    adata.obsp[f"{prefix}connectivities"] = _knn_graph(indices, np.ones(indices.size), len(X_data))
    adata.uns[f"{prefix}neighbors"] = {
        "indices": indices,
        "params": {"n_neighbors": k, "method": n_neighbors_method, "metric": "euclidean"},
    }
    return adata.obsp[f"{prefix}connectivities"], adata


def calculate_affinity(position: np.ndarray, dist_metric: str = "euclidean", n_neighbors: int = 10) -> np.ndarray:
    """Gaussian affinity matrix from pairwise distances (parity:
    find_neighbors.py:771)."""
    dist = calculate_distance(position, dist_metric)
    sigma = np.sort(dist, axis=1)[:, min(n_neighbors, dist.shape[1] - 1)]
    aff = np.exp(-(dist**2) / (2 * sigma[:, None] * sigma[None, :]))
    np.fill_diagonal(aff, 0)
    return aff


def calculate_distances_chunk(
    coords_chunk: np.ndarray,
    chunk_start_idx: int = 0,
    coords: np.ndarray = None,
    n_nonzeros: Optional[dict] = None,
    metric: str = "euclidean",
    device="cuda",
) -> np.ndarray:
    """Pairwise distances of one chunk vs all (parity: reference
    find_neighbors.py:182-211, incl. the optional shared-nonzero-column
    normalization). The euclidean path runs on `device` in float32 with the
    JAX package's `euc_dist` form; other metrics go through scipy's cdist."""
    if coords is None:  # back-compat: (chunk, coords) positional form
        coords, chunk_start_idx = chunk_start_idx, 0
    if metric == "euclidean":
        from ..alignment.methods.math import euc_dist

        distances_chunk = euc_dist(_to_device(np.asarray(coords_chunk, np.float32), device),
                                   _to_device(np.asarray(coords, np.float32), device), squared=False).cpu().numpy()
    else:
        from scipy.spatial.distance import cdist

        distances_chunk = cdist(np.asarray(coords_chunk, float), np.asarray(coords, float), metric=metric)
    if n_nonzeros is not None:
        paired = np.zeros_like(distances_chunk)
        for i in range(distances_chunk.shape[0]):
            row_nz = n_nonzeros[chunk_start_idx + i]
            for j in range(distances_chunk.shape[1]):
                paired[i, j] = len(row_nz & n_nonzeros[j])
        with np.errstate(divide="ignore", invalid="ignore"):
            distances_chunk = np.where(paired > 0, distances_chunk / paired, np.inf)
    return distances_chunk


def compute_distances_and_connectivities(knn_indices: np.ndarray, distances: np.ndarray):
    """kNN structure -> sparse distance + binary connectivity matrices
    (parity: reference find_neighbors.py compute_distances_and_connectivities)."""
    n, k = knn_indices.shape
    rows = np.repeat(np.arange(n), k)
    cols = np.asarray(knn_indices).ravel()
    dvals = np.asarray(distances).ravel()
    dist = csr_matrix((dvals, (rows, cols)), shape=(n, n))
    conn = csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    conn = conn.maximum(conn.T)
    return dist, conn
