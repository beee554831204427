"""SVG utilities (counterpart of `spateo_tpu.svg.utils`; reference
spateo/svg/utils.py).

- The gene scan `cal_wass_dis_batch` runs every gene's OT distance to one
  target as a batched log-domain Sinkhorn on the device
  (`_sinkhorn_batch_kernel`), chunk by chunk, with the JAX package's chunk
  size, padding rows and stop rule (one global test of ``max|g_new - g|`` a
  block of 10 sweeps, one host read a block; NaN stops it).
- The spatial graphs (`_knn_distance_graph`, `knn_indices`), Floyd-Warshall,
  loess and the multiple-testing corrections are host numpy/scipy, copied.
  Neighbours are chosen by one deterministic rule, distance first, then
  index (scikit-learn's kd-tree breaks ties at the k-th distance in an order
  of its own; the GPU machine has no scikit-learn).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch
from scipy.sparse import csr_matrix, issparse
from scipy.sparse.csgraph import floyd_warshall

from ..core.anndata import AnnData
from ..core.bridge import _to_device
from ..logging import logger_manager as lm


def bin_adata(adata: AnnData, bin_size: int = 1, layer: str = "spatial") -> AnnData:
    """Bin cells by spatial coordinates (parity: svg/utils.py:19)."""
    if bin_size <= 1:
        out = adata.copy()
        out.obsm[layer] = np.asarray(out.obsm[layer], dtype=float)
        return out
    from ..preprocessing.aggregate import bin_adata as _bin

    return _bin(adata, bin_size=bin_size, coords_key=layer)


def shuffle_adata(adata: AnnData, seed: int = 0, replace: bool = False) -> AnnData:
    """Shuffle X rows for permutation testing (parity: svg/utils.py:50).
    seed == 0 returns the original data."""
    adata = adata.copy()
    if seed == 0:
        return adata
    rng = np.random.default_rng(seed)
    idx = rng.choice(adata.n_obs, adata.n_obs, replace=replace) if replace else rng.permutation(adata.n_obs)
    adata.X = adata.X[idx]
    return adata


def add_pos_ratio_to_adata(adata: AnnData, layer: Optional[str] = None, var_name: str = "raw_pos_rate"):
    """Fraction of cells expressing each gene (parity: svg/utils.py:123)."""
    X = adata.X if layer is None else adata.layers[layer]
    pos = np.asarray((X > 0).sum(axis=0)).ravel()
    adata.var[var_name] = pos / adata.n_obs


def filter_adata_by_pos_ratio(adata: AnnData, pos_ratio: float = 0.1, var_name: str = "raw_pos_rate") -> AnnData:
    if var_name not in adata.var.columns:
        add_pos_ratio_to_adata(adata, var_name=var_name)
    return adata[:, np.asarray(adata.var[var_name]) >= pos_ratio]


def get_genes_by_pos_ratio(adata: AnnData, pos_ratio: float = 0.1, var_name: str = "raw_pos_rate") -> np.ndarray:
    if var_name not in adata.var.columns:
        add_pos_ratio_to_adata(adata, var_name=var_name)
    return np.asarray(adata.var_names[np.asarray(adata.var[var_name]) >= pos_ratio])


def knn_indices(coords: np.ndarray, k: int):
    """Each point's k nearest points, itself included: ([n, k] indices, [n, k]
    euclidean distances), ordered by distance, then by index. The distances
    are sqrt(sum_d (x_d - y_d)^2) in float64, as a kd-tree computes them.

    A cKDTree gives each row's k-th distance; every point within it (all ties
    at the k-th distance included) is collected, and the candidates are
    sorted by (distance, index)."""
    from scipy.spatial import cKDTree

    coords = np.asarray(coords, dtype=float)
    n = len(coords)
    k = min(k, n)
    tree = cKDTree(coords)
    dk = tree.query(coords, k=[k])[0][:, 0]
    cand = tree.query_ball_point(coords, r=dk * (1 + 1e-9) + 1e-300, return_sorted=False)
    lens = np.fromiter((len(c) for c in cand), dtype=np.int64, count=n)
    rows = np.repeat(np.arange(n), lens)
    cols = np.fromiter((j for c in cand for j in c), dtype=np.int64, count=int(lens.sum()))
    dist = np.sqrt(((coords[rows] - coords[cols]) ** 2).sum(1))
    order = np.lexsort((cols, dist, rows))
    rank = np.arange(len(order)) - np.repeat(np.cumsum(lens) - lens, lens)
    take = order[rank < k]
    return cols[take].reshape(n, k), dist[take].reshape(n, k)


def _knn_distance_graph(coords: np.ndarray, n_neighbors: int) -> csr_matrix:
    """[n, n] graph of each point's `n_neighbors` nearest other points
    (itself included, at distance 0), by `knn_indices`' rule."""
    n = len(coords)
    idx, dist = knn_indices(coords, n_neighbors + 1)
    k = idx.shape[1]
    return csr_matrix((dist.ravel(), idx.ravel(), np.arange(0, n * k + 1, k)), shape=(n, n))


def cal_geodesic_distance(
    adata: AnnData,
    layer: str = "spatial",
    n_neighbors: int = 30,
    min_dis_cutoff: float = 2.0,
    max_dis_cutoff: float = 4.0,
) -> AnnData:
    """All-pairs geodesic distance over the spatial KNN graph (parity:
    svg/utils.py:148): filter isolated/sparse cells, then Floyd-Warshall."""
    coords = np.asarray(adata.obsm[layer], dtype=float)
    G = _knn_distance_graph(coords, n_neighbors).toarray()
    pos = np.where(G > 0, G, np.inf)
    keep = np.min(pos, axis=1) <= min_dis_cutoff
    b = adata[keep, :]
    lm.main_info(f"The cell/buckets number after filtering by min_dis_cutoff is {b.n_obs}")
    coords = np.asarray(b.obsm[layer], dtype=float)
    G = _knn_distance_graph(coords, n_neighbors).toarray()
    keep2 = np.max(G, axis=1) <= max_dis_cutoff
    b = b[keep2, :]
    lm.main_info(f"The cell/buckets number after filtering by max_dis_cutoff is {b.n_obs}")
    coords = np.asarray(b.obsm[layer], dtype=float)
    G = _knn_distance_graph(coords, n_neighbors).toarray()
    G[~np.isfinite(G)] = 0
    b.obsp["distance"] = floyd_warshall(csgraph=csr_matrix(G), directed=False)
    return b


def cal_euclidean_distance(
    adata: AnnData,
    layer: str = "spatial",
    min_dis_cutoff: float = np.inf,
    max_dis_cutoff: float = np.inf,
) -> AnnData:
    """Dense pairwise euclidean distances with isolation filters (parity:
    svg/utils.py:210)."""
    from scipy.spatial.distance import cdist

    coords = np.asarray(adata.obsm[layer], dtype=float)
    D = cdist(coords, coords)
    pos = np.where(D > 0, D, np.inf)
    keep = np.min(pos, axis=1) <= min_dis_cutoff
    b = adata[keep, :]
    D = D[np.ix_(keep, keep)]
    keep2 = np.max(D, axis=1) <= max_dis_cutoff
    b = b[keep2, :]
    b.obsp["distance"] = D[np.ix_(keep2, keep2)]
    return b


def scale_to(adata: AnnData, to_median: bool = True, N: int = 10000) -> AnnData:
    """Scale X rows to a common total (parity: svg/utils.py:247)."""
    adata = adata.copy()
    X = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X)
    X = X.astype(np.float64)
    totals = X.sum(axis=1)
    if to_median:
        N = np.median(totals)
    with np.errstate(invalid="ignore", divide="ignore"):
        X = (X.T / (totals / N)).T
    X[~np.isfinite(X)] = 0
    adata.X = X
    return adata


# ---------------------------------------------------------------------------
# OT distances
# ---------------------------------------------------------------------------
def _sinkhorn_batch_run(A: torch.Tensor, b: torch.Tensor, M: torch.Tensor, eps: float, n_iter: int = 200,
                        reduce_err=None):
    """`_sinkhorn_batch_kernel`'s loop: the distances and the sweeps run.
    `reduce_err` maps the block's ``max|g_new - g|`` over A's rows to the
    stop test's (the max over every rank's rows when A is one rank's)."""
    logA = torch.log(A + 1e-300)
    logb = torch.log(b + 1e-300)
    Mk = -M / eps  # [N, N]

    def sweep(f, g):
        f = eps * (logA - torch.logsumexp(Mk[None] + g[:, None, :] / eps, dim=2))
        g = eps * (logb[None] - torch.logsumexp(Mk[None] + f[:, :, None] / eps, dim=1))
        return f, g

    f, g = torch.zeros_like(A), torch.zeros_like(A)
    it = 0
    err = torch.full((), float("inf"), dtype=A.dtype, device=A.device)
    while it < n_iter and bool(err > 1e-6):
        _sinkhorn_batch_run.host_reads += 1
        f_new, g_new = f, g
        for _ in range(10):
            f_new, g_new = sweep(f_new, g_new)
        # one max over the whole padded chunk; NaN propagates, as jnp.max
        err = torch.amax(torch.abs(g_new - g))
        if reduce_err is not None:
            err = reduce_err(err)
        f, g = f_new, g_new
        it += 10
    T = torch.exp(Mk[None] + f[:, :, None] / eps + g[:, None, :] / eps)
    return torch.sum(T * M[None], dim=(1, 2)), it


_sinkhorn_batch_run.host_reads = 0


def _sinkhorn_batch_kernel(A: torch.Tensor, b: torch.Tensor, M: torch.Tensor, eps: float, n_iter: int = 200):
    """OT distances of a batch of source histograms A [G, N] to one target b
    [N] under one cost M [N, N], on the device of the inputs: log-domain
    Sinkhorn sweeps in blocks of 10, stopping when the block's
    ``max|g_new - g|`` over the whole batch is <= 1e-6 (or NaN)."""
    return _sinkhorn_batch_run(A, b, M, eps, n_iter)[0]


def scan_chunk(N: int, G: int, chunk: Optional[int] = None) -> int:
    """Rows of each `_sinkhorn_batch_kernel` call of a G-gene scan over N
    cells: [chunk, N, N] under ~0.5 GB, rounded up to a multiple of 8. The
    chunk's composition sets when its genes stop, so this is the JAX
    package's formula, unchanged."""
    if chunk is None:
        chunk = max(8, min(G, int(0.5e9 / (N * N * 4))))
    return ((min(chunk, G) + 7) // 8) * 8


def _scan_args(M, A, b, eps):
    """The scan's M and A in float32, its target b (uniform when empty) and
    its eps (0.5% of the largest cost, at least 1e-6 when None)."""
    M = np.asarray(M, dtype=np.float32)
    A = np.asarray(A, dtype=np.float32)
    if b is None or len(b) == 0:
        b = np.ones(M.shape[0], np.float32) / M.shape[0]
    b = np.asarray(b, np.float32)
    if eps is None:
        eps = float(max(M.max() * 5e-3, 1e-6))
    return M, A, b, eps


def cal_wass_dis_batch(
    M: np.ndarray,
    A: np.ndarray,
    b: Optional[np.ndarray] = None,
    eps: Optional[float] = None,
    n_iter: int = 200,
    chunk: Optional[int] = None,
    device="cuda",
) -> np.ndarray:
    """Wasserstein distances of many histograms to one target (batched
    Sinkhorn on `device`); the last chunk is padded with rows of 1/N."""
    M, A, b, eps = _scan_args(M, A, b, eps)
    N, G = M.shape[0], A.shape[0]
    chunk = scan_chunk(N, G, chunk)
    M_d, b_d = _to_device(M, device), _to_device(b, device)
    out = np.zeros(G, np.float32)
    for s in range(0, G, chunk):
        block = A[s : s + chunk]
        pad = chunk - block.shape[0]
        if pad:
            block = np.concatenate([block, np.full((pad, N), 1.0 / N, np.float32)])
        res = _sinkhorn_batch_kernel(_to_device(block, device), b_d, M_d, eps, n_iter)
        out[s : s + chunk - pad] = res.cpu().numpy()[: chunk - pad]
    return out


def cal_wass_dis_batch_sharded(M, A, b=None, eps=None, n_iter: int = 200, mesh=None) -> np.ndarray:
    """The gene scan over the ranks of `mesh` (`parallel.create_mesh()` when
    None): A's [G, N] rows, padded with rows of 1/N to a multiple of every
    rank of the mesh, split over its first axis; M and b on every rank. Each
    rank sweeps its rows as one batch, and every block's stop test is the
    max over all padded rows, NaN included (a stack of each rank's max,
    reduced by `torch.amax`), as the JAX package's one program over the
    whole batch tests it. Every rank returns all G distances; one rank is
    `cal_wass_dis_batch`."""
    from ..parallel import create_mesh
    from ..parallel._collectives import RowShard, mesh_device

    mesh = mesh if mesh is not None else create_mesh()
    n_dev = int(mesh.size())
    if n_dev <= 1:
        return cal_wass_dis_batch(M, A, b=b, eps=eps, n_iter=n_iter, device=mesh_device(mesh))
    M, A, b, eps = _scan_args(M, A, b, eps)
    N, G = M.shape[0], A.shape[0]
    Gp = -(-G // n_dev) * n_dev
    if Gp > G:
        A = np.concatenate([A, np.full((Gp - G, N), 1.0 / N, np.float32)])
    shard = RowShard(mesh, Gp)
    dev = shard.device
    res, _ = _sinkhorn_batch_run(_to_device(shard.take(A), dev), _to_device(b, dev), _to_device(M, dev), eps, n_iter,
                                 reduce_err=lambda e: torch.amax(shard.stack(e)))
    return shard.gather_rows(res).cpu().numpy()[:G]


def cal_wass_dis(M, a, b=[], numItermax: int = 1000000, eps: Optional[float] = None, n_iter: int = 200,
                 device="cuda") -> float:
    """Single OT distance (parity signature: svg/utils.py:279; entropic)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b) if len(b) else None
    return float(cal_wass_dis_batch(M, a[None, :], b=b, eps=eps, n_iter=n_iter, device=device)[0])


def cal_wass_dis_exact(M: np.ndarray, a, b=[]) -> float:
    """EXACT earth-mover's distance via linear programming (scipy HiGHS,
    `ops.ot.emd_exact`), on the host: the validation path for the Sinkhorn
    scores, for small problems (N up to a few hundred bins). Empty ``a`` or
    ``b`` is uniform."""
    from ..ops.ot import emd_exact

    M = np.asarray(M, float)
    n, m = M.shape
    a = np.asarray(a, float).ravel() if len(np.atleast_1d(a)) else np.full(n, 1.0 / n)
    b = np.asarray(b, float).ravel() if len(np.atleast_1d(b)) else np.full(m, 1.0 / m)
    return float((emd_exact(a, b, M) * M).sum())


def cal_rank_p(genes, ws, w_df: pd.DataFrame, bin_num: int = 100):
    """Ranking p-values by expression-magnitude bins (parity: svg/utils.py:297)."""
    ws_dict = {}
    for g, w in zip(genes, ws):
        ws_dict.setdefault(g, []).append(w)
    sorted_genes = w_df["mean"].sort_values().index.to_list()
    each_bin_gene_num = int(len(sorted_genes) / bin_num) + 1
    each_bin_ws = {}
    bin_of_gene = {}
    for i in range(bin_num):
        each_bin_ws[i] = []
        for g in sorted_genes[i * each_bin_gene_num : (i + 1) * each_bin_gene_num]:
            if np.sum(np.array(ws_dict[g])) > 0:
                each_bin_ws[i].append(ws_dict[g])
            bin_of_gene[g] = i
        each_bin_ws[i] = np.array(each_bin_ws[i])
    rank_p = []
    for g in w_df.index:
        t = each_bin_ws[bin_of_gene[g]].flatten()
        rank_p.append((np.sum(t >= w_df.loc[g, "Wasserstein_distance"]) + 1) / max(len(t), 1))
    return rank_p, each_bin_ws


# ---------------------------------------------------------------------------
# statistics helpers (loess, BH and Holm-Sidak corrections)
# ---------------------------------------------------------------------------
def loess_1d(x: np.ndarray, y: np.ndarray, frac: float = 0.5, degree: int = 1):
    """Tricube-weighted local polynomial regression (the `loess` package's
    role in the reference, get_svg.py:100), equal to the JAX package's
    `loess_1d` bit for bit."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    n = len(x)
    k = max(int(np.ceil(frac * n)), degree + 2)
    yout = np.zeros(n)
    order = np.argsort(x)
    xs, ys_ = x[order], y[order]
    for i, xi in enumerate(x):
        d = np.abs(xs - xi)
        idx = np.argsort(d)[:k]
        dmax = d[idx].max() or 1.0
        w = (1 - (d[idx] / dmax) ** 3) ** 3
        X = np.vander(xs[idx] - xi, degree + 1)
        try:
            # w[:, None] * X is diag(w) @ X entry for entry (each sum has one
            # nonzero term) without the [k, k] matrix
            beta = np.linalg.lstsq(w[:, None] * X, w * ys_[idx], rcond=None)[0]
            yout[i] = beta[-1]
        except np.linalg.LinAlgError:
            yout[i] = np.average(ys_[idx], weights=w)
    return x, yout, None


def multipletests_bh(pvals: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg adjusted p-values."""
    pvals = np.asarray(pvals, float)
    n = len(pvals)
    order = np.argsort(pvals)
    ranked = pvals[order] * n / (np.arange(n) + 1)
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n)
    out[order] = np.clip(ranked, 0, 1)
    return out


def multipletests_hs(pvals: np.ndarray) -> np.ndarray:
    """Holm-Sidak adjusted p-values (statsmodels' ``multipletests`` default,
    which the reference calls). Step-down: sort ascending,
    raw_i = 1-(1-p_(i))^(n-i), cumulative max."""
    pvals = np.asarray(pvals, float)
    n = len(pvals)
    order = np.argsort(pvals)
    raw = 1.0 - np.power(1.0 - pvals[order], np.arange(n, 0, -1))
    adj = np.maximum.accumulate(raw)
    out = np.empty(n)
    out[order] = np.clip(adj, 0, 1)
    return out


def loess_reg(x, y: np.ndarray = None, frac: float = 0.5):
    """Reference-named front end (reference svg/utils.py:322-333). With an
    AnnData, the row-total rescaling ``scale_to(adata, to_median=True)``;
    with (x, y) arrays, the loess-smoothed y on the sorted x grid."""
    if y is None or hasattr(x, "n_obs"):
        return scale_to(x, to_median=True)
    order = np.argsort(np.asarray(x, float))
    xs, ys, _ = loess_1d(np.asarray(x, float)[order], np.asarray(y, float)[order], frac=frac)
    return xs, ys
