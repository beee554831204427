"""Spatially-variable-gene identification via OT distances (counterpart of
`spateo_tpu.svg.get_svg`; reference spateo/svg/get_svg.py:28-520).

The per-gene Wasserstein scan is the batched Sinkhorn of
`cal_wass_dis_batch` on `device` (default ``"cuda"``); binning, the spatial
graphs, Floyd-Warshall, loess and the statistics are host numpy/scipy, as in
the JAX package.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import pandas as pd
from scipy.sparse import csr_matrix, issparse
from scipy.stats import norm

from ..core.anndata import AnnData
from .utils import (
    add_pos_ratio_to_adata,
    bin_adata,
    cal_euclidean_distance,
    cal_geodesic_distance,
    cal_rank_p,
    cal_wass_dis_batch,
    knn_indices,
    loess_1d,
    multipletests_hs,
    scale_to,
    shuffle_adata,
)


def get_std_wasserstein(l, n_neighbors: int = 30) -> np.ndarray:
    """Rolling standard deviation of sorted OT distances (parity:
    get_svg.py:111)."""
    l = np.asarray(l, dtype=float)
    std = l.copy()
    left = int(n_neighbors / 2)
    right = n_neighbors - left
    n = len(l)
    for i in range(0, min(left, n)):
        std[i] = np.std(l[0 : n_neighbors + 2])
    for i in range(left, max(n - right + 1, left)):
        std[i] = np.std(l[max(i - left, 0) : i + right + 2])
    for i in range(max(n - right, 0), n):
        std[i] = np.std(l[max(n - n_neighbors - 1, 0) : n])
    return std


def bin_scale_adata_get_distance(
    adata: AnnData,
    bin_size: int = 1,
    bin_layer: str = "spatial",
    distance_layer: str = "spatial",
    cell_distance_method: str = "geodesic",
    min_dis_cutoff: float = 2.0,
    max_dis_cutoff: float = 6.0,
    n_neighbors: int = 30,
) -> Tuple[AnnData, np.ndarray]:
    """Bin + scale + compute the ground cost matrix (parity: get_svg.py:426)."""
    b = bin_adata(adata, bin_size, layer=bin_layer)
    b = b[:, np.asarray(b.X.sum(axis=0)).ravel() > 0]
    b = scale_to(b)
    if cell_distance_method == "geodesic":
        b = cal_geodesic_distance(
            b, min_dis_cutoff=min_dis_cutoff, max_dis_cutoff=max_dis_cutoff, layer=distance_layer, n_neighbors=n_neighbors
        )
    elif cell_distance_method == "euclidean":
        b = cal_euclidean_distance(b, min_dis_cutoff=min_dis_cutoff, max_dis_cutoff=max_dis_cutoff, layer=distance_layer)
    M = np.asarray(b.obsp["distance"])
    if np.sum(~np.isfinite(M)) > 0:
        raise ValueError("distance has inf values — the spatial graph is disconnected; relax the cutoffs.")
    return b, M


def cal_wass_dis_for_genes(inp0, inp1, device="cuda") -> Tuple[List, np.ndarray, np.ndarray]:
    """OT distances for a gene list (parity signature: get_svg.py:209),
    batched on `device`."""
    M, adata = inp0
    seed, gene_ids, b, numItermax = inp1
    adata = shuffle_adata(adata, seed)
    X = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X)
    gene_ids = list(gene_ids)
    cols = [adata.var_names.get_loc(g) for g in gene_ids]
    A = X[:, cols].T.astype(np.float64)  # [G, N]
    sums = A.sum(axis=1, keepdims=True)
    pos_rs = (A > 0).sum(axis=1) / A.shape[1]
    A = np.where(sums > 0, A / np.maximum(sums, 1e-300), 1.0 / A.shape[1])
    ws = cal_wass_dis_batch(M, A, b=np.asarray(b) if len(b) else None, device=device)
    return gene_ids, np.asarray(ws), pos_rs


def cal_wass_dis_nobs(
    adata: AnnData,
    bin_size: int = 1,
    bin_layer: str = "spatial",
    cell_distance_method: str = "geodesic",
    distance_layer: str = "spatial",
    n_neighbors: int = 30,
    numItermax: int = 1000000,
    gene_set=None,
    target=[],
    min_dis_cutoff: float = 2.0,
    max_dis_cutoff: float = 6.0,
    device="cuda",
) -> pd.DataFrame:
    """OT distance of every gene to the target distribution, no bootstrap
    (parity: get_svg.py:365)."""
    b_adata, M = bin_scale_adata_get_distance(
        adata, bin_size, bin_layer, distance_layer, cell_distance_method, min_dis_cutoff, max_dis_cutoff, n_neighbors
    )
    if gene_set is None:
        gene_set = b_adata.var_names
    if isinstance(target, str):
        col = b_adata[:, target].X
        bvec = np.asarray(col.toarray() if issparse(col) else col, dtype=np.float64).ravel()
        bvec = bvec / bvec.sum()
    else:
        bvec = np.asarray(target)
    genes, ws, pos_rs = cal_wass_dis_for_genes((M, b_adata), (0, gene_set, bvec, numItermax), device)
    return pd.DataFrame({"Wasserstein_distance": ws, "positive_ratio": pos_rs}, index=genes)


def svg_iden_reg(
    adata: AnnData,
    bin_layer: str = "spatial",
    cell_distance_method: str = "geodesic",
    distance_layer: str = "spatial",
    n_neighbors: int = 8,
    numItermax: int = 1000000,
    gene_set=None,
    target=[],
    min_dis_cutoff: float = 500,
    max_dis_cutoff: float = 1000,
    n_neighbors_for_std: int = 30,
    device="cuda",
) -> pd.DataFrame:
    """Identify SVGs against a spatial-uniform reference (parity:
    get_svg.py:28): OT distance per gene -> loess baseline by positive rate ->
    z-score / BH-adjusted p-values."""
    add_pos_ratio_to_adata(adata)
    w0 = cal_wass_dis_nobs(
        adata,
        bin_size=1,
        bin_layer=bin_layer,
        cell_distance_method=cell_distance_method,
        distance_layer=distance_layer,
        n_neighbors=n_neighbors,
        numItermax=numItermax,
        gene_set=gene_set,
        target=target,
        min_dis_cutoff=min_dis_cutoff,
        max_dis_cutoff=max_dis_cutoff,
        device=device,
    )
    w0["raw_pos_rate"] = np.asarray(adata.var.loc[w0.index, "raw_pos_rate"])
    w0 = w0.sort_values(by="raw_pos_rate")
    _, yout, _ = loess_1d(w0["raw_pos_rate"].values, w0["Wasserstein_distance"].values)
    w0["expectation_reg"] = yout
    w0["std"] = get_std_wasserstein(w0["Wasserstein_distance"].values, n_neighbors=n_neighbors_for_std)
    _, std_yout, _ = loess_1d(w0["raw_pos_rate"].values, w0["std"].values)
    w0["std_reg"] = np.maximum(std_yout, 1e-12)
    w0["zscore"] = (w0["Wasserstein_distance"] - w0["expectation_reg"]) / w0["std_reg"]
    w0["pvalue"] = norm.sf(w0["zscore"])
    w0["adj_pvalue"] = multipletests_hs(w0["pvalue"].values)
    return w0


def cal_wass_dist_bs(
    adata: AnnData,
    bin_size: int = 1,
    bin_layer: str = "spatial",
    cell_distance_method: str = "geodesic",
    distance_layer: str = "spatial",
    n_neighbors: int = 30,
    numItermax: int = 1000000,
    gene_set=None,
    target=[],
    processes: int = 1,
    bootstrap: int = 100,
    min_dis_cutoff: float = 2.0,
    max_dis_cutoff: float = 6.0,
    rank_p: bool = True,
    bin_num: int = 100,
    larger_or_small: str = "larger",
    device="cuda",
) -> Tuple[pd.DataFrame, AnnData]:
    """Bootstrap permutation p-values for per-gene OT distances (parity:
    get_svg.py:245). Each bootstrap round is one batched scan on `device`."""
    b_adata, M = bin_scale_adata_get_distance(
        adata, bin_size, bin_layer, distance_layer, cell_distance_method, min_dis_cutoff, max_dis_cutoff, n_neighbors
    )
    if gene_set is None:
        gene_set = list(b_adata.var_names)
    if isinstance(target, str):
        col = b_adata[:, target].X
        bvec = np.asarray(col.toarray() if issparse(col) else col, dtype=np.float64).ravel()
        bvec = bvec / bvec.sum()
    else:
        bvec = np.asarray(target)

    genes0, ws0, pos_rs = cal_wass_dis_for_genes((M, b_adata), (0, gene_set, bvec, numItermax), device)
    boot_genes, boot_ws = [], []
    for seed in range(1, bootstrap + 1):
        g, w, _ = cal_wass_dis_for_genes((M, b_adata), (seed, gene_set, bvec, numItermax), device)
        boot_genes += list(g)
        boot_ws += list(w)

    w_df = pd.DataFrame({"Wasserstein_distance": ws0, "positive_ratio": pos_rs}, index=genes0)
    boot = pd.DataFrame({"gene": boot_genes, "w": boot_ws})
    stats = boot.groupby("gene")["w"].agg(["mean", "std"])
    w_df["mean"] = stats["mean"].reindex(w_df.index).values
    w_df["std"] = stats["std"].reindex(w_df.index).values
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (w_df["Wasserstein_distance"] - w_df["mean"]) / w_df["std"]
    w_df["zscore"] = z
    if larger_or_small == "larger":
        w_df["pvalue"] = norm.sf(z)
    elif larger_or_small == "small":
        w_df["pvalue"] = norm.cdf(z)
    else:
        w_df["pvalue"] = 2 * norm.sf(np.abs(z))
    w_df["adj_pvalue"] = multipletests_hs(np.nan_to_num(w_df["pvalue"].values, nan=1.0))
    if rank_p:
        rp, _ = cal_rank_p(boot_genes, boot_ws, w_df, bin_num=bin_num)
        w_df["rank_p"] = rp
        w_df["adj_rank_p"] = multipletests_hs(w_df["rank_p"].values)
    return w_df, b_adata


def cal_wass_dis_target_on_genes(
    adata: AnnData,
    bin_size: int = 1,
    bin_layer: str = "spatial",
    cell_distance_method: str = "geodesic",
    distance_layer: str = "spatial",
    n_neighbors: int = 30,
    numItermax: int = 1000000,
    target_genes=None,
    gene_set=None,
    processes: int = 1,
    bootstrap: int = 0,
    min_dis_cutoff: float = 2.0,
    max_dis_cutoff: float = 6.0,
    device="cuda",
) -> Tuple[dict, AnnData]:
    """OT distance of every gene to each target gene's expression pattern
    (parity: get_svg.py:476)."""
    results = {}
    b_adata = None
    for tg in target_genes or []:
        w_df, b_adata = cal_wass_dist_bs(
            adata,
            bin_size=bin_size,
            bin_layer=bin_layer,
            cell_distance_method=cell_distance_method,
            distance_layer=distance_layer,
            n_neighbors=n_neighbors,
            numItermax=numItermax,
            gene_set=gene_set,
            target=tg,
            bootstrap=bootstrap,
            min_dis_cutoff=min_dis_cutoff,
            max_dis_cutoff=max_dis_cutoff,
            rank_p=False,
            device=device,
        )
        results[tg] = w_df
    return results, b_adata


def smoothing_and_sampling(
    adata: AnnData,
    smoothing: bool = True,
    downsampling: int = 400,
    device="cuda",
) -> Tuple[AnnData, AnnData]:
    """Optionally smooth expression and downsample cells (parity:
    get_svg.py:137). Host work; `device` is kept for the signature, as in the
    JAX package."""
    adata_smoothed = smooth(adata) if smoothing else adata.copy()
    from ..alignment.methods.sampling import sample_indices

    n = min(downsampling, adata_smoothed.n_obs)
    idx = sample_indices(np.asarray(adata_smoothed.obsm["spatial"]), n, method="random")
    return adata_smoothed[idx, :], adata_smoothed


def smooth(adata: AnnData, n_neighbors: int = 8) -> AnnData:
    """Spatial-KNN expression smoothing (parity: get_svg.py:170): each cell's
    X becomes the sum over its `n_neighbors` nearest cells (itself included,
    chosen by `knn_indices`' rule: distance, then index) over
    `n_neighbors`. Host scipy."""
    adata = adata.copy()
    n = adata.n_obs
    idx, _ = knn_indices(np.asarray(adata.obsm["spatial"], dtype=float), n_neighbors)
    k = idx.shape[1]
    graph = csr_matrix((np.ones(n * k), idx.ravel(), np.arange(0, n * k + 1, k)), shape=(n, n))
    X = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X)
    adata.X = np.asarray(graph @ X) / n_neighbors
    return adata


smoothing = smooth


def downsampling(adata: AnnData, downsampling: int = 400) -> AnnData:
    """Random spatial downsample (parity: get_svg.py:190)."""
    from ..alignment.methods.sampling import sample_indices

    idx = sample_indices(np.asarray(adata.obsm["spatial"]), min(downsampling, adata.n_obs), method="random")
    return adata[idx, :]
