"""Spatial DEGs via Moran's I (capability parity: reference
spateo/tools/spatial_degs.py:23), the `moran_i` test MuSIC's molecule
selection runs.

Counterpart of `spateo_tpu.tools.spatial_degs.moran_i`: every gene's
statistic and every permutation replicate come from dense products on the
device; the permutations are drawn on the host from
``np.random.default_rng(seed)`` in the JAX package's order, so both packages
permute alike. `cellbin_morani` (a rook-lattice Moran's I per cell type)
is the JAX package's host code, copied.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pandas as pd
import torch
from scipy.sparse import issparse

from ..core.anndata import AnnData
from ..core.bridge import _to_device
from ..logging import logger_manager as lm
from ..svg.utils import multipletests_bh

#: Entries of [permutations, n, genes] one chunk of replicates may hold.
PERM_CHUNK_ELEMS = 1 << 26


def _spatial_weights(coords: np.ndarray, k: int, weighted: bool = False) -> np.ndarray:
    """Row-standardized KNN spatial weights (binary or gaussian-kernel) over
    each cell's k + 1 nearest cells, itself included and then zeroed. The
    neighbours come from scipy's cKDTree; the JAX package takes them from
    scikit-learn's `NearestNeighbors`, which gives the same sets wherever no
    two cells tie at the k-th distance (scikit-learn is not a dependency of
    the port)."""
    from scipy.spatial import cKDTree

    n = len(coords)
    dist, idx = cKDTree(coords).query(coords, k=min(k + 1, n))
    dist, idx = dist.reshape(n, -1), idx.reshape(n, -1)
    if weighted:
        bw = dist[:, -1][:, None] + 1e-12
        w = np.exp(-0.5 * (dist / bw) ** 2)
    else:
        w = np.ones_like(dist)
    W = np.zeros((n, n))
    np.put_along_axis(W, idx, w, axis=1)
    np.fill_diagonal(W, 0)
    W = W / np.maximum(W.sum(axis=1, keepdims=True), 1e-12)
    return W


def _moran_replicates(Z: torch.Tensor, W: torch.Tensor, perm_idx: torch.Tensor):
    """Moran's I of all genes, [G], and of each permutation, [P, G], on the
    device of `Z`.

    Z: [n, G] centered expression; W: [n, n] row-standardized weights;
    perm_idx: [P, n] permutations, taken in chunks of at most
    `PERM_CHUNK_ELEMS` entries of [P, n, G] (the replicates are independent).
    """
    n, G = Z.shape
    S0 = torch.sum(W)
    denom = torch.sum(Z * Z, dim=0) + 1e-30
    WZ = W @ Z
    I_obs = (n / S0) * torch.sum(Z * WZ, dim=0) / denom

    step = max(1, PERM_CHUNK_ELEMS // max(n * G, 1))
    parts = []
    for s in range(0, perm_idx.shape[0], step):
        Zp = Z[perm_idx[s : s + step]]  # [P, n, G]
        parts.append((n / S0) * torch.sum(Zp * (W @ Zp), dim=1) / (torch.sum(Zp * Zp, dim=1) + 1e-30))
    return I_obs, torch.cat(parts)


def _moran_batch_kernel(Z: torch.Tensor, W: torch.Tensor, perm_idx: torch.Tensor, n_perm: int):
    """Moran's I for all genes with its permutation p-value and z-score
    (`_moran_replicates`' statistics)."""
    I_obs, I_perm = _moran_replicates(Z, W, perm_idx)
    p_sim = (torch.sum(I_perm >= I_obs[None, :], dim=0) + 1) / (n_perm + 1)
    z_sim = (I_obs - I_perm.mean(0)) / (I_perm.std(0, correction=0) + 1e-30)
    return I_obs, p_sim, z_sim


def moran_i(
    adata: AnnData,
    genes: Optional[List[str]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    model: str = "2d",
    x: Optional[List[int]] = None,
    y: Optional[List[int]] = None,
    z: Optional[List[int]] = None,
    k: int = 5,
    weighted: Optional[bool] = None,
    permutations: int = 199,
    n_jobs: int = 1,
    seed: int = 0,
    device="cuda",
) -> pd.DataFrame:
    """Moran's I spatial autocorrelation test for every gene, on `device`
    (parity: spatial_degs.py:23). Columns moran_i, moran_p_val, moran_z and
    the Benjamini-Hochberg moran_q_val, one row a gene."""
    sub = adata if genes is None else adata[:, np.asarray(genes)]
    X_sub = sub.X if layer is None else sub.layers[layer]
    X = X_sub.toarray() if issparse(X_sub) else np.asarray(X_sub, dtype=float)
    coords = np.asarray(adata.obsm[spatial_key], dtype=float)
    dims = 3 if model == "3d" else 2
    if x is not None:
        coords = np.c_[x, y] if dims == 2 else np.c_[x, y, z]
    coords = coords[:, :dims]

    W = _spatial_weights(coords, k, weighted=bool(weighted))
    Z = X - X.mean(axis=0, keepdims=True)
    rng = np.random.default_rng(seed)
    perm_idx = np.stack([rng.permutation(adata.n_obs) for _ in range(permutations)])
    I_obs, p_sim, z_sim = _moran_batch_kernel(
        _to_device(np.asarray(Z, np.float32), device),
        _to_device(np.asarray(W, np.float32), device),
        _to_device(perm_idx.astype(np.int64), device),
        permutations,
    )
    host = torch.stack([I_obs, p_sim.to(I_obs.dtype), z_sim]).cpu().numpy()
    res = pd.DataFrame(
        {"moran_i": host[0], "moran_p_val": host[1], "moran_z": host[2]},
        index=sub.var_names,
    )
    res["moran_q_val"] = multipletests_bh(res["moran_p_val"].values)
    return res


def _lattice_moran(raster: np.ndarray):
    """Moran's I on a 2D lattice with rook (lat2W) weights + its one-tailed
    normal-approximation p-value (the reference's esda `Moran(…, lat2W)`
    statistics, spatial_degs.py:150-168)."""
    from scipy.stats import norm as _norm

    x = np.asarray(raster, float)
    n = x.size
    z = x - x.mean()
    # rook adjacency: Σ w_ij z_i z_j = 2 * (horizontal + vertical products)
    num_pairs = (z[:, 1:] * z[:, :-1]).sum() + (z[1:, :] * z[:-1, :]).sum()
    E_edges = z[:, 1:].size + z[1:, :].size  # unordered edge count
    S0 = 2.0 * E_edges
    I = (n / S0) * (2.0 * num_pairs) / np.maximum((z**2).sum(), 1e-300)
    # normality-assumption variance (esda Moran.VI_norm)
    deg = np.full(x.shape, 4.0)
    deg[0, :] -= 1; deg[-1, :] -= 1; deg[:, 0] -= 1; deg[:, -1] -= 1
    S1 = 4.0 * E_edges
    S2 = float((4.0 * deg**2).sum())
    EI = -1.0 / (n - 1)
    VI = (n * n * S1 - n * S2 + 3 * S0 * S0) / ((n * n - 1) * S0 * S0) - EI * EI
    zscore = (I - EI) / np.sqrt(max(VI, 1e-300))
    p_norm = float(1.0 - _norm.cdf(abs(zscore)))
    return float(I), p_norm


def cellbin_morani(
    adata_cellbin: AnnData,
    binsize: int,
    cluster_key: str = "Celltype",
) -> pd.DataFrame:
    """Moran's I score per CELLTYPE from binned cell counts (parity:
    spatial_degs.py:125-174 — same raster construction: grid shape from
    ``obsm['X_spatial']`` extents, counts accumulated from
    ``obsm['spatial'] // binsize``; rook lattice weights; columns
    cluster/moran_i/moran_i_p_norm sorted by moran_i descending)."""
    lm.main_info("Calculating cell counts in each bin, using binsize " + str(binsize))
    shape_coords = np.asarray(
        adata_cellbin.obsm["X_spatial" if "X_spatial" in adata_cellbin.obsm else "spatial"], float
    )
    H = int(max(shape_coords[:, 0] // binsize)) + 1
    W = int(max(shape_coords[:, 1] // binsize)) + 1
    coords = np.asarray(adata_cellbin.obsm["spatial"], float) // binsize
    labels = np.asarray(adata_cellbin.obs[cluster_key])
    lm.main_info("Calculating Moran's I score for each celltype")
    mi, mi_norm, clusters = [], [], np.unique(labels)
    for c in clusters:
        raster = np.zeros((H, W))
        for j in coords[labels == c]:
            raster[int(j[0]), int(j[1])] += 1
        I, p = _lattice_moran(raster)
        mi.append(I)
        mi_norm.append(p)
    mi_df = pd.DataFrame({"cluster": clusters, "moran_i": mi, "moran_i_p_norm": mi_norm})
    return mi_df.sort_values(by="moran_i", ascending=False)
