"""Clustering utilities (capability parity: reference
spateo/tools/cluster/utils.py; counterpart of
`spateo_tpu.tools.cluster.utils`).

The PCA helpers run the port's randomized PCA on `device`; `spatial_adj`
takes its two kNN graphs from `find_neighbors.neighbors` on `device`;
`ecp_silhouette` is scikit-learn's `silhouette_score` (euclidean) on
`device`, in float64, over row chunks of the pairwise distances.
`pearson_residuals` and `integrate` are the JAX package's host code.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch
from scipy.sparse import issparse

from ...configuration import SKM
from ...core.anndata import AnnData
from ...core.bridge import _to_device
from ...logging import logger_manager as lm

#: Entries of one [rows, n] block of distances `ecp_silhouette` holds.
SILHOUETTE_ELEMS = 1 << 25


def to_dense_matrix(X) -> np.ndarray:
    return X.toarray() if issparse(X) else np.asarray(X)


def compute_pca_components(
    matrix, random_state: Optional[int] = 1, save_curve_img: Optional[str] = None, device="cuda"
) -> Tuple[Any, int, float]:
    """PCA on `device` + knee of the explained-variance curve (parity:
    cluster/utils.py:18)."""
    from ..dimensionality_reduction import randomized_pca_centered

    matrix = to_dense_matrix(matrix)
    matrix[np.isnan(matrix)] = 0
    n_max = min(matrix.shape[0] - 1, matrix.shape[1] - 1, 100)
    pcs, comps, expl = randomized_pca_centered(matrix, n_max, random_state=random_state or 0, device=device)
    ratio = expl / expl.sum()
    x = np.arange(1, len(ratio) + 1, dtype=float)
    xn = (x - x.min()) / max(x.max() - x.min(), 1e-30)
    yn = (ratio - ratio.min()) / max(ratio.max() - ratio.min(), 1e-30)
    knee = int(x[np.argmax((1 - yn) - xn)])
    new_n_components = max(knee, 2)
    return pcs, new_n_components, round(float(ratio[:new_n_components].sum()), 3)


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def pca_spateo(
    adata: AnnData,
    X_data: Optional[np.ndarray] = None,
    n_pca_components: Optional[int] = None,
    pca_key: Optional[str] = "X_pca",
    genes: Optional[list] = None,
    layer: Optional[str] = None,
    random_state: Optional[int] = 1,
    device="cuda",
):
    """PCA on `device` with automatic component count (parity:
    cluster/utils.py:60)."""
    from ..dimensionality_reduction import randomized_pca_centered

    if X_data is None:
        if genes is not None:
            genes = adata.var_names.intersection(genes).to_list()
            if len(genes) == 0:
                raise ValueError("no genes from your genes list appear in your adata object.")
        else:
            genes = list(adata.var_names)
        matrix = adata[:, np.asarray(genes)].layers[layer] if layer is not None else adata[:, np.asarray(genes)].X
    else:
        matrix = X_data
    if n_pca_components is None:
        pcs, n_pca_components, _ = compute_pca_components(matrix, random_state=random_state, device=device)
    else:
        pcs, _, _ = randomized_pca_centered(matrix, n_pca_components, random_state=random_state or 0, device=device)
    adata.obsm[pca_key] = np.asarray(pcs)[:, :n_pca_components]
    return adata


def pearson_residuals(
    adata: AnnData,
    n_top_genes: Optional[int] = 3000,
    subset: bool = False,
    theta: float = 100,
    clip: Optional[float] = None,
    check_values: bool = True,
):
    """Analytic Pearson residuals (parity: cluster/utils.py:121; Lause et al.
    2021), host numpy as in the JAX package."""
    X = to_dense_matrix(adata.X).astype(float)
    if check_values and not np.allclose(X, np.round(X)):
        lm.main_warning("`pearson_residuals` expects raw count data; non-integer values found.")
    if n_top_genes is not None and n_top_genes < adata.n_vars:
        tot = X.sum()
        pe = X.sum(0) / tot
        n = X.sum(1)
        mu = n[:, None] * pe[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            res = (X - mu) / np.sqrt(mu + mu**2 / theta)
        res[~np.isfinite(res)] = 0
        var = res.var(axis=0)
        top = np.argsort(-var)[:n_top_genes]
        hv = np.zeros(adata.n_vars, bool)
        hv[top] = True
        adata.var["highly_variable"] = hv
        if subset:
            adata._inplace_subset_var(hv)
            X = X[:, top]
    tot = X.sum()
    pe = X.sum(0) / tot
    n = X.sum(1)
    mu = n[:, None] * pe[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        residuals = (X - mu) / np.sqrt(mu + mu**2 / theta)
    residuals[~np.isfinite(residuals)] = 0
    clip_val = np.sqrt(X.shape[0]) if clip is None else clip
    residuals = np.clip(residuals, -clip_val, clip_val)
    adata.obsm["pearson_residuals"] = residuals


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE, "adatas")
def integrate(adatas: List[AnnData], batch_key: str = "slices", fill_value: Union[int, float] = 0) -> AnnData:
    """Concatenate slices with batch labels (parity: cluster/utils.py:171)."""
    from ...core.anndata import concat

    for i, a in enumerate(adatas):
        a.obs[batch_key] = str(i)
    out = concat(adatas, join="outer")
    out.uns[SKM.ADATA_TYPE_KEY] = SKM.ADATA_UMI_TYPE
    return out


def ecp_silhouette(matrix, cluster_labels: np.ndarray, device="cuda") -> float:
    """Mean silhouette coefficient (parity: cluster/utils.py:243):
    scikit-learn's `silhouette_score` with the euclidean metric, on `device`
    in float64. Distances are scikit-learn's matmul form (|x|^2 + |y|^2 - 2
    x.y, clipped at 0, a point's own distance 0), summed per cluster by
    `index_add_` in row chunks of `SILHOUETTE_ELEMS`; a cluster of one point
    scores 0."""
    X = _to_device(np.asarray(to_dense_matrix(matrix), dtype=np.float64), device)
    codes, labels = np.unique(np.asarray(cluster_labels), return_inverse=True)
    n = X.shape[0]
    if not 1 < len(codes) < n:
        raise ValueError(f"Number of labels is {len(codes)}. Valid values are 2 to n_samples - 1 (inclusive)")
    lab = _to_device(labels.astype(np.int64), device)
    freqs = torch.bincount(lab, minlength=len(codes)).to(torch.float64)
    sq = (X * X).sum(1)
    intra = torch.empty(n, dtype=torch.float64, device=X.device)
    inter = torch.empty(n, dtype=torch.float64, device=X.device)
    rows = max(1, SILHOUETTE_ELEMS // n)
    for s in range(0, n, rows):
        e = min(s + rows, n)
        D = torch.sqrt(torch.clamp(sq[s:e, None] - 2 * (X[s:e] @ X.T) + sq[None, :], min=0.0))
        r = torch.arange(e - s, device=X.device)
        D[r, r + s] = 0.0
        sums = torch.zeros((e - s, len(codes)), dtype=torch.float64, device=X.device)
        sums.index_add_(1, lab, D)
        own = lab[s:e]
        intra[s:e] = sums[r, own]
        sums = sums / freqs
        sums[r, own] = torch.inf
        inter[s:e] = sums.min(1).values
    intra = intra / (freqs - 1)[lab]
    sil = torch.nan_to_num((inter - intra) / torch.maximum(intra, inter))
    return float(sil.mean())


def spatial_adj(
    adata: AnnData,
    spatial_key: str = "spatial",
    pca_key: str = "pca",
    e_neigh: int = 30,
    s_neigh: int = 6,
    n_pca_components: int = 30,
    device="cuda",
):
    """Union of expression-KNN and spatial-KNN adjacency (parity:
    cluster/utils.py:277), both graphs from `neighbors` on `device`."""
    from ..find_neighbors import neighbors

    _, adata = neighbors(adata, n_neighbors=e_neigh, basis=pca_key, n_pca_components=n_pca_components, device=device)
    _, adata = neighbors(
        adata, n_neighbors=s_neigh, basis="spatial", spatial_key=spatial_key, n_pca_components=n_pca_components,
        device=device,
    )
    conn = adata.obsp["expression_connectivities"].copy()
    conn.data[conn.data > 0] = 1
    adj = conn + adata.obsp["spatial_connectivities"]
    adj.data[adj.data > 0] = 1
    return adj
