"""PCA by randomized SVD with implicit centering (counterpart of
`randomized_pca_centered`, `truncated_SVD_with_center` and `pca` in
`spateo_tpu.tools.dimensionality_reduction`; reference
spateo/tools/dimensionality_reduction.py:521,672).

The sketch products, the QR factorizations and the small SVD run in float64
on `device`; a sparse X goes up as a CSR tensor (and its transpose as
another) and is never densified. ``Omega`` is drawn on the host from
``np.random.default_rng(random_state)`` exactly as the JAX package draws it.
UMAP, t-SNE and `pca_fit` are not ported yet (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch
from scipy.sparse import issparse

from ..core.anndata import AnnData


def _upload(X, device) -> torch.Tensor:
    """X as a float64 tensor on `device`: CSR stays sparse."""
    if issparse(X):
        X = X.tocsr()
        return torch.sparse_csr_tensor(
            torch.from_numpy(X.indptr.astype(np.int64)), torch.from_numpy(X.indices.astype(np.int64)),
            torch.from_numpy(np.asarray(X.data, np.float64)), size=X.shape, dtype=torch.float64,
        ).to(device)
    return torch.as_tensor(np.asarray(X, np.float64), device=device)


def randomized_pca_centered(
    X, n_components: int = 30, n_iter: int = 4, random_state: int = 0, device="cuda"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Randomized SVD of the (implicitly) column-centered X on `device`.

    Returns (X_pca [n, k], components [k, d], explained_variance [k]) on the
    host. Centering is applied inside the sketch products (X - 1 mean^T) @
    Omega = X @ Omega - 1 (mean^T Omega), so sparse X stays sparse.
    """
    rng = np.random.default_rng(random_state)
    n, d = X.shape
    k = min(n_components, d - 1, n - 1)
    p = min(k + 16, d)
    mean_h = np.asarray(X.mean(axis=0)).ravel()
    Omega = rng.normal(size=(d, p))

    Xd = _upload(X, device)
    XTd = _upload(X.T, device)
    mean = torch.as_tensor(mean_h, dtype=torch.float64, device=device)

    def center_mm(M):  # (X - 1 mean^T) @ M
        return Xd @ M - (mean @ M)[None, :]

    def center_rmm(M):  # (X - 1 mean^T)^T @ M
        return XTd @ M - mean[:, None] * M.sum(0)[None, :]

    def qr(M):
        return torch.linalg.qr(M, mode="reduced").Q

    Q = qr(center_mm(torch.as_tensor(Omega, device=device)))
    for _ in range(n_iter):
        Q = qr(center_mm(qr(center_rmm(Q))))
    B = center_rmm(Q).T  # [p, d]
    Ub, S, Vt = torch.linalg.svd(B, full_matrices=False)
    U = Q @ Ub
    X_pca = (U[:, :k] * S[:k]).cpu().numpy()
    components = Vt[:k].cpu().numpy()
    explained_variance = (S[:k] ** 2).cpu().numpy() / max(n - 1, 1)
    return X_pca, components, explained_variance


def truncated_SVD_with_center(X, n_components: int = 30, random_state=0, device="cuda"):
    """Centered truncated SVD without densifying sparse X (parity:
    dimensionality_reduction.py:672)."""
    X_pca, components, _ = randomized_pca_centered(X, n_components, random_state=random_state or 0, device=device)
    return None, X_pca


def pca(
    adata: AnnData,
    X_data: Optional[np.ndarray] = None,
    n_pca_components: int = 30,
    pca_key: str = "X_pca",
    pcs_key: str = "PCs",
    layer: Union[List[str], str, None] = None,
    svd_solver: str = "randomized",
    random_state: int = 0,
    use_truncated_SVD_threshold: int = 500000,
    use_incremental_PCA: bool = False,
    incremental_batch_size: Optional[int] = None,
    return_all: bool = False,
    device="cuda",
):
    """PCA into `.obsm[pca_key]` on `device` (parity:
    dimensionality_reduction.py:521)."""
    if X_data is None:
        if "use_for_pca" not in adata.var.columns:
            adata.var["use_for_pca"] = True
        use = np.asarray(adata.var["use_for_pca"].values, dtype=bool)
        if layer is None or layer == "X":
            X_data = adata.X[:, use]
        else:
            X_data = adata.layers[layer if layer in adata.layers else f"X_{layer}"][:, use]
        genesums = np.asarray(X_data.sum(axis=0)).ravel()
        valid = np.isfinite(genesums) & (genesums != 0)
        bad = np.where(use)[0][~valid]
        if bad.size:
            col = adata.var.columns.get_loc("use_for_pca")
            adata.var.iloc[bad, col] = False
        X_data = X_data[:, valid]

    X_pca, components, expl = randomized_pca_centered(X_data, n_pca_components, random_state=random_state,
                                                      device=device)
    adata.obsm[pca_key] = X_pca
    adata.uns[pcs_key] = components
    adata.uns["explained_variance_ratio_"] = expl / max(float(np.asarray(X_data.power(2).sum() if issparse(X_data) else (np.asarray(X_data) ** 2).sum())), 1e-30)
    if return_all:
        return adata, None, X_pca
    return adata
