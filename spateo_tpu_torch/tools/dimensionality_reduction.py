"""PCA by randomized SVD with implicit centering (counterpart of
`randomized_pca_centered`, `truncated_SVD_with_center` and `pca` in
`spateo_tpu.tools.dimensionality_reduction`; reference
spateo/tools/dimensionality_reduction.py:521,672).

The sketch products, the QR factorizations and the small SVD run in float64
on `device`; a sparse X goes up as a CSR tensor (and its transpose as
another) and is never densified. ``Omega`` is drawn on the host from
``np.random.default_rng(random_state)`` exactly as the JAX package draws it.
`pca_fit` fits `PCA`, scikit-learn 1.9's exact PCA ported (the GPU machine
has no scikit-learn), and `find_optimal_pca_components` takes its elbow from
`randomized_pca_centered`. UMAP and t-SNE are not ported yet (ROADMAP Queue 1
item 11).
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


class PCA:
    """``sklearn.decomposition.PCA(n_components, svd_solver)`` of
    scikit-learn 1.9 for dense X, ported for the solvers its exact path
    takes: ``"covariance_eigh"`` (the eigendecomposition of X^T X less
    n mean mean^T, over n - 1; what ``"auto"`` picks when d <= 1,000 and
    n >= 10 d) and ``"full"`` (the SVD of the centred X; ``"auto"``'s pick
    when max(n, d) <= 500, or when n_components >= 0.8 min(n, d)). The
    randomized and ARPACK solvers, and a float or ``"mle"`` n_components,
    raise. Runs in float64 on `device`, with `svd_flip`'s signs (each
    component's largest-magnitude entry positive). `fit` sets the host
    arrays `mean_`, `components_`, `explained_variance_`,
    `explained_variance_ratio_`, `singular_values_`, `noise_variance_`,
    `n_components_` and `n_samples_`."""

    def __init__(self, n_components: Optional[int] = None, svd_solver: str = "auto", device="cuda"):
        self.n_components = n_components
        self.svd_solver = svd_solver
        self.device = device

    def _solver(self, n: int, d: int, k: int) -> str:
        solver = self.svd_solver
        if solver == "auto":
            if d <= 1_000 and n >= 10 * d:
                solver = "covariance_eigh"
            elif max(n, d) <= 500 or not 1 <= k < 0.8 * min(n, d):
                solver = "full"
            else:
                solver = "randomized"
        if solver not in ("full", "covariance_eigh"):
            raise NotImplementedError(
                f"PCA(svd_solver={self.svd_solver!r}) at {n} x {d} with {k} components takes scikit-learn's "
                f"{solver!r} solver, which is not ported; pass svd_solver='full' or 'covariance_eigh'."
            )
        return solver

    def fit(self, X) -> "PCA":
        X = np.asarray(X, dtype=np.float64)
        n, d = X.shape
        k = min(n, d) if self.n_components is None else self.n_components
        if not isinstance(k, (int, np.integer)):
            raise NotImplementedError(f"PCA(n_components={k!r}): only a whole number of components is ported.")
        if not 0 <= k <= min(n, d):
            raise ValueError(f"n_components={k} must be between 0 and min(n_samples, n_features)={min(n, d)}")
        solver = self._solver(n, d, k)
        Xd = torch.as_tensor(X, device=self.device)
        mean = Xd.mean(0)
        if solver == "full":
            _, S, Vt = torch.linalg.svd(Xd - mean, full_matrices=False)
            explained_variance = S**2 / (n - 1)
        else:
            C = Xd.T @ Xd
            C -= n * mean[:, None] * mean[None, :]
            C /= n - 1
            evals, evecs = torch.linalg.eigh(C)
            evals = torch.clamp_min(evals.flip(0), 0.0)
            explained_variance = evals
            S = torch.sqrt(evals * (n - 1))
            Vt = evecs.flip(1).T
        rows = torch.arange(Vt.shape[0], device=Vt.device)
        Vt = Vt * torch.sign(Vt[rows, torch.argmax(Vt.abs(), dim=1)])[:, None]
        ratio = explained_variance / explained_variance.sum()
        self.noise_variance_ = float(explained_variance[k:].mean()) if k < min(n, d) else 0.0
        self.n_samples_, self.n_components_ = n, k
        self.mean_ = mean.cpu().numpy()
        self.components_ = Vt[:k].cpu().numpy()
        self.explained_variance_ = explained_variance[:k].cpu().numpy()
        self.explained_variance_ratio_ = ratio[:k].cpu().numpy()
        self.singular_values_ = S[:k].cpu().numpy()
        self._components_d, self._mean_d = Vt[:k].contiguous(), mean
        return self

    def transform(self, X) -> np.ndarray:
        """The projection ``X C^T - mean C^T`` (scikit-learn's order), host."""
        Xd = torch.as_tensor(np.asarray(X, dtype=np.float64), device=self._mean_d.device)
        Ct = self._components_d.T
        return (Xd @ Ct - (self._mean_d[None, :] @ Ct)).cpu().numpy()


def pca_fit(X, pca_func=None, n_components: int = 30, device="cuda", **kwargs):
    """Fit `pca_func` (default `PCA` on `device`) with at most d - 1
    components and project X (parity: reference
    dimensionality_reduction.py:645). Returns (fit, X_pca)."""
    n_components = min(n_components, X.shape[1] - 1)
    fit = (pca_func(n_components=n_components, **kwargs) if pca_func is not None
           else PCA(n_components=n_components, device=device, **kwargs)).fit(X)
    return fit, fit.transform(X)


def find_optimal_pca_components(X, method: str = "elbow", max_components: Optional[int] = None, device="cuda",
                                **kwargs) -> int:
    """Elbow of the explained-variance curve of `randomized_pca_centered`
    on `device` (parity: dimensionality_reduction.py:757)."""
    max_components = 50 if max_components is None else max_components
    _, _, expl = randomized_pca_centered(X, min(max_components, X.shape[1] - 1), device=device)
    ratios = expl / expl.sum()
    cum = np.cumsum(ratios)
    d = np.diff(cum)
    knee = int(np.argmax(d < (d[0] * 0.05))) + 1 if (d < d[0] * 0.05).any() else len(cum)
    return max(knee, 2)


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
