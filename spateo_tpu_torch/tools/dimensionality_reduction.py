"""PCA by randomized SVD with implicit centering (counterpart of
`randomized_pca_centered`, `truncated_SVD_with_center` and `pca` in
`spateo_tpu.tools.dimensionality_reduction`; reference
spateo/tools/dimensionality_reduction.py:521,672).

The sketch products, the QR factorizations and the small SVD run in float64
on `device`; a sparse X goes up as a CSR tensor (and its transpose as
another) and is never densified. ``Omega`` is drawn on the host from
``np.random.default_rng(random_state)`` exactly as the JAX package draws it.
`pca_fit` fits `PCA`, scikit-learn 1.9's PCA with its four solvers ported
(the GPU machine has no scikit-learn), and `find_optimal_pca_components` takes its elbow from
`randomized_pca_centered`.

UMAP (`umap_conn_indices_dist_embedding`, `perform_dimensionality_reduction`)
is the JAX package's native one: the kNN (host cKDTree), the smooth-kNN
calibration, the fuzzy union, the a/b curve fit and the spectral `eigsh`
init stay on the host; the SGD layout runs on the device, each epoch's
gathers, clips and `index_add_`s with its negatives drawn from a
`torch.Generator`, with no host read inside the epochs. t-SNE is
scikit-learn's Barnes-Hut `TSNE`, which the JAX package calls, ported to the
device in `_tsne`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch
from scipy.sparse import issparse

from ..core.anndata import AnnData
from ..core.bridge import _to_device
from .find_neighbors import knn


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


def _check_random_state(seed) -> np.random.RandomState:
    """scikit-learn's `check_random_state`: None -> numpy's global
    `RandomState`, an int -> a new one, a `RandomState` -> itself."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, (int, np.integer)):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a numpy.random.RandomState instance")


def _svd_flip_rows(Vt: torch.Tensor) -> torch.Tensor:
    """scikit-learn's ``svd_flip(u_based_decision=False)`` on Vt alone: each
    row signed so that its largest-magnitude entry is positive."""
    rows = torch.arange(Vt.shape[0], device=Vt.device)
    return Vt * torch.sign(Vt[rows, torch.argmax(Vt.abs(), dim=1)])[:, None]


def _randomized_svd(M: torch.Tensor, n_components: int, n_oversamples: int, n_iter, power_iteration_normalizer: str,
                    random_state: np.random.RandomState):
    """scikit-learn 1.9's ``_randomized_svd(M, ..., transpose="auto",
    flip_sign=False)`` (`sklearn/utils/extmath.py`) on M's device: the
    Gaussian sketch from `random_state` on the host, `n_iter` power
    iterations normalised by LU (P applied to L, scipy's ``permute_l=True``),
    QR or nothing, an economic QR, the small SVD. Returns (U, s, Vt)."""
    n_random = n_components + n_oversamples
    n_samples, n_features = M.shape
    if n_iter == "auto":
        n_iter = 7 if n_components < 0.1 * min(M.shape) else 4
    transpose = n_samples < n_features
    if transpose:
        M = M.T
    Q = torch.as_tensor(random_state.normal(size=(M.shape[1], n_random)), dtype=M.dtype, device=M.device)
    if power_iteration_normalizer == "auto":
        power_iteration_normalizer = "none" if n_iter <= 2 else "LU"

    def qr(A):
        return torch.linalg.qr(A, mode="reduced").Q

    def lu(A):
        P, L, _ = torch.linalg.lu(A)
        return P @ L

    normalizer = {"QR": qr, "LU": lu, "none": lambda A: A}[power_iteration_normalizer]
    for _ in range(n_iter):
        Q = normalizer(M @ Q)
        Q = normalizer(M.T @ Q)
    Q = qr(M @ Q)
    Uhat, s, Vt = torch.linalg.svd(Q.T @ M, full_matrices=False)
    U = Q @ Uhat
    if transpose:
        return Vt[:n_components].T, s[:n_components], U[:, :n_components].T
    return U[:, :n_components], s[:n_components], Vt[:n_components]


class PCA:
    """``sklearn.decomposition.PCA`` of scikit-learn 1.9 for dense X, ported
    (the GPU machine has no scikit-learn), with its four solvers and its
    ``"auto"`` choice among them: ``"covariance_eigh"`` (the
    eigendecomposition of X^T X less n mean mean^T, over n - 1; picked when
    d <= 1,000 and n >= 10 d), ``"full"`` (the SVD of the centred X; picked
    when max(n, d) <= 500, or when n_components >= 0.8 min(n, d)),
    ``"randomized"`` (`_randomized_svd`, picked otherwise) and ``"arpack"``
    (scipy's `svds` on the host, its start vector uniform(-1, 1) from
    `random_state`, as scikit-learn's `_init_arpack_v0` draws it). A
    fraction 0 < n_components < 1 keeps, on the full and covariance_eigh
    solvers, the fewest components whose cumulative explained-variance
    ratio exceeds it (the other two raise, as in scikit-learn);
    ``"mle"`` raises. Runs in float64 on `device`, with
    `svd_flip`'s signs (each component's largest-magnitude entry positive).
    `fit` sets the host arrays `mean_`, `components_`,
    `explained_variance_`, `explained_variance_ratio_`, `singular_values_`,
    `noise_variance_`, `n_components_` and `n_samples_`."""

    def __init__(self, n_components: Optional[int] = None, svd_solver: str = "auto", tol: float = 0.0,
                 iterated_power="auto", n_oversamples: int = 10, power_iteration_normalizer: str = "auto",
                 random_state=None, device="cuda"):
        self.n_components = n_components
        self.svd_solver = svd_solver
        self.tol = tol
        self.iterated_power = iterated_power
        self.n_oversamples = n_oversamples
        self.power_iteration_normalizer = power_iteration_normalizer
        self.random_state = random_state
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
        if solver not in ("full", "covariance_eigh", "randomized", "arpack"):
            raise ValueError(f"PCA(svd_solver={self.svd_solver!r}): unknown solver")
        return solver

    def fit(self, X) -> "PCA":
        X = np.asarray(X, dtype=np.float64)
        n, d = X.shape
        if self.n_components is None:
            k = min(n, d) - 1 if self.svd_solver == "arpack" else min(n, d)
        else:
            k = self.n_components
        if isinstance(k, (float, np.floating)):
            if not 0 < k < 1:
                raise ValueError(f"PCA(n_components={k!r}): a float n_components must lie in (0, 1)")
        elif not isinstance(k, (int, np.integer)):
            raise NotImplementedError(f"PCA(n_components={k!r}): only a whole number of components or a "
                                      f"fraction in (0, 1) is ported.")
        solver = self._solver(n, d, k)
        if solver in ("full", "covariance_eigh"):
            if not 0 <= k <= min(n, d):
                raise ValueError(f"n_components={k} must be between 0 and min(n_samples, n_features)={min(n, d)}")
        elif not 1 <= k <= min(n, d) - (solver == "arpack"):
            raise ValueError(f"n_components={k} must be between 1 and min(n_samples, n_features)={min(n, d)} "
                             f"(strictly below it with svd_solver='arpack')")
        Xd = torch.as_tensor(X, device=self.device)
        mean = Xd.mean(0)
        if solver in ("randomized", "arpack"):
            self._fit_truncated(X, Xd - mean, k, solver)
        else:
            k = self._fit_full(Xd, mean, k, solver)
        self.n_samples_, self.n_components_ = n, k
        self.mean_ = mean.cpu().numpy()
        self._mean_d = mean
        return self

    def _fit_full(self, Xd: torch.Tensor, mean: torch.Tensor, k, solver: str) -> int:
        """The full or covariance_eigh fit (`_pca.py:544-694`); returns the
        number of components kept."""
        n, d = Xd.shape
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
        Vt = _svd_flip_rows(Vt)
        ratio = explained_variance / explained_variance.sum()
        if not isinstance(k, (int, np.integer)):
            # side="right", as scikit-learn: the kept ratios sum to more than
            # the fraction; only the count leaves the device.
            fraction = torch.tensor(k, dtype=torch.float64, device=ratio.device)
            k = int(torch.searchsorted(torch.cumsum(ratio, 0), fraction, right=True)) + 1
        self.noise_variance_ = float(explained_variance[k:].mean()) if k < min(n, d) else 0.0
        self.components_ = Vt[:k].cpu().numpy()
        self.explained_variance_ = explained_variance[:k].cpu().numpy()
        self.explained_variance_ratio_ = ratio[:k].cpu().numpy()
        self.singular_values_ = S[:k].cpu().numpy()
        self._components_d = Vt[:k].contiguous()
        return k

    def _fit_truncated(self, X: np.ndarray, Xc: torch.Tensor, k: int, solver: str) -> None:
        """scikit-learn's `_fit_truncated` for dense X (`_pca.py:697-790`)."""
        n, d = X.shape
        random_state = _check_random_state(self.random_state)
        if solver == "arpack":
            from scipy.sparse.linalg import svds

            v0 = random_state.uniform(-1, 1, min(X.shape))
            _, S, Vt = svds(X - X.mean(axis=0), k=k, tol=self.tol, v0=v0)
            S = torch.as_tensor(S[::-1].copy(), device=Xc.device)
            Vt = torch.as_tensor(Vt[::-1].copy(), device=Xc.device)
        else:
            _, S, Vt = _randomized_svd(Xc, k, self.n_oversamples, self.iterated_power,
                                       self.power_iteration_normalizer, random_state)
        Vt = _svd_flip_rows(Vt)
        explained_variance = S**2 / (n - 1)
        total_var = torch.sum(Xc**2) / (n - 1)
        self.components_ = Vt.cpu().numpy()
        self.explained_variance_ = explained_variance.cpu().numpy()
        self.explained_variance_ratio_ = (explained_variance / total_var).cpu().numpy()
        self.singular_values_ = S.cpu().numpy()
        self.noise_variance_ = (float((total_var - explained_variance.sum()) / (min(n, d) - k))
                                if k < min(n, d) else 0.0)
        self._components_d = Vt.contiguous()

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


def perform_dimensionality_reduction(
    adata: AnnData,
    basis: str = "pca",
    n_pca_components: int = 30,
    n_components: int = 2,
    n_neighbors: int = 30,
    reduction_method: str = "umap",
    embedding_key: Optional[str] = None,
    enforce: bool = False,
    cores: int = 1,
    copy: bool = False,
    device="cuda",
    **kwargs,
):
    """UMAP or t-SNE embedding on top of PCA (parity:
    dimensionality_reduction.py:37) on `device`: the native UMAP with its
    layout on the device (`umap-learn` is not a dependency), or scikit-learn's
    Barnes-Hut ``TSNE(n_components, random_state=0)`` ported (`_tsne.TSNE`)."""
    if copy:
        adata = adata.copy()
    if reduction_method not in ("umap", "tsne", "t-sne"):
        raise ValueError(f"Unknown reduction_method {reduction_method}")
    if "X_pca" not in adata.obsm or enforce:
        pca(adata, n_pca_components=n_pca_components, device=device)
    X = np.asarray(adata.obsm["X_pca"])[:, :n_pca_components]
    embedding_key = embedding_key or f"X_{reduction_method}"
    if reduction_method == "umap":
        _, _, _, emb = umap_conn_indices_dist_embedding(
            X, n_neighbors=n_neighbors, n_components=n_components, return_mapper=False, device=device, **kwargs
        )
    else:
        from ._tsne import TSNE

        emb = TSNE(n_components=n_components, device=device).fit_transform(X)
    adata.obsm[embedding_key] = emb
    if copy:
        return adata


def _smooth_knn(dists: np.ndarray, k: int, n_iter: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """UMAP's per-point bandwidth calibration (host): find sigma_i so that
    sum_j exp(-(d_ij - rho_i)/sigma_i) = log2(k)."""
    rho = dists[:, 0].copy()
    target = np.log2(k)
    lo = np.zeros(len(dists))
    hi = np.full(len(dists), np.inf)
    sigma = np.ones(len(dists))
    for _ in range(n_iter):
        val = np.exp(-np.maximum(dists - rho[:, None], 0) / sigma[:, None]).sum(1)
        too_high = val > target
        hi = np.where(too_high, sigma, hi)
        lo = np.where(too_high, lo, sigma)
        sigma = np.where(np.isinf(hi), sigma * 2, (lo + hi) / 2)
    return sigma, rho


def umap_layout(init: torch.Tensor, heads: torch.Tensor, tails: torch.Tensor, weights: torch.Tensor, a: float,
                b: float, n_epochs: int, alpha: float = 1.0, negatives=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """UMAP's SGD layout on the device of `init` (float32), the JAX
    package's epoch: attract each edge's ends (gradient clipped to +-4,
    scaled by its weight; heads then tails by `index_add_`), then repel each
    head from one random point, at the rate alpha (1 - i / n_epochs).

    Each epoch's negatives are row i of `negatives` ([n_epochs, E] ints)
    when given, else ``torch.randint`` from `generator` on the device. No
    host read happens in the loop; the caller reads the result."""
    emb = init.clone()
    n = emb.shape[0]
    f32 = np.float32
    a32, b32 = f32(a), f32(b)
    attract = float(f32(-2.0) * a32 * b32)
    repel = float(f32(2.0) * b32)
    bm1 = float(b32 - f32(1.0))
    a, b = float(a32), float(b32)
    if negatives is not None:
        negatives = torch.as_tensor(np.asarray(negatives), dtype=torch.int64).to(emb.device)
    for i in range(n_epochs):
        lr = float(f32(alpha) * (f32(1.0) - f32(i) / f32(n_epochs)))
        diff = emb[heads] - emb[tails]
        d2 = (diff * diff).sum(1) + 1e-9
        grad_coef = (attract * d2**bm1) / (1.0 + a * d2**b)
        ga = torch.clamp(grad_coef[:, None] * diff, -4, 4) * weights[:, None]
        emb.index_add_(0, heads, lr * ga)
        emb.index_add_(0, tails, -lr * ga)
        negs = negatives[i] if negatives is not None else torch.randint(
            0, n, heads.shape, generator=generator, device=emb.device)
        diff = emb[heads] - emb[negs]
        d2n = (diff * diff).sum(1) + 1e-9
        rep_coef = repel / ((0.001 + d2n) * (1.0 + a * d2n**b))
        gr = torch.clamp(rep_coef[:, None] * diff, -4, 4)
        emb.index_add_(0, heads, lr * gr)
    return emb


def umap_conn_indices_dist_embedding(
    X: np.ndarray,
    n_neighbors: int = 30,
    n_components: int = 2,
    min_dist: float = 0.1,
    spread: float = 1.0,
    max_iter: Optional[int] = None,
    alpha: float = 1.0,
    random_state: int = 0,
    return_mapper: bool = True,
    init: Optional[np.ndarray] = None,
    negatives: Optional[np.ndarray] = None,
    device="cuda",
    **kwargs,
):
    """UMAP graph + embedding (parity surface: reference
    dimensionality_reduction.py:258-345; the JAX package's native UMAP).

    The graph, a, b and the spectral init (`eigsh` of the normalised graph)
    are computed on the host as in the JAX package; the layout
    (`umap_layout`, 500 epochs up to 10,000 points, else 200) runs on
    `device` with its negatives from ``torch.Generator(device)`` seeded with
    `random_state`. `init` ([n, n_components]) replaces the spectral init
    and `negatives` ([epochs, edges]) the draws, so that a run can start
    from another's. A graph too small for `eigsh` (n <= n_components + 1)
    starts from ``default_rng(random_state)`` noise, as in the JAX package.

    With ``return_mapper=True`` returns ``(mapper, graph, knn_indices,
    knn_dists, embedding)``, the mapper a `_FittedUMAP`; otherwise
    ``(graph, knn_indices, knn_dists, embedding)``.
    """
    from scipy.optimize import curve_fit
    from scipy.sparse import coo_matrix
    from scipy.sparse.linalg import eigsh
    from scipy.spatial import cKDTree

    X = np.asarray(X, np.float32)
    n = X.shape[0]
    k = min(n_neighbors, n - 1)
    tree = cKDTree(X)
    # on every host core (the same neighbours as on one): at 30 dimensions
    # this query is the graph's largest host cost
    knn_dists, knn_indices = tree.query(X, k=k + 1, workers=-1)
    knn_dists, knn_indices = knn_dists[:, 1:], knn_indices[:, 1:]

    sigma, rho = _smooth_knn(knn_dists, k)
    w = np.exp(-np.maximum(knn_dists - rho[:, None], 0) / np.maximum(sigma[:, None], 1e-12))
    rows = np.repeat(np.arange(n), k)
    G = coo_matrix((w.ravel(), (rows, knn_indices.ravel())), shape=(n, n)).tocsr()
    graph = G + G.T - G.multiply(G.T)

    xs = np.linspace(0, spread * 3, 300)
    ys = np.where(xs < min_dist, 1.0, np.exp(-(xs - min_dist) / spread))
    (a_fit, b_fit), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2 * b)), xs, ys, p0=[1.0, 1.0], maxfev=5000)

    if init is None:
        if n > n_components + 1:
            deg = np.asarray(graph.sum(1)).ravel()
            Dinv = coo_matrix((1.0 / np.sqrt(np.maximum(deg, 1e-12)), (np.arange(n), np.arange(n))),
                              shape=(n, n)).tocsr()
            L = Dinv @ graph @ Dinv
            vals, vecs = eigsh(L, k=n_components + 1, which="LA")
            init = vecs[:, :-1][:, ::-1]
        else:
            init = np.random.default_rng(random_state).normal(scale=1e-2, size=(n, n_components))
        init = (init - init.mean(0)) / (init.std(0) + 1e-9) * 10.0

    coo = graph.tocoo()
    heads = _to_device(coo.row.astype(np.int64), device)
    tails = _to_device(coo.col.astype(np.int64), device)
    weights = _to_device(coo.data.astype(np.float32), device)
    n_epochs = max_iter or (500 if n <= 10000 else 200)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(random_state))
    emb_d = umap_layout(_to_device(np.asarray(init, np.float32), device), heads, tails, weights, float(a_fit),
                        float(b_fit), int(n_epochs), alpha=alpha, negatives=negatives, generator=gen)
    emb = emb_d.cpu().numpy()
    umap_conn_indices_dist_embedding.host_reads += 1
    if return_mapper:
        mapper = _FittedUMAP(X, emb, n_neighbors=min(5, k))
        return mapper, graph, knn_indices, knn_dists, emb
    return graph, knn_indices, knn_dists, emb


umap_conn_indices_dist_embedding.host_reads = 0


class _FittedUMAP:
    """Minimal fitted-UMAP stand-in: holds the training embedding and maps
    new points by barycentric interpolation of their nearest training
    neighbors (the role the reference's umap.UMAP object plays in
    adata.uns['umap_fit'], dimensionality_reduction.py:241-247); host code."""

    def __init__(self, X_train: np.ndarray, embedding_: np.ndarray, n_neighbors: int = 5):
        self.X_train_ = np.asarray(X_train, np.float32)
        self.embedding_ = np.asarray(embedding_)
        self.n_neighbors = n_neighbors

    def transform(self, X_new: np.ndarray) -> np.ndarray:
        from scipy.spatial import cKDTree

        d, idx = cKDTree(self.X_train_).query(np.asarray(X_new, np.float32), k=self.n_neighbors)
        w = 1.0 / np.maximum(d, 1e-12)
        w = w / w.sum(axis=1, keepdims=True)
        return np.einsum("nk,nkd->nd", w, self.embedding_[idx])


def knn_preservation(X: np.ndarray, emb: np.ndarray, k: int = 15, device="cuda") -> float:
    """Mean share of each point's k nearest neighbours in X that are among
    its k nearest in `emb`. X's neighbours come from `find_neighbors.knn` on
    `device` (ties by index), the embedding's from a host cKDTree."""
    from scipy.spatial import cKDTree

    X = np.asarray(X, np.float32)
    k = min(k, len(X) - 1)
    true_nbrs = knn(X, k + 1, device=device)[0][:, 1:]
    emb_nbrs = cKDTree(emb).query(emb, k=k + 1)[1][:, 1:]
    return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(true_nbrs, emb_nbrs)]))


def find_optimal_n_umap_components(X, max_components: int = 10, device="cuda", **kwargs) -> int:
    """Pick the UMAP dimensionality at the knee of 15-NN preservation
    (parity surface: reference find_optimal_n_umap_components)."""
    X = np.asarray(X, np.float32)
    scores = []
    dims = list(range(2, max_components + 1, 2))
    for d in dims:
        _, _, _, emb = umap_conn_indices_dist_embedding(X, n_components=d, max_iter=150, return_mapper=False,
                                                        device=device, **kwargs)
        scores.append(knn_preservation(X, emb, 15, device=device))
    gains = np.diff([0] + scores)
    best = int(np.argmax(gains < 0.01)) if (gains < 0.01).any() else len(dims) - 1
    return dims[best]
