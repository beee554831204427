"""Point-cloud downsampling methods (counterpart of
`spateo_tpu.alignment.methods.sampling`; reference
spateo/alignment/methods/sampling.py:17-303: random / kmeans / TRN / LHS).
Host numpy, copied from the JAX package, but for the k-means, which is
`ops.kmeans.MiniBatchKMeans` (scikit-learn's, ported) on `device`."""

from __future__ import annotations

import numpy as np


def random_sample(X: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(X.shape[0], size=min(n, X.shape[0]), replace=False)


def kmeans_sample(X: np.ndarray, n: int, seed: int = 0, device="cuda") -> np.ndarray:
    """Cluster into n k-means centers on `device`; pick the point closest to
    each center."""
    from scipy.spatial import cKDTree

    from ...ops.kmeans import MiniBatchKMeans

    km = MiniBatchKMeans(n_clusters=min(n, X.shape[0]), random_state=seed, n_init=3, device=device).fit(X)
    _, idx = cKDTree(X).query(km.cluster_centers_, k=1)
    return np.unique(idx)


def trn_sample(X: np.ndarray, n: int, seed: int = 0, n_epochs: int = 3) -> np.ndarray:
    """Topology-representing-network (SOM-style) sampling (parity: reference
    sampling.py:62): competitive learning of n codebook vectors, then the
    nearest data points."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    n = min(n, X.shape[0])
    W = X[rng.choice(X.shape[0], n, replace=False)].astype(float).copy()
    N = X.shape[0]
    lam_i, lam_f = 0.2 * n, 0.01
    eps_i, eps_f = 0.3, 0.05
    t_max = n_epochs * N
    t = 0
    order = rng.permutation(N)
    for epoch in range(n_epochs):
        for i in order:
            x = X[i]
            frac = t / t_max
            lam = lam_i * (lam_f / lam_i) ** frac
            eps = eps_i * (eps_f / eps_i) ** frac
            d = np.linalg.norm(W - x, axis=1)
            ranks = np.argsort(np.argsort(d))
            W += eps * np.exp(-ranks / lam)[:, None] * (x - W)
            t += 1
    _, idx = cKDTree(X).query(W, k=1)
    return np.unique(idx)


def lhs_sample(X: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """Latin-hypercube-stratified sampling in coordinate space."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    n = min(n, X.shape[0])
    D = X.shape[1]
    mins, maxs = X.min(0), X.max(0)
    samples = np.zeros((n, D))
    for d in range(D):
        edges = np.linspace(mins[d], maxs[d], n + 1)
        pts = edges[:-1] + rng.random(n) * np.diff(edges)
        samples[:, d] = rng.permutation(pts)
    _, idx = cKDTree(X).query(samples, k=1)
    return np.unique(idx)


def sample_indices(X: np.ndarray, n: int, method: str = "random", seed: int = 0, device="cuda") -> np.ndarray:
    """Downsampling by `method` ('random', 'kmeans', 'trn', 'lhs'),
    returning indices into X. Only 'kmeans' uses `device`."""
    X = np.asarray(X)
    if method == "random":
        return random_sample(X, n, seed)
    if method == "kmeans":
        return kmeans_sample(X, n, seed, device)
    if method == "trn":
        return trn_sample(X, n, seed)
    if method in ("lhs", "LHS"):
        return lhs_sample(X, n, seed)
    raise ValueError(f"Unknown sampling method {method}")
