"""Point-cloud downsampling methods (counterpart of
`spateo_tpu.alignment.methods.sampling`; reference
spateo/alignment/methods/sampling.py:17-303: random / kmeans / TRN / LHS).
Host numpy, copied from the JAX package with its `default_rng` streams, but
for the k-means, which is `ops.kmeans.MiniBatchKMeans` (scikit-learn's,
ported) on `device`. As in the JAX package, `sample(method="kmeans")` takes
`sample_by_kmeans`'s own seed (0), not `seed`."""

from __future__ import annotations

from typing import Optional

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


def sample(
    arr: np.ndarray,
    n: int,
    method: str = "random",
    X: Optional[np.ndarray] = None,
    V: Optional[np.ndarray] = None,
    seed: int = 19491001,
    device="cuda",
    **kwargs,
) -> np.ndarray:
    """The sampled rows of `arr` (parity: reference methods/sampling.py:17-59),
    by 'random', 'velocity' (weighted by the norms of `V`), 'trn', 'kmeans'
    or 'lhs', the last three on the auxiliary coordinates `X` when given.
    Only 'kmeans' uses `device`."""
    arr = np.asarray(arr)
    if method == "random":
        idx = random_sample(arr, n, seed)
    elif method == "velocity" and V is not None:
        idx = sample_by_velocity(V=V, n=n, seed=seed, **kwargs)
    elif method == "trn":
        idx = trn(X=arr if X is None else np.asarray(X), n=n, return_index=True, seed=seed, **kwargs)
    elif method == "kmeans":
        idx = sample_by_kmeans(arr if X is None else np.asarray(X), n, return_index=True, device=device)
    elif method in ("lhs", "LHS"):
        idx = lhs_sample(arr if X is None else np.asarray(X), n, seed)
    else:
        raise NotImplementedError(
            f"The sampling method {method} is not implemented or relevant data are not provided."
        )
    return arr[np.asarray(idx)]


def sample_by_kmeans(X: np.ndarray, n: int, return_index: bool = False, seed: int = 0, device="cuda") -> np.ndarray:
    """K-means sampling on `device` (parity: reference
    methods/sampling.py:243-260): indices with `return_index`, else the
    sampled points."""
    idx = kmeans_sample(np.asarray(X), n, seed, device)
    return idx if return_index else np.asarray(X)[idx]


def sample_by_velocity(V: np.ndarray, n: int, seed: int = 19491001, **kwargs) -> np.ndarray:
    """Indices drawn without replacement with probability proportional to
    the velocity's norm (parity: reference methods/sampling.py:225-240)."""
    rng = np.random.default_rng(seed)
    V = np.asarray(V)
    mag = np.linalg.norm(V, axis=1) + 1e-12
    p = mag / mag.sum()
    return rng.choice(len(V), min(n, len(V)), replace=False, p=p)


def trn(X: np.ndarray, n: int, return_index: bool = True, seed: int = 19491001, **kwargs) -> np.ndarray:
    """Topology-representing-network sampling (parity: reference
    methods/sampling.py:196-210): data indices with `return_index`, else
    the codebook positions of a trained `TRNET`."""
    if return_index:
        return trn_sample(np.asarray(X), n, seed, **kwargs)
    trnet = TRNET(n, np.asarray(X), seed)
    trnet.run()
    return trnet.W


def lhsclassic(n_samples: int, n_dim: int, bounds=None, seed: int = 19491001) -> np.ndarray:
    """Classic Latin hypercube sampling (parity: reference
    methods/sampling.py:263-301): one stratified draw an interval along every
    dimension, each dimension permuted on its own, mapped into `bounds` (an
    [n_dim, 2] low/high matrix; the unit box when None)."""
    rng = np.random.default_rng(seed)
    cut = np.linspace(0, 1, n_samples + 1)
    u = rng.random((n_samples, n_dim))
    a, b = cut[:n_samples], cut[1 : n_samples + 1]
    H = u * (b - a)[:, None] + a[:, None]
    for j in range(n_dim):
        H[:, j] = H[rng.permutation(n_samples), j]
    if bounds is not None:
        bounds = np.asarray(bounds, float)
        H = bounds[:, 0][None, :] + H * (bounds[:, 1] - bounds[:, 0])[None, :]
    return H


class TRNET:
    """Topology-representing network (parity: reference
    methods/sampling.py:62-160, the same training schedule)."""

    def __init__(self, n_nodes: int, X: np.ndarray, seed: int = 0):
        self.n_nodes = n_nodes
        self.X = np.asarray(X)
        self.seed = seed
        self.W: np.ndarray = None

    def draw_sample(self, n_samples: int) -> np.ndarray:
        """Codebook positions at random data points (parity: reference
        sampling.py:88-101)."""
        rng = np.random.default_rng(self.seed)
        idx = rng.integers(0, self.X.shape[0], n_samples)
        return self.X[idx].astype(float).copy()

    def runOnce(self, p: np.ndarray, l: float, ep: float, c: float = 0) -> None:
        """One presentation: rank the codebook vectors by distance to `p` and
        pull each toward it by ep exp(-rank / l) (parity: reference
        sampling.py:103-131; `c` > 0 keeps only the c nearest ranks)."""
        d = np.linalg.norm(self.W - np.asarray(p, float), axis=1)
        ranks = np.argsort(np.argsort(d)).astype(float)
        coef = np.exp(-ranks / max(l, 1e-12))
        if c > 0:
            coef = np.where(ranks < c, coef, 0.0)
        self.W += ep * coef[:, None] * (np.asarray(p, float) - self.W)

    def run(
        self, tmax: int = 200, li: float = 0.2, lf: float = 0.01, ei: float = 0.3, ef: float = 0.05, c: float = 0
    ) -> np.ndarray:
        """Train for `tmax` presentations, the learning rate from ei to ef
        and the neighbourhood from li to lf (reference sampling.py:133-160)."""
        self.run_n_pause(0, int(tmax), tmax=tmax, li=li, lf=lf, ei=ei, ef=ef, c=c)
        return self.W

    def run_n_pause(
        self,
        k0: int,
        k: int,
        tmax: float = 200,
        li: float = 0.2,
        lf: float = 0.01,
        ei: float = 0.3,
        ef: float = 0.05,
        c: float = 0,
    ) -> None:
        """Run presentations k0..k of the schedule, then stop (the
        reference's resumable form, sampling.py:157-194)."""
        rng = np.random.default_rng(self.seed + k0)
        X = self.X
        N = X.shape[0]
        n = min(self.n_nodes, N)
        if self.W is None:
            self.W = X[rng.choice(N, n, replace=False)].astype(float).copy()
        lam_i, lam_f = li * n, lf
        for t in range(int(k0), int(k)):
            frac = t / max(tmax, 1)
            lam = lam_i * (lam_f / lam_i) ** frac
            eps = ei * (ef / ei) ** frac
            self.runOnce(X[rng.integers(0, N)], lam, eps, c)
