"""k-means on torch tensors: scikit-learn 1.9's ``KMeans`` (Lloyd) and
``MiniBatchKMeans``, step for step.

The JAX package asks scikit-learn for both (`MuSIC(spatial_subsample=True)`,
`sampling.kmeans_sample`); the GPU machine has none, so the algorithms are
ported step for step, as `segmentation/density.py::_ward_tree` and
`alignment/methods/paste.py::KLNMF` were:

- every draw comes from one ``np.random.RandomState`` on the host, in
  scikit-learn's order, so the seeds, the k-means++ candidates, the
  mini-batches and the reassigned centres are the same;
- the distances, assignments, centre sums and k-means++ potentials run on
  `device`, in float64 (float32 input stays float32, as scikit-learn keeps
  it, with the k-means++ distances computed in float64 and rounded);
- the assignment distance is scikit-learn's ``||c||^2 - 2 x.c`` (one
  ``addmm``); the first minimum wins.

What scikit-learn decides on data that its host loop reads (the stop tests,
empty-cluster relocation, the mini-batch reassignment and its
``np.argsort`` of the counts) reads the same numbers here once a Lloyd
iteration or mini-batch step. On the CPU the centre sums run in sample
order (``index_add_``), as scikit-learn's do; on a card they are atomics,
so the centres differ from the CPU's in the last bits.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

#: Rows of the [rows, k] distance block an assignment pass computes at once.
ASSIGN_ELEMS = 1 << 24
#: scikit-learn's defaults, the only values the port's callers use:
#: `KMeans(max_iter=300, tol=1e-4)` and `MiniBatchKMeans(max_iter=100,
#: batch_size=1024, max_no_improvement=10, reassignment_ratio=0.01,
#: init_size=None)`.
LLOYD_MAX_ITER, LLOYD_TOL = 300, 1e-4
MB_MAX_ITER, MB_BATCH, MB_NO_IMPROVEMENT, MB_REASSIGN = 100, 1024, 10, 0.01


def _as_float(X) -> np.ndarray:
    X = np.asarray(X)
    return np.ascontiguousarray(X, dtype=np.float32 if X.dtype == np.float32 else np.float64)


def check_random_state(seed) -> np.random.RandomState:
    """scikit-learn's `check_random_state` but for None: a ``RandomState``
    as it is, else a new one seeded by `seed`."""
    return seed if isinstance(seed, np.random.RandomState) else np.random.RandomState(seed)


def _row_norms(X: torch.Tensor) -> torch.Tensor:
    return (X * X).sum(1)


def _assign(X: torch.Tensor, centers: torch.Tensor, sample_weight: Optional[torch.Tensor] = None):
    """Labels (first nearest centre) and, with weights, the inertia:
    scikit-learn's ``lloyd_iter_chunked_dense(update_centers=False)`` and
    ``_inertia_dense``."""
    c_sq = _row_norms(centers)
    rows = max(1, ASSIGN_ELEMS // max(centers.shape[0], 1))
    labels = torch.cat([
        torch.addmm(c_sq.expand(len(Xc), -1), Xc, centers.T, beta=1, alpha=-2).argmin(1)
        for Xc in X.split(rows)
    ]) if len(X) else torch.zeros(0, dtype=torch.long, device=X.device)
    if sample_weight is None:
        return labels, None
    d = X - centers[labels]
    return labels, ((d * d).sum(1) * sample_weight).sum()


def _sq_euclidean(A: torch.Tensor, B: torch.Tensor, B_sq: torch.Tensor) -> torch.Tensor:
    """``sklearn.metrics.pairwise._euclidean_distances(A, B, Y_norm_squared=
    B_sq, squared=True)``: ``-2 A B^T + |A|^2 + |B|^2``, clipped at 0. Float32
    input is computed in float64 and rounded, as its upcast path does."""
    dt = A.dtype
    if dt == torch.float32:
        A, B = A.double(), B.double()
        B_sq = _row_norms(B)
    d = (A @ B.T) * -2.0 + _row_norms(A)[:, None] + B_sq[None, :]
    return d.clamp_min(0).to(dt)


def kmeans_plusplus(X: torch.Tensor, n_clusters: int, x_squared_norms: torch.Tensor, sample_weight: torch.Tensor,
                    random_state: np.random.RandomState, n_local_trials: Optional[int] = None):
    """``sklearn.cluster._kmeans._kmeans_plusplus``: greedy k-means++ with
    ``2 + int(log k)`` local trials. The draws need no data, so the loop
    runs on the device with no host read. Returns (centers, indices)."""
    n_samples = X.shape[0]
    if n_local_trials is None:
        n_local_trials = 2 + int(np.log(n_clusters))
    w_host = sample_weight.cpu().numpy()
    center_id = random_state.choice(n_samples, p=w_host / w_host.sum())
    idx = torch.empty(n_clusters, dtype=torch.long, device=X.device)
    idx[0] = int(center_id)
    closest = _sq_euclidean(X[center_id:center_id + 1], X, x_squared_norms)[0]
    current_pot = closest @ sample_weight
    for c in range(1, n_clusters):
        rand_vals = torch.from_numpy(random_state.uniform(size=n_local_trials)).to(X.device) * current_pot.double()
        cumsum = torch.cumsum(sample_weight * closest, 0).double()
        cands = torch.searchsorted(cumsum, rand_vals).clamp_max_(n_samples - 1)
        dist = torch.minimum(closest, _sq_euclidean(X[cands], X, x_squared_norms))
        pots = dist @ sample_weight
        best = torch.argmin(pots)
        current_pot = pots[best]
        closest = dist[best]
        idx[c] = cands[best]
    return X[idx], idx


def _is_same_clustering(labels1: np.ndarray, labels2: np.ndarray, n_clusters: int) -> bool:
    mapping = np.full(n_clusters, -1, dtype=np.int64)
    for a, b in zip(labels1, labels2):
        if mapping[a] == -1:
            mapping[a] = b
        elif mapping[a] != b:
            return False
    return True


def _relocate_empty_clusters(X, sample_weight, centers_old, centers_new, weight, labels):
    """``_relocate_empty_clusters_dense`` on the host: each empty cluster takes
    the point farthest from its centre, in ``np.argpartition``'s order."""
    weight_h = weight.cpu().numpy()
    empty = np.where(weight_h == 0)[0]
    Xh, labels_h = X.cpu().numpy(), labels.cpu().numpy()
    distances = ((Xh - centers_old.cpu().numpy()[labels_h]) ** 2).sum(axis=1)
    if distances.max() == 0:
        return centers_new, weight
    far = np.argpartition(distances, -len(empty))[: -len(empty) - 1: -1]
    new_h, w_h = centers_new.cpu().numpy().copy(), weight_h.copy()
    sw = sample_weight.cpu().numpy()
    for new_id, far_idx in zip(empty, far):
        old_id = labels_h[far_idx]
        new_h[old_id] -= Xh[far_idx] * sw[far_idx]
        new_h[new_id] = Xh[far_idx] * sw[far_idx]
        w_h[new_id] = sw[far_idx]
        w_h[old_id] -= sw[far_idx]
    return torch.from_numpy(new_h).to(X.device), torch.from_numpy(w_h).to(X.device)


def _average_centers(sums: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``_average_centers``: scale by ``1 / w``; an empty centre (none is left
    after relocation unless every point sits on its centre) copies the
    heaviest, scaled or not as scikit-learn's in-place loop leaves it."""
    k = weight.shape[0]
    out = sums * torch.where(weight > 0, 1.0 / weight, torch.ones_like(weight))[:, None]
    a = torch.argmax(weight)
    j = torch.arange(k, device=weight.device)
    fill = torch.where((j < a)[:, None], sums[a].expand_as(sums), out[a].expand_as(sums))
    return torch.where((weight > 0)[:, None], out, fill)


def _lloyd(X: torch.Tensor, sample_weight: torch.Tensor, centers: torch.Tensor, max_iter: int, tol: float):
    """``_kmeans_single_lloyd``: one host read an iteration (the strict and
    centre-shift stops, the empty-cluster count). Returns (labels, inertia,
    centers, n_iter)."""
    k, d = centers.shape
    labels_old = torch.full((X.shape[0],), -1, dtype=torch.long, device=X.device)
    strict = False
    weighted = X * sample_weight[:, None]
    for i in range(max_iter):
        labels, _ = _assign(X, centers)
        weight = torch.zeros(k, dtype=X.dtype, device=X.device).index_add_(0, labels, sample_weight)
        sums = torch.zeros(k, d, dtype=X.dtype, device=X.device).index_add_(0, labels, weighted)
        new = _average_centers(sums, weight)
        shift = torch.sqrt(((new - centers) ** 2).sum(1))
        n_empty, same, shift_tot = torch.stack([
            (weight == 0).sum().to(X.dtype), (labels == labels_old).all().to(X.dtype), (shift * shift).sum(),
        ]).tolist()
        if n_empty:
            sums, weight = _relocate_empty_clusters(X, sample_weight, centers, sums, weight, labels)
            new = _average_centers(sums, weight)
            shift = torch.sqrt(((new - centers) ** 2).sum(1))
            shift_tot = float((shift * shift).sum())
        centers = new
        if same:
            strict = True
            break
        if shift_tot <= tol:
            break
        labels_old = labels
    if not strict:
        labels, _ = _assign(X, centers)
    d2 = X - centers[labels]
    inertia = float(((d2 * d2).sum(1) * sample_weight).sum())
    return labels, inertia, centers, i + 1


class KMeans:
    """``sklearn.cluster.KMeans(n_clusters, init="k-means++", n_init,
    random_state)`` (Lloyd, `max_iter` 300, `tol` 1e-4) on `device`.
    `random_state` is an int or None (a new ``RandomState``) or a
    ``RandomState``, whose draws then continue where its owner left them
    (`ops.gmm.GaussianMixture` shares one across its inits, as scikit-learn's
    does). `fit` sets ``cluster_centers_``, ``labels_``,
    ``inertia_`` and ``n_iter_`` (host numpy); `predict` assigns new points to
    the centres."""

    def __init__(self, n_clusters: int = 8, n_init: Union[int, str] = "auto",
                 random_state: Union[int, np.random.RandomState, None] = None, device="cuda"):
        self.n_clusters = n_clusters
        self.n_init = n_init
        self.random_state = random_state
        self.device = device

    def fit(self, X) -> "KMeans":
        X = _as_float(X)
        if X.shape[0] < self.n_clusters:
            raise ValueError(f"n_samples={X.shape[0]} should be >= n_clusters={self.n_clusters}.")
        n_init = 1 if self.n_init == "auto" else int(self.n_init)
        rs = check_random_state(self.random_state)
        tol = float(np.mean(np.var(X, axis=0)) * LLOYD_TOL)
        X_mean = X.mean(axis=0)
        Xd = torch.from_numpy(X - X_mean).to(self.device)
        swd = torch.ones(X.shape[0], dtype=Xd.dtype, device=self.device)
        x_sq = _row_norms(Xd)
        best = None
        for _ in range(n_init):
            init, _ = kmeans_plusplus(Xd, self.n_clusters, x_sq, swd, rs)
            labels, inertia, centers, n_iter = _lloyd(Xd, swd, init, LLOYD_MAX_ITER, tol)
            labels = labels.cpu().numpy()
            if best is None or (inertia < best[1] and not _is_same_clustering(labels, best[0], self.n_clusters)):
                best = (labels, inertia, centers, n_iter)
        self.labels_ = best[0].astype(np.int32)
        self.inertia_ = best[1]
        self.cluster_centers_ = best[2].cpu().numpy() + X_mean
        self.n_iter_ = best[3]
        return self

    def predict(self, X) -> np.ndarray:
        X = torch.from_numpy(_as_float(X)).to(self.device)
        centers = torch.from_numpy(self.cluster_centers_).to(self.device, X.dtype)
        labels, _ = _assign(X, centers)
        return labels.cpu().numpy().astype(np.int32)


class MiniBatchKMeans:
    """``sklearn.cluster.MiniBatchKMeans(n_clusters, init="k-means++",
    n_init, random_state)`` (`max_iter` 100, `batch_size` 1024,
    `max_no_improvement` 10, `reassignment_ratio` 0.01, `tol` 0) on `device`,
    with an int `random_state`. One host read a mini-batch step (the batch
    inertia for the EWA stop, and whether a count is 0), one more where a
    reassignment runs (`host_reads`)."""

    def __init__(self, n_clusters: int = 8, n_init: Union[int, str] = "auto", random_state: Optional[int] = None,
                 device="cuda"):
        self.n_clusters = n_clusters
        self.n_init = n_init
        self.random_state = random_state
        self.device = device

    def _reassign(self, counts_d, centers_new, Xb, rs):
        """The random reassignment of `_mini_batch_step` on the host counts."""
        counts = counts_d.cpu().numpy()
        to_reassign = counts < MB_REASSIGN * counts.max()
        if to_reassign.sum() > 0.5 * Xb.shape[0]:
            to_reassign[np.argsort(counts)[int(0.5 * Xb.shape[0]):]] = False
        n_reassigns = int(to_reassign.sum())
        if n_reassigns:
            picks = rs.choice(Xb.shape[0], replace=False, size=n_reassigns)
            where = torch.from_numpy(np.flatnonzero(to_reassign)).to(Xb.device)
            centers_new[where] = Xb[torch.from_numpy(picks).to(Xb.device)]
        counts[to_reassign] = np.min(counts[~to_reassign])
        return torch.from_numpy(counts).to(counts_d.device)

    def fit(self, X) -> "MiniBatchKMeans":
        X = _as_float(X)
        n_samples = X.shape[0]
        k = self.n_clusters
        if n_samples < k:
            raise ValueError(f"n_samples={n_samples} should be >= n_clusters={k}.")
        n_init = 3 if self.n_init == "auto" else int(self.n_init)
        batch = min(MB_BATCH, n_samples)
        init_size = min(3 * batch if 3 * batch >= k else 3 * k, n_samples)
        rs = np.random.RandomState(self.random_state)
        Xd = torch.from_numpy(X).to(self.device)
        ones = torch.ones(n_samples, dtype=Xd.dtype, device=self.device)
        x_sq = _row_norms(Xd)

        valid = torch.from_numpy(rs.randint(0, n_samples, init_size)).to(self.device)
        X_valid = Xd[valid]
        best_inertia = None
        for _ in range(n_init):
            sub = torch.from_numpy(rs.randint(0, n_samples, init_size)).to(self.device) \
                if init_size < n_samples else slice(None)
            centers, _ = kmeans_plusplus(Xd[sub], k, x_sq[sub], ones[sub], rs)
            inertia = float(_assign(X_valid, centers, ones[:init_size])[1])
            if best_inertia is None or inertia < best_inertia:
                init_centers, best_inertia = centers, inertia

        centers = init_centers
        counts = torch.zeros(k, dtype=Xd.dtype, device=self.device)
        any_empty = True
        ewa = ewa_min = None
        no_improvement = 0
        since_reassign = 0
        n_steps = (MB_MAX_ITER * n_samples) // batch
        p = np.full(n_samples, 1.0 / n_samples)
        unit = ones[:batch]
        self.host_reads = 0
        i = -1
        for i in range(n_steps):
            mb = torch.from_numpy(rs.choice(n_samples, batch, p=p, replace=True)).to(self.device)
            since_reassign += batch
            reassign = any_empty or since_reassign >= 10 * k
            if reassign:
                since_reassign = 0
            Xb = Xd[mb]
            labels, inertia = _assign(Xb, centers, unit)
            wsum = torch.zeros(k, dtype=Xd.dtype, device=self.device).index_add_(0, labels, unit)
            acc = (centers * counts[:, None]).index_add_(0, labels, Xb)
            counts_new = counts + wsum
            centers_new = torch.where((wsum > 0)[:, None], acc * (1.0 / counts_new.clamp_min(1e-300))[:, None],
                                      centers)
            counts = counts_new
            if reassign:
                counts = self._reassign(counts, centers_new, Xb, rs)
                self.host_reads += 1
            centers = centers_new
            batch_inertia, any_empty = torch.stack([inertia, (counts == 0).any().to(Xd.dtype)]).tolist()
            self.host_reads += 1
            # _mini_batch_convergence (tol = 0)
            batch_inertia /= batch
            if i == 0:
                continue
            if ewa is None:
                ewa = batch_inertia
            else:
                alpha = min(batch * 2.0 / (n_samples + 1), 1)
                ewa = ewa * (1 - alpha) + batch_inertia * alpha
            if ewa_min is None or ewa < ewa_min:
                no_improvement = 0
                ewa_min = ewa
            else:
                no_improvement += 1
            if no_improvement >= MB_NO_IMPROVEMENT:
                break
        self.n_steps_ = i + 1
        self.n_iter_ = int(np.ceil(((i + 1) * batch) / n_samples))
        labels, inertia = _assign(Xd, centers, ones)
        self.cluster_centers_ = centers.cpu().numpy()
        self.labels_ = labels.cpu().numpy().astype(np.int32)
        self.inertia_ = float(inertia)
        return self
