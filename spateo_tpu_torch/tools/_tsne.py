"""Barnes-Hut t-SNE on the device: what scikit-learn 1.9.0's
``TSNE(n_components, random_state=0).fit_transform(X)`` computes at its
defaults, ported step for step (`sklearn/manifold/_t_sne.py`,
`manifold/_utils.pyx`, `manifold/_barnes_hut_tsne.pyx`,
`neighbors/_quad_tree.pyx`), since the GPU machine has no scikit-learn. The
JAX package calls scikit-learn's `TSNE` (`perform_dimensionality_reduction`).

- kNN: ``min(N - 1, int(3 perplexity + 1))`` neighbours from
  `find_neighbors.knn` (float64, ties by index), each point's own entry
  dropped as `kneighbors()` drops it, the distances squared, then float32.
- P (`joint_probabilities_nn`): `_binary_search_perplexity` for every row at
  once in float64 (100 bisection steps, tolerance float32(1e-5), a row frozen
  where it meets it), then ``P + P^T`` over the kNN graph and its sum.
- The tree (`build_tree`): `_QuadTree` (an octree in 3-D) level by level.
  The root's bounds, the cell centres and widths are the same float32
  operations as `_init_root` / `_insert_point_in_new_child`; a point's child
  is ``point >= centre`` per axis, first axis the high bit, as in
  `_select_child`. Inserting in index order makes a cell a leaf exactly when
  its other points lie within float32(1e-6), on every axis, of its
  lowest-index point (the "anchor"); the points that joined the anchor's leaf
  before it split travel with the anchor from then on (`stuck`). A leaf's
  barycentre is its anchor; an inner cell's is the float64 mean of its points
  (scikit-learn's is a float32 running mean), a stuck point counted at its
  anchor. Past `MAX_DEPTH` levels a cell is made a leaf (scikit-learn would
  recurse without end there: float32 cannot split it).
- The walk (`negative_forces`): `_QuadTree.summarize` for all points at once,
  a frontier of (point, cell) pairs expanded a level at a time. A pair whose
  cell is a leaf within 1e-6 of the point is dropped; a leaf, or a cell with
  ``squared_max_width / d^2 < angle^2`` (float32), is a summary; other cells
  open to their children. No [N, N] object.
- The gradient (`kl_divergence_bh`): ``pos_f - neg_f / sum_Q`` scaled by
  ``2 (dof + 1) / dof``, each term in scikit-learn's dtypes (float32
  positions, P and forces, a float64 ``sum_Q``); the forces' sums are taken
  in float64 and stored as float32.
- The optimizer (`gradient_descent`): `_gradient_descent` with its gains,
  momentum and float64 update; the host reads the error and the gradient
  norm once a check (every `N_ITER_CHECK` = 50 iterations) and nowhere else.

Besides those reads, the tree reads two sizes a level (its points and
cells still to split) and the walk one (the frontier's), which torch needs
to allocate them.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

MACHINE_EPSILON = float(np.finfo(np.double).eps)
#: `_utils.pyx`'s and `_barnes_hut_tsne.pyx`'s constants are C floats.
EPSILON_DBL = float(np.float32(1e-8))
PERPLEXITY_TOLERANCE = float(np.float32(1e-5))
FLOAT32_TINY = float(np.finfo(np.float32).tiny)
FLOAT64_EPS = float(np.float32(np.finfo(np.float64).eps))
#: `_quad_tree.pyx`'s duplicate tolerance (a C float).
QT_EPSILON = float(np.float32(1e-6))
#: `TSNE`'s defaults that the port keeps fixed, and the JAX package's seed.
PERPLEXITY, EARLY_EXAGGERATION, ANGLE, MAX_ITER, RANDOM_STATE = 30.0, 12.0, 0.5, 1000, 0
#: `_gradient_descent`'s gain floor and gradient-norm stop.
MIN_GAIN, MIN_GRAD_NORM = 0.01, 1e-7
N_ITER_CHECK = 50
EXPLORATION_MAX_ITER = 250
PERPLEXITY_STEPS = 100
MAX_DEPTH = 128


# -- P --------------------------------------------------------------------------------------------------------


def binary_search_perplexity(sqdistances: torch.Tensor, desired_perplexity: float) -> torch.Tensor:
    """`_utils._binary_search_perplexity` on every row at once: float32
    squared distances [n, k] -> the conditional P [n, k] in float64, after
    `PERPLEXITY_STEPS` bisection steps (a row stops where it meets the
    tolerance)."""
    d = sqdistances.to(torch.float32).to(torch.float64)
    n = d.shape[0]
    desired_entropy = math.log(float(np.float32(desired_perplexity)))
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    beta_min = torch.full_like(beta, -math.inf)
    beta_max = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=d.device)
    P = torch.zeros_like(d)
    for _ in range(PERPLEXITY_STEPS):
        Pc = torch.exp(-d * beta[:, None])
        sum_Pi = Pc.sum(1)
        sum_Pi = torch.where(sum_Pi == 0.0, torch.full_like(sum_Pi, EPSILON_DBL), sum_Pi)
        Pc = Pc / sum_Pi[:, None]
        entropy_diff = torch.log(sum_Pi) + beta * (d * Pc).sum(1) - desired_entropy
        P = torch.where(done[:, None], P, Pc)
        done = done | (entropy_diff.abs() <= PERPLEXITY_TOLERANCE)
        up = entropy_diff > 0.0
        new_beta = torch.where(
            up,
            torch.where(torch.isinf(beta_max), beta * 2.0, (beta + beta_max) / 2.0),
            torch.where(torch.isinf(beta_min), beta / 2.0, (beta + beta_min) / 2.0),
        )
        beta_min = torch.where(done | ~up, beta_min, beta)
        beta_max = torch.where(done | up, beta_max, beta)
        beta = torch.where(done, beta, new_beta)
    return P


class SparseP(NamedTuple):
    """The joint P over the kNN graph, rows sorted, each row's columns
    sorted (scipy's canonical CSR): COO rows, columns, float64 values."""

    rows: torch.Tensor
    cols: torch.Tensor
    values: torch.Tensor


def joint_probabilities_nn(neighbors: torch.Tensor, sqdistances: torch.Tensor, desired_perplexity: float) -> SparseP:
    """`_joint_probabilities_nn` from each point's neighbours [n, k] (its own
    index excluded) and their squared distances: the conditional P in the
    CSR's column order, ``P + P^T``, divided by its sum (float64)."""
    n, k = neighbors.shape
    neighbors, order = torch.sort(neighbors, dim=1)
    sqdistances = torch.gather(sqdistances.to(torch.float32), 1, order)
    cond = binary_search_perplexity(sqdistances, desired_perplexity).reshape(-1)
    rows = torch.arange(n, device=neighbors.device).repeat_interleave(k)
    cols = neighbors.reshape(-1)
    keys, inverse = torch.unique(torch.cat([rows * n + cols, cols * n + rows]), return_inverse=True)
    values = torch.zeros(keys.shape, dtype=torch.float64, device=keys.device).index_add_(0, inverse, torch.cat([cond, cond]))
    values = values / torch.clamp_min(values.sum(), MACHINE_EPSILON)
    return SparseP(keys // n, keys % n, values)


def knn_sqdistances(X: np.ndarray, n_neighbors: int, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Each point's `n_neighbors` nearest others (``kneighbors()`` on the
    fitted points: its own entry dropped, or the first where duplicates push
    it out) and their squared euclidean distances as float32, on `device`."""
    from .find_neighbors import knn

    n = len(X)
    idx, dist = knn(X, n_neighbors + 1, device=device)
    own = idx == np.arange(n)[:, None]
    own[~own.any(1), 0] = True
    keep = ~own
    idx = idx[keep].reshape(n, n_neighbors)
    sq = (dist[keep] ** 2).astype(np.float32).reshape(n, n_neighbors)
    return torch.as_tensor(idx, device=device), torch.as_tensor(sq, device=device)


# -- the tree -------------------------------------------------------------------------------------------------


class Tree(NamedTuple):
    """`_QuadTree`'s cells, level by level: barycentre [C, d] float32, squared
    max width [C] float32, cumulative size [C] float32, leaf [C] bool,
    children [C, 2^d] int64 (-1 where absent), depth [C] int64, centre [C, d]."""

    barycenter: torch.Tensor
    squared_max_width: torch.Tensor
    size: torch.Tensor
    leaf: torch.Tensor
    children: torch.Tensor
    depth: torch.Tensor
    center: torch.Tensor


def _root_bounds(Y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`build_tree`'s box: the min, and the max widened to
    ``max(M (1 + 1e-3 sign M), M + 1e-3)``, in float32."""
    m = Y.min(0).values
    M = Y.max(0).values
    M = torch.maximum(M * (1.0 + 1e-3 * torch.sign(M)), M + 1e-3)
    return m[None], M[None]


def build_tree(Y: torch.Tensor) -> Tree:
    """`_QuadTree.build_tree(Y)` for float32 Y [n, d], d <= 3 (see the
    module's docstring for how a level is split)."""
    n, d = Y.shape
    K = 1 << d
    dev = Y.device
    weights = 1 << torch.arange(d - 1, -1, -1, device=dev)
    upper_of = (torch.arange(K, device=dev)[:, None] & weights) != 0  # a child's upper halves, by axis
    lo, hi = _root_bounds(Y)
    pts = torch.arange(n, device=dev)
    cell = torch.zeros(n, dtype=torch.int64, device=dev)
    stuck = torch.zeros(n, dtype=torch.bool, device=dev)
    out = {k: [] for k in Tree._fields if k != "depth"}
    sizes = []
    while True:
        C = lo.shape[0]
        sizes.append(C)
        center = (lo + hi) * 0.5
        width = hi - lo
        count = torch.bincount(cell, minlength=C)
        big = torch.full((C,), n, dtype=torch.int64, device=dev)
        P = Y[pts]
        A = Y[big.scatter_reduce(0, cell, pts, "amin")[cell]]
        dup = ((P - A).abs() <= QT_EPSILON).all(1)
        first = big.scatter_reduce(0, cell, torch.where(stuck | dup, n, pts), "amin")
        leaf = first == n
        if len(sizes) > MAX_DEPTH:
            leaf = torch.ones_like(leaf)
        # a leaf's points are all stuck to its anchor, so its mean is the anchor
        stuck = stuck | (pts < first[cell])
        pos = torch.where(stuck[:, None], A, P)
        sums = torch.zeros((C, d), dtype=torch.float64, device=dev).index_add_(0, cell, pos.to(torch.float64))
        out["barycenter"].append((sums / count[:, None]).to(torch.float32))
        out["squared_max_width"].append((width * width).max(1).values)
        out["size"].append(count.to(torch.float32))
        out["leaf"].append(leaf)
        out["center"].append(center)
        go = (~leaf.index_select(0, cell)).nonzero().squeeze(1)
        pts, cell, stuck, pos = (t.index_select(0, go) for t in (pts, cell, stuck, pos))
        key = cell * K + ((pos >= center[cell]).to(torch.int64) * weights).sum(1)
        exists = torch.zeros(C * K, dtype=torch.bool, device=dev)
        exists[key] = True
        keys = exists.nonzero().squeeze(1)
        local = torch.cumsum(exists.to(torch.int64), 0) - 1
        out["children"].append(torch.where(exists, local + sum(sizes), -1).reshape(C, K))
        if keys.numel() == 0:
            break
        bounds = torch.stack((lo, hi, center), 1)[keys // K]
        upper = upper_of[keys % K]
        lo, hi = torch.where(upper, bounds[:, 2], bounds[:, 0]), torch.where(upper, bounds[:, 1], bounds[:, 2])
        cell = local[key]
    depth = torch.repeat_interleave(torch.arange(len(sizes), device=dev), torch.tensor(sizes, device=dev))
    return Tree(**{k: torch.cat(v) for k, v in out.items()}, depth=depth)


# -- the gradient ---------------------------------------------------------------------------------------------


def _sq_norm(diff: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, added axis by axis in float32 (the
    order of scikit-learn's loops)."""
    out = diff[:, 0] * diff[:, 0]
    for ax in range(1, diff.shape[1]):
        out = out + diff[:, ax] * diff[:, ax]
    return out


def _student_q(dist2: torch.Tensor, dof: int) -> torch.Tensor:
    """``dof / (dof + d^2)`` in float32 (a tensor division, as C divides)."""
    return torch.full_like(dist2, float(dof)) / (dist2 + float(dof))


def negative_forces(Y: torch.Tensor, tree: Tree, angle: float, dof: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`compute_gradient_negative`: every point's summaries of the tree,
    walked a level at a time. Returns (neg_f [n, d] float32, sum_Q float64)."""
    n, d = Y.shape
    K = tree.children.shape[1]
    theta2 = float(np.float32(angle) * np.float32(angle))
    exponent = (dof + 1.0) / 2.0
    pi = torch.arange(n, device=Y.device)
    ci = torch.zeros(n, dtype=torch.int64, device=Y.device)
    neg = torch.zeros((n, d), dtype=torch.float64, device=Y.device)
    sum_Q = torch.zeros((), dtype=torch.float64, device=Y.device)
    while pi.numel():
        diff = Y.index_select(0, pi) - tree.barycenter.index_select(0, ci)
        dist2 = _sq_norm(diff)
        leaf = tree.leaf.index_select(0, ci)
        far = tree.squared_max_width.index_select(0, ci) / dist2 < theta2
        near = (diff.abs() <= QT_EPSILON).all(1)
        summary = torch.where(leaf, ~near, far)
        qZ = _student_q(dist2, dof).to(torch.float64)
        if dof != 1:
            qZ = qZ**exponent
        size = torch.where(summary, tree.size.index_select(0, ci), 0.0).to(torch.float64)
        sum_Q = sum_Q + (size * qZ).sum()
        mult = (size * qZ * qZ).to(torch.float32)
        neg.index_add_(0, pi, (mult[:, None] * diff).to(torch.float64))
        children = tree.children.index_select(0, ci)
        nxt = ((children >= 0) & ~(leaf | far)[:, None]).reshape(-1).nonzero().squeeze(1)
        pi = pi.repeat_interleave(K).index_select(0, nxt)
        ci = children.reshape(-1).index_select(0, nxt)
    return neg.to(torch.float32), torch.clamp_min(sum_Q, FLOAT64_EPS)


def positive_forces(Y: torch.Tensor, P: SparseP, val_P: torch.Tensor, dof: int, sum_Q: torch.Tensor,
                    compute_error: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`compute_gradient_positive` over P's entries: (pos_f [n, d] float32,
    the KL divergence, or None without `compute_error`)."""
    buff = Y[P.rows] - Y[P.cols]
    q = _student_q(_sq_norm(buff), dof)
    if dof != 1:
        q = q ** ((dof + 1.0) / 2.0)
    pos = torch.zeros(Y.shape, dtype=torch.float64, device=Y.device)
    pos.index_add_(0, P.rows, ((val_P * q)[:, None] * buff).to(torch.float64))
    error = None
    if compute_error:
        qn = (q.to(torch.float64) / sum_Q).to(torch.float32)
        ratio = torch.clamp_min(val_P, FLOAT32_TINY) / torch.clamp_min(qn, FLOAT32_TINY)
        error = (val_P.to(torch.float64) * torch.log(ratio.to(torch.float64))).sum().to(torch.float32)
    return pos.to(torch.float32), error


def kl_divergence_bh(Y: torch.Tensor, P: SparseP, val_P: torch.Tensor, dof: int, angle: float = ANGLE,
                     compute_error: bool = True) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """`_kl_divergence_bh` on float32 positions Y [n, d] and float32 P values:
    (the KL divergence as a float32 device scalar, or None without
    `compute_error`; the gradient [n, d] float32)."""
    tree = build_tree(Y)
    neg, sum_Q = negative_forces(Y, tree, angle, dof)
    pos, error = positive_forces(Y, P, val_P, dof, sum_Q, compute_error)
    grad = (pos.to(torch.float64) - neg.to(torch.float64) / sum_Q).to(torch.float32)
    return error, grad * (2.0 * (dof + 1.0) / dof)


# -- the optimizer --------------------------------------------------------------------------------------------


def gradient_descent(objective: Callable[[torch.Tensor, bool], Tuple[Optional[torch.Tensor], torch.Tensor]],
                     p0: torch.Tensor, it: int, max_iter: int, n_iter_check: int = 1,
                     n_iter_without_progress: int = 300, momentum: float = 0.8,
                     learning_rate: float = 200.0) -> Tuple[torch.Tensor, float, int]:
    """`_gradient_descent` on the device: float32 positions and gains, a
    float64 update (scikit-learn's learning rate is a numpy float64). The
    host reads the error and the gradient norm at each check. Returns
    (positions, the last error, the last iteration)."""
    p = p0.clone()
    update = torch.zeros(p.shape, dtype=torch.float64, device=p.device)
    gains = torch.ones_like(p)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    err = None
    for i in range(it, max_iter):
        check = (i + 1) % n_iter_check == 0
        err, grad = objective(p, check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.clamp_min(torch.where(inc, gains + 0.2, gains * 0.8), MIN_GAIN)
        grad = grad * gains
        update = momentum * update - float(learning_rate) * grad.to(torch.float64)
        p = (p.to(torch.float64) + update).to(torch.float32)
        if check:
            gradient_descent.host_reads += 1
            error, grad_norm = torch.stack([err.to(torch.float64), torch.linalg.vector_norm(grad)]).tolist()
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    if err is not None and not check:
        gradient_descent.host_reads += 1
        error = float(err)
    return p, error, i


gradient_descent.host_reads = 0


# -- the estimator --------------------------------------------------------------------------------------------


class TSNE:
    """scikit-learn 1.9's ``TSNE(n_components, random_state=0)`` at its other
    defaults (Barnes-Hut, angle 0.5, euclidean, perplexity 30, early
    exaggeration 12, learning rate "auto", PCA init, 1,000 iterations) on
    `device`: `fit_transform(X)` returns the float32 embedding on the host
    and sets `embedding_`, `kl_divergence_`, `n_iter_` and `learning_rate_`."""

    def __init__(self, n_components: int = 2, device="cuda"):
        self.n_components = n_components
        self.device = device

    def initial_embedding(self, X: np.ndarray) -> torch.Tensor:
        """The PCA init on the device: the port's `PCA` of X, float32, rescaled
        so that column 0 has standard deviation 1e-4."""
        from .dimensionality_reduction import PCA

        pca = PCA(n_components=self.n_components, random_state=np.random.RandomState(RANDOM_STATE),
                  device=self.device).fit(X)
        Xd = torch.as_tensor(X, dtype=torch.float64, device=self.device)
        Y = (Xd @ pca._components_d.T - pca._mean_d[None, :] @ pca._components_d.T).to(torch.float32)
        return Y / torch.std(Y[:, 0], correction=0) * 1e-4

    def fit_transform(self, X, y=None) -> np.ndarray:
        X = np.asarray(X)
        X = X if X.dtype in (np.float32, np.float64) else X.astype(np.float64)
        n = X.shape[0]
        if PERPLEXITY >= n:
            raise ValueError(f"perplexity ({PERPLEXITY}) must be less than n_samples ({n})")
        if self.n_components > 3:
            raise ValueError("'n_components' should be inferior to 4 for the barnes_hut algorithm as it relies "
                             "on quad-tree or oct-tree.")
        self.learning_rate_ = max(n / EARLY_EXAGGERATION / 4, 50)
        neighbors, sqd = knn_sqdistances(X, min(n - 1, int(3.0 * PERPLEXITY + 1)), device=self.device)
        P = joint_probabilities_nn(neighbors, sqd, PERPLEXITY)
        Y = self.initial_embedding(X)
        dof = max(self.n_components - 1, 1)

        def objective(values):
            val_P = values.to(torch.float32)
            return lambda p, compute_error: kl_divergence_bh(p, P, val_P, dof, ANGLE, compute_error)

        exaggerated = P.values * EARLY_EXAGGERATION
        opt = dict(n_iter_check=N_ITER_CHECK, learning_rate=self.learning_rate_)
        Y, kl, it = gradient_descent(objective(exaggerated), Y, 0, EXPLORATION_MAX_ITER, momentum=0.5,
                                     n_iter_without_progress=EXPLORATION_MAX_ITER, **opt)
        Y, kl, it = gradient_descent(objective(exaggerated / EARLY_EXAGGERATION), Y, it + 1, MAX_ITER,
                                     momentum=0.8, **opt)
        self.n_iter_ = it
        self.kl_divergence_ = kl
        self.embedding_ = Y.cpu().numpy()
        return self.embedding_
