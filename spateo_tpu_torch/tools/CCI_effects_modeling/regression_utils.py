"""Regression machinery for spatially-weighted models
(capability parity: reference
spateo/tools/CCI_effects_modeling/regression_utils.py:136,180,244,594,654,692,807).

Counterpart of `spateo_tpu.tools.CCI_effects_modeling.regression_utils`.
`iwls_batch` and `iwls_batch_full` fit the local GLM of every query cell at
once on the device: the [q, k, k] normal equations of all cells come from
wide matrix products, are solved by a batched pivot-free Gauss-Jordan in the
JAX package's order, inside a fixed-count IWLS loop with no host read. This
replaces the reference's per-cell `local_fit` loop (the vestigial-MPI
`mpi_fit`, reference MuSIC.py:2940-3006). The host helpers (single fits,
tests, corrections, collinearity) are numpy, copied.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse
import torch
from scipy import linalg, stats

from ...core.bridge import _to_device
from ...logging import logger_manager as lm
from .distributions import EPS, Distribution, Gaussian, NegativeBinomial, Poisson


def sparse_dot(a, b, return_array: bool = True):
    out = a @ b
    if return_array and scipy.sparse.issparse(out):
        out = np.asarray(out.todense())
    return out


def compute_betas(y, x, ridge_lambda: float = 0.0, clip: float = 5.0):
    """Global ridge WLS (parity: regression_utils.py:136)."""
    x = np.asarray(x.todense()) if scipy.sparse.issparse(x) else np.asarray(x)
    y = np.asarray(y.todense()) if scipy.sparse.issparse(y) else np.asarray(y)
    xtx = x.T @ x
    if ridge_lambda is not None:
        xtx = xtx + ridge_lambda * np.eye(xtx.shape[0])
    try:
        xtx_inv = linalg.inv(xtx)
    except Exception:
        xtx_inv = linalg.pinv(xtx)
    betas = xtx_inv @ (x.T @ y)
    return np.clip(betas, -clip, clip)


def compute_betas_local(y, x, w, ridge_lambda: float = 0.0, clip: Optional[float] = None):
    """Single-location weighted WLS (parity: regression_utils.py:180).
    Returns (betas, pseudoinverse, cov_inverse)."""
    y = np.asarray(y, dtype=float).ravel()
    x = np.asarray(x, dtype=float)
    w = np.asarray(w, dtype=float).ravel()
    yw = y * w
    xT = (x * w[:, None]).T
    if np.all(yw == 0) or np.all(xT == 0):
        return (
            np.full((x.shape[1], 1), 1e-20),
            np.zeros((x.shape[1], x.shape[0])),
            np.zeros((x.shape[1], x.shape[1])),
        )
    xtx = xT @ x
    if ridge_lambda is not None:
        xtx = xtx + ridge_lambda * np.eye(xtx.shape[0])
    try:
        cov_inverse = linalg.inv(xtx)
    except Exception:
        cov_inverse = linalg.pinv(xtx)
    pseudoinverse = cov_inverse @ xT
    betas = pseudoinverse @ y
    if clip is not None:
        betas = np.clip(betas, -clip, clip)
    return betas.reshape(-1, 1), pseudoinverse, cov_inverse


def iwls(
    y,
    x,
    distr: str = "gaussian",
    init_betas: Optional[np.ndarray] = None,
    offset: Optional[np.ndarray] = None,
    tol: float = 1e-8,
    clip: Optional[float] = None,
    threshold: float = 1e-4,
    max_iter: int = 200,
    spatial_weights: Optional[np.ndarray] = None,
    i: Optional[int] = None,
    link=None,
    ridge_lambda: Optional[float] = None,
    mask: Optional[np.ndarray] = None,
):
    """Single-fit IWLS (parity surface: regression_utils.py:244).

    Returns (betas, y_hat, n_iter, w_final[, ...diagnostics]) following the
    reference's convention; the hot path for MuSIC is `iwls_batch` below.
    """
    y = np.asarray(y, dtype=float).reshape(-1)
    x = np.asarray(x.todense() if scipy.sparse.issparse(x) else x, dtype=float)
    n, k = x.shape
    family = _family(distr)
    w_sp = np.ones(n) if spatial_weights is None else np.asarray(spatial_weights, dtype=float).reshape(-1)
    if np.all(y == 0) or np.all(x == 0):
        return np.zeros((k, 1)), np.zeros((n, 1)), 0, w_sp.reshape(-1, 1)

    mu = family.initial_predictions(y)
    eta = family.get_predictors(mu)
    betas = np.zeros(k) if init_betas is None else np.asarray(init_betas).ravel()
    n_iter = 0
    diff = 1e6
    while diff > tol and n_iter < max_iter:
        n_iter += 1
        w_irls = family.weights(mu)
        z = eta + (y - mu) * family.link.deriv(mu)
        if offset is not None:
            z = z - offset
        wt = w_irls * w_sp
        new_betas, _, _ = compute_betas_local(z, x, np.sqrt(wt), ridge_lambda=ridge_lambda or 0.0, clip=clip)
        new_betas = new_betas.ravel()
        eta = x @ new_betas + (offset if offset is not None else 0.0)
        mu = family.predict(eta)
        diff = np.max(np.abs(new_betas - betas)) if np.any(betas) else np.max(np.abs(new_betas))
        betas = new_betas
    betas[np.abs(betas) < threshold] = 0
    y_hat = family.predict(x @ betas + (offset if offset is not None else 0.0))
    return betas.reshape(-1, 1), y_hat.reshape(-1, 1), n_iter, (w_sp * family.weights(mu)).reshape(-1, 1)


def _family(distr: str) -> Distribution:
    if distr == "gaussian":
        return Gaussian()
    if distr == "poisson":
        return Poisson()
    if distr == "nb":
        return NegativeBinomial()
    from .distributions import Binomial

    if distr == "binomial":
        return Binomial()
    raise ValueError(f"Unknown distribution {distr}")



# ---------------------------------------------------------------------------
# Batched GWR/IWLS on the device
# ---------------------------------------------------------------------------
def _glm_funcs(distr: str):
    """inv-link and variance functions for the log-link GLM families."""

    def inv_link(eta):
        return torch.exp(torch.clamp(eta, -30, 30))

    if distr == "poisson":

        def var_fn(mu):
            return torch.clamp(mu, min=1e-8)

    else:  # nb with dispersion 1

        def var_fn(mu):
            mu = torch.clamp(mu, min=1e-8)
            return mu + mu**2

    return inv_link, var_fn


def _pair_features(X: torch.Tensor) -> Optional[torch.Tensor]:
    """[n, k^2] pairwise products X[:, j] * X[:, l]: every location's normal
    matrix X' diag(wt_q) X is then one row of ONE [q, n] @ [n, k^2] product
    instead of q small [k, n] @ [n, k] ones. None (einsum path) for k > 32,
    where the k^2 columns would dwarf the problem."""
    n, k = X.shape
    if k > 32:
        return None
    return (X[:, :, None] * X[:, None, :]).reshape(n, k * k)


def _xtx_gemm(wt: torch.Tensor, X: torch.Tensor, F: Optional[torch.Tensor], eye: torch.Tensor) -> torch.Tensor:
    """All locations' ridge-regularized normal matrices [q, k, k]."""
    q = wt.shape[0]
    k = X.shape[1]
    if F is not None:
        return (wt @ F).reshape(q, k, k) + eye
    return torch.einsum("qn,nj,nl->qjl", wt, X, X) + eye


def _take_focal(A: torch.Tensor, focal: torch.Tensor) -> torch.Tensor:
    """A[q, focal[q]] for a [q, n] array."""
    return torch.take_along_dim(A, focal[:, None], dim=1)[:, 0]


def _solve_spd_batched(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A x = B for a batch of small SPD systems ([q, k, k] @ [q, k, m])
    by pivot-free Gauss-Jordan elimination: k rank-1 steps, each elementwise
    over the whole batch, in the JAX package's order. Elimination without
    pivoting is backward stable for symmetric positive-definite matrices
    (the normal matrices here: ridge + non-negative IRLS x spatial weights).
    Unlike `torch.linalg.solve`, it reads no status back to the host.

    Each step builds the eliminated matrix as a new tensor and then writes
    the pivot row into it: the elimination reads row j, so the row must not
    be written in place first."""
    k = A.shape[1]
    M = torch.cat([A, B], dim=2)  # [q, k, k+m]
    for j in range(k):
        pivot = M[:, j, :] / M[:, j, j][:, None]  # [q, k+m]
        M = M - M[:, :, j][:, :, None] * pivot[:, None, :]
        M[:, j, :] = pivot
    return M[:, :, k:]


def _irls_loop(y, X, W, F, eye, clip, distr, n_irls_iter):
    """The fixed-count IWLS loop of the log-link families, with no host read
    (the JAX package's `lax.scan`). Returns (beta [q, k], eta [q, n], the
    function giving (mu, z, IRLS x spatial weights) of an eta)."""
    q, n = W.shape
    k = X.shape[1]
    inv_link, var_fn = _glm_funcs(distr)

    def stats_of(eta):
        mu = inv_link(eta)  # [q, n]
        g_deriv = 1.0 / torch.clamp(mu, min=1e-8)  # d eta/d mu for log link
        z = eta + (y[None, :] - mu) * g_deriv
        w_irls = 1.0 / (var_fn(mu) * g_deriv**2 + 1e-12)
        return mu, z, w_irls * W

    mu0 = (y + torch.mean(y)) / 2.0
    eta = torch.log(torch.clamp(mu0, min=1e-8)).expand(q, n)
    beta = torch.zeros((q, k), dtype=W.dtype, device=W.device)
    for _ in range(n_irls_iter):
        _, z, wt = stats_of(eta)
        xtx = _xtx_gemm(wt, X, F, eye)
        xty = (wt * z) @ X  # [q, k]
        beta = torch.clamp(_solve_spd_batched(xtx, xty[..., None])[..., 0], -clip, clip)
        eta = beta @ X.T
    return beta, eta, stats_of


def _iwls_batch_kernel(
    y: torch.Tensor,  # [n]
    X: torch.Tensor,  # [n, k]
    W: torch.Tensor,  # [q, n] spatial weights of each query location
    ridge_lambda: float,
    clip: float,
    distr: str = "gaussian",
    n_irls_iter: int = 25,
    focal: Optional[torch.Tensor] = None,  # [q] global X-row of each query
):
    """Local GLM fits for q query locations, on the device of `W`.

    Returns (betas [q, k], hat_diag [q] leverage of the focal sample). The
    inner IWLS runs a fixed number of iterations (converged fits stop
    moving); all q normal-equation systems come from wide products (see
    `_pair_features`) and one batched [q, k, k] solve; the iteration state
    is one [q, n] linear-predictor array.
    """
    n, k = X.shape
    q = W.shape[0]
    eye = torch.eye(k, dtype=W.dtype, device=W.device) * ridge_lambda
    focal = torch.arange(q, device=W.device) if focal is None else focal
    F = _pair_features(X)
    Xf = X[focal]  # [q, k]

    if distr == "gaussian":
        # closed form WLS, all locations at once (one solve, two rhs)
        xtx = _xtx_gemm(W, X, F, eye)
        xty = W @ (X * y[:, None])  # [q, k]
        sol = _solve_spd_batched(xtx, torch.stack([xty, Xf], dim=2))
        beta = torch.clamp(sol[..., 0], -clip, clip)
        # leverage of the focal sample: x_i (X'WX)^-1 x_i^T w_i
        hat = torch.sum(Xf * sol[..., 1], dim=1) * _take_focal(W, focal)
        return beta, hat

    beta, eta, stats_of = _irls_loop(y, X, W, F, eye, clip, distr, n_irls_iter)
    # leverage at convergence
    _, _, wt = stats_of(eta)
    xtx = _xtx_gemm(wt, X, F, eye)
    sol = _solve_spd_batched(xtx, Xf[..., None])[..., 0]
    hat = torch.sum(Xf * sol, dim=1) * _take_focal(wt, focal)
    return beta, hat


def _iwls_batch_full_kernel(
    y: torch.Tensor,  # [n]
    X: torch.Tensor,  # [n, k]
    W: torch.Tensor,  # [q, n] spatial weights of each query location
    focal: torch.Tensor,  # [q] global row index of each query's focal sample
    ridge_lambda: float,
    clip: float,
    distr: str = "gaussian",
    n_irls_iter: int = 25,
):
    """Local GLM fits with the per-location diagnostics the reference's
    `local_fit` returns (reference MuSIC.py:2665): coefficients, leverage of
    the focal sample (hat), the diagonal of the inverse covariance / Fisher
    matrix (for standard errors), and the focal prediction.

    Returns (betas [q, k], hat [q], inv_diag [q, k], pred [q]).
    """
    n, k = X.shape
    q = W.shape[0]
    eye_k = torch.eye(k, dtype=W.dtype, device=W.device)
    eye = eye_k * ridge_lambda
    F = _pair_features(X)
    Xf = X[focal]  # [q, k]

    if distr == "gaussian":
        xtx = _xtx_gemm(W, X, F, eye)
        inv_cov = _solve_spd_batched(xtx, eye_k.expand(q, k, k))  # [q, k, k]
        xty = W @ (X * y[:, None])  # [q, k]
        beta = torch.clamp(torch.einsum("qkl,ql->qk", inv_cov, xty), -clip, clip)
        # hat = x_f (X'WX)^-1 (x_f w_f): the focal column of the pseudo-inverse
        hat = torch.einsum("qk,qkl,ql->q", Xf, inv_cov, Xf) * _take_focal(W, focal)
        pred = torch.sum(Xf * beta, dim=1)
        return beta, hat, torch.diagonal(inv_cov, dim1=1, dim2=2), pred

    beta, eta, stats_of = _irls_loop(y, X, W, F, eye, clip, distr, n_irls_iter)
    mu, _, wt = stats_of(eta)
    xtx = _xtx_gemm(wt, X, F, eye)
    fisher_inv = _solve_spd_batched(xtx, eye_k.expand(q, k, k))
    hat = torch.einsum("qk,qkl,ql->q", Xf, fisher_inv, Xf) * _take_focal(wt, focal)
    pred = _take_focal(mu, focal)
    return beta, hat, torch.diagonal(fisher_inv, dim1=1, dim2=2), pred


def _auto_block(q: int, n: int) -> int:
    """Query rows per block: as many as ~2 GB of [block, n] IRLS state
    (~12 bytes an entry) allows, at least 1,024 (the JAX package's formula;
    blocks do not change results, since the rows are independent)."""
    limit = int(2e9 / max(12 * n, 1))
    return max(1024, min(q, limit))


def _weights_on(W, device) -> torch.Tensor:
    """W as float32 where it lies when it is a tensor (a CUDA tensor stays
    on the card), else uploaded to `device`."""
    if isinstance(W, torch.Tensor):
        return W.to(torch.float32)
    return _to_device(np.asarray(W, np.float32), device)


def iwls_batch_full(
    y: np.ndarray,
    X: np.ndarray,
    W,
    focal: Optional[np.ndarray] = None,
    distr: str = "gaussian",
    ridge_lambda: float = 0.0,
    clip: float = 5.0,
    n_irls_iter: int = 25,
    block: Optional[int] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All-locations GWR/GLM fits with full diagnostics, blocked on the
    device. `W` [q, n] is a host array (uploaded to `device`) or a tensor
    (used where it lies); y and X follow it there. Each block's [q, k] and
    [q] results reach the host in one copy.

    `focal[q]` is the global row of the q-th query in y/X (defaults to
    0..q-1, the identity used when every cell is a query).
    Returns (betas [q, k], hat [q], inv_diag [q, k], pred [q]).
    """
    W_d = _weights_on(W, device)
    dev = W_d.device
    y_d = _to_device(np.asarray(y, np.float32).ravel(), dev)
    X_d = _to_device(np.asarray(X, np.float32), dev)
    q = W_d.shape[0]
    k = X_d.shape[1]
    focal = np.arange(q, dtype=np.int64) if focal is None else np.asarray(focal, np.int64)
    focal_d = _to_device(focal, dev)
    block = _auto_block(q, X_d.shape[0]) if block is None else block
    out = np.zeros((q, 2 * k + 2), np.float32)
    for s in range(0, q, block):
        Wb = W_d[s : s + block]
        e = s + Wb.shape[0]
        b, h, d, p = _iwls_batch_full_kernel(
            y_d, X_d, Wb, focal_d[s:e], float(ridge_lambda), float(clip), distr, n_irls_iter
        )
        out[s:e] = torch.cat([b, h[:, None], d, p[:, None]], dim=1).cpu().numpy()
    return out[:, :k].copy(), out[:, k].copy(), out[:, k + 1 : 2 * k + 1].copy(), out[:, -1].copy()


def iwls_batch(
    y: np.ndarray,
    X: np.ndarray,
    W,
    distr: str = "gaussian",
    ridge_lambda: float = 0.0,
    clip: float = 5.0,
    n_irls_iter: int = 25,
    block: Optional[int] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """All-locations GWR/GLM fits, blocked on the device (`W` as in
    `iwls_batch_full`; every cell is a query, so W is [n, n]).

    Returns (betas [n, k], hat_diag [n]).
    """
    W_d = _weights_on(W, device)
    dev = W_d.device
    y_d = _to_device(np.asarray(y, np.float32).ravel(), dev)
    X_d = _to_device(np.asarray(X, np.float32), dev)
    k = X_d.shape[1]
    out = _iwls_rows(y_d, X_d, W_d, 0, distr, ridge_lambda, clip, n_irls_iter, block).cpu().numpy()
    return out[:, :k].copy(), out[:, k].copy()


def _iwls_rows(y_d, X_d, W_d, first: int, distr, ridge_lambda, clip, n_irls_iter, block=None) -> torch.Tensor:
    """`_iwls_batch_kernel` over the rows of W_d in blocks of `block`, row i's
    focal sample being X's row ``first + i``: [rows, k + 1] (the betas, then
    the hat) on W_d's device."""
    rows = W_d.shape[0]
    block = _auto_block(max(rows, 1), X_d.shape[0]) if block is None else block
    out = torch.empty((rows, X_d.shape[1] + 1), dtype=torch.float32, device=W_d.device)
    for s in range(0, rows, block):
        e = min(s + block, rows)
        # each block's focal samples are the GLOBAL rows first + s .. first + e
        fb = torch.arange(first + s, first + e, device=W_d.device)
        b, h = _iwls_batch_kernel(y_d, X_d, W_d[s:e], float(ridge_lambda), float(clip), distr, n_irls_iter, fb)
        out[s:e] = torch.cat([b, h[:, None]], dim=1)
    return out


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------
def wald_test(theta_mle, theta_sd, theta0: float = 0.0) -> np.ndarray:
    """Two-sided Wald test p-values (parity: regression_utils.py:654)."""
    theta_mle = np.asarray(theta_mle, dtype=float)
    theta_sd = np.asarray(theta_sd, dtype=float)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (theta_mle - theta0) / np.maximum(theta_sd, 1e-12)
    return np.clip(2 * stats.norm.sf(np.abs(z)), 0, 1)


def multitesting_correction(pvals, method: str = "fdr_bh", alpha: float = 0.05) -> np.ndarray:
    """Multiple-testing correction (parity: regression_utils.py:692)."""
    from ...svg.utils import multipletests_bh

    pvals = np.asarray(pvals, dtype=float)
    if method in ("fdr_bh", "bh"):
        return multipletests_bh(pvals)
    if method == "bonferroni":
        return np.clip(pvals * len(pvals), 0, 1)
    raise ValueError(f"Unsupported correction method {method}")


def run_permutation_test(data, thresh: float, subset_rows=None, subset_cols=None) -> np.ndarray:
    """Proportion of permuted values exceeding a threshold (parity:
    regression_utils.py:807 helper)."""
    data = np.asarray(data)
    if subset_rows is not None:
        data = data[subset_rows]
    if subset_cols is not None:
        data = data[:, subset_cols]
    return (np.abs(data) > thresh).mean(axis=0)


def assess_multicollinearity(X: np.ndarray, thresh: float = 5.0) -> np.ndarray:
    """Variance-inflation factors per feature (parity:
    regression_utils.py:594 VIF check)."""
    X = np.asarray(X, dtype=float)
    n, k = X.shape
    vifs = np.zeros(k)
    for j in range(k):
        others = np.delete(X, j, axis=1)
        others = np.c_[np.ones(n), others]
        beta, *_ = np.linalg.lstsq(others, X[:, j], rcond=None)
        resid = X[:, j] - others @ beta
        ss_res = (resid**2).sum()
        ss_tot = ((X[:, j] - X[:, j].mean()) ** 2).sum()
        r2 = 1 - ss_res / max(ss_tot, 1e-30)
        vifs[j] = 1.0 / max(1 - r2, 1e-12)
    high = np.where(vifs > thresh)[0]
    if high.size:
        lm.main_warning(f"Features {high} exceed VIF threshold {thresh} (possible multicollinearity).")
    return vifs



def iwls_batch_sharded(
    y: np.ndarray,
    X: np.ndarray,
    W,
    mesh=None,
    distr: str = "gaussian",
    ridge_lambda: float = 0.0,
    clip: float = 5.0,
    n_irls_iter: int = 25,
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-device local fits: the query rows of W [q, n] split over the
    mesh's "data" axis (`config.mesh` when `mesh` is None), y and X on every
    rank. Each rank fits its rows with `_iwls_batch_kernel`, their leverage
    against their global focal rows, and one gather gives every rank the
    whole (betas [q, k], hat_diag [q]) as host arrays. The rows are
    independent, so nothing is padded and no other collective runs."""
    from ...configuration import config
    from ...parallel._collectives import RowShard

    mesh = mesh if mesh is not None else config.mesh
    shard = RowShard(mesh, int(W.shape[0]), "data")
    dev = shard.device
    y_d = _to_device(np.asarray(y, np.float32).ravel(), dev)
    X_d = _to_device(np.asarray(X, np.float32), dev)
    W_d = _weights_on(shard.take(W), dev).to(dev)
    k = X_d.shape[1]
    local = _iwls_rows(y_d, X_d, W_d, shard.lo, distr, ridge_lambda, clip, n_irls_iter)
    out = shard.gather_rows(local).cpu().numpy()
    return out[:, :k].copy(), out[:, k].copy()

# -- reference-named numeric helpers (reference regression_utils.py) --------


def softplus(z: np.ndarray) -> np.ndarray:
    """Numerically-stable log(1+e^z) (parity: regression_utils.py softplus)."""
    z = np.asarray(z, float)
    return np.where(z > 30, z, np.log1p(np.exp(np.clip(z, -30, 30))))


def mse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean((np.asarray(y_true) - np.asarray(y_pred)) ** 2))


def mae(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(y_true) - np.asarray(y_pred))))


def logistic_objective(threshold: float, proba: np.ndarray, y_true: np.ndarray) -> float:
    """Negative F1 of thresholded probabilities (parity:
    regression_utils.py logistic_objective, used for threshold search)."""
    pred = (np.asarray(proba) >= threshold).astype(int)
    yt = np.asarray(y_true).astype(int)
    tp = int((pred & yt).sum())
    prec = tp / max(pred.sum(), 1)
    rec = tp / max(yt.sum(), 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    return -f1


def golden_section_search(func, a: float, b: float, tol: float = 1e-5, min_or_max: str = "min") -> float:
    """Scalar golden-section optimizer (parity: regression_utils.py
    golden_section_search)."""
    gr = (np.sqrt(5) + 1) / 2
    sign = 1.0 if min_or_max == "min" else -1.0
    c = b - (b - a) / gr
    d = a + (b - a) / gr
    while abs(b - a) > tol:
        if sign * func(c) < sign * func(d):
            b = d
        else:
            a = c
        c = b - (b - a) / gr
        d = a + (b - a) / gr
    return (a + b) / 2


def library_scaling_factors(offset: Optional[np.ndarray] = None, counts: Optional[np.ndarray] = None, distr: str = "gaussian") -> np.ndarray:
    """Per-cell library-size factors (parity: regression_utils.py
    library_scaling_factors)."""
    if offset is not None:
        return np.asarray(offset, float)
    totals = np.asarray(counts).sum(axis=1).astype(float).ravel()
    return totals / max(np.median(totals), 1e-12)


def get_fisher_inverse(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Inverse Fisher information of a linear model (parity:
    regression_utils.py get_fisher_inverse)."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    resid_var = max(float(np.var(y)), 1e-12)
    return np.linalg.pinv(x.T @ x) * resid_var


def multicollinearity_check(X, thresh: float = 5.0, logger=None):
    """Drop columns with VIF above `thresh` (parity: regression_utils.py
    multicollinearity_check)."""
    import pandas as pd

    df = X.copy() if isinstance(X, pd.DataFrame) else pd.DataFrame(np.asarray(X, float))
    while df.shape[1] > 1:
        M = df.values.astype(float)
        vifs = []
        for j in range(M.shape[1]):
            others = np.delete(M, j, axis=1)
            beta, *_ = np.linalg.lstsq(others, M[:, j], rcond=None)
            resid = M[:, j] - others @ beta
            r2 = 1 - resid.var() / max(M[:, j].var(), 1e-12)
            vifs.append(1 / max(1 - r2, 1e-12))
        worst = int(np.argmax(vifs))
        if vifs[worst] <= thresh:
            break
        df = df.drop(columns=df.columns[worst])
    return df


def assign_significance(pvals, alpha: float = 0.05):
    """Map p-values to star annotations (parity: regression_utils.py
    assign_significance)."""
    p = np.asarray(pvals, float)
    out = np.full(p.shape, "ns", dtype=object)
    out[p < 0.05] = "*"
    out[p < 0.01] = "**"
    out[p < 0.001] = "***"
    return out


def permutation_testing(
    data: np.ndarray,
    n_permutations: int = 10000,
    n_jobs: int = 1,
    subset_rows=None,
    subset_cols=None,
) -> float:
    """Permutation p-value for the mean of a subset vs the population
    (parity: regression_utils.py permutation_testing)."""
    rng = np.random.default_rng(0)
    data = np.asarray(data, float)
    full = data.ravel()
    sub = data[subset_rows][:, subset_cols].ravel() if (subset_rows is not None and subset_cols is not None) else full
    obs = sub.mean()
    k = len(sub)
    null = np.asarray([rng.choice(full, k, replace=False).mean() for _ in range(n_permutations)])
    return float(((null >= obs).sum() + 1) / (n_permutations + 1))


def sparse_add_pseudocount(mtx, pseudocount: float = 1.0):
    """Add a pseudocount to the stored values of a sparse matrix
    (parity: regression_utils.py sparse_add_pseudocount)."""
    out = mtx.copy()
    out.data = out.data + pseudocount
    return out


def sparse_element_by_element(a, b):
    """Elementwise product of sparse matrices (parity:
    regression_utils.py sparse_element_by_element)."""
    return a.multiply(b)


def sparse_minmax_scale(mtx):
    """Column min-max scaling of a sparse matrix (parity:
    regression_utils.py sparse_minmax_scale)."""
    from scipy.sparse import csr_matrix

    M = mtx.toarray() if hasattr(mtx, "toarray") else np.asarray(mtx, float)
    mn, mx = M.min(0, keepdims=True), M.max(0, keepdims=True)
    return csr_matrix((M - mn) / np.maximum(mx - mn, 1e-12))


def weighted_binary_crossentropy(y_true: np.ndarray, y_pred: np.ndarray, weight_0: float = 1.0, weight_1: float = 1.0) -> float:
    """Class-weighted BCE (parity: regression_utils.py
    weighted_binary_crossentropy)."""
    yt = np.asarray(y_true, float)
    yp = np.clip(np.asarray(y_pred, float), 1e-7, 1 - 1e-7)
    return float(-(weight_1 * yt * np.log(yp) + weight_0 * (1 - yt) * np.log(1 - yp)).mean())
