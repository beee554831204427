"""scikit-learn's `GaussianMixture` (1.9) ported step for step, in float64 on
a device: the k-means responsibilities of ``init_params="kmeans"`` (through
`ops.kmeans.KMeans(n_init=1)` on the mixture's ``RandomState``), then EM
with `GMM_REG_COVAR` added to each covariance's diagonal, the precisions'
Cholesky factors, and the mean log-likelihood as the lower bound, stopping
when it changes by less than `GMM_TOL` (one host read an iteration) or
after `GMM_MAX_ITER` iterations. The four covariance types are scikit-learn's.

The GPU machine has no scikit-learn; `tests/test_torch_cluster.py` holds this
against it (means, covariances and ``n_iter_``), and
`tests/test_torch_external.py` at ``n_init=3``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .kmeans import KMeans, check_random_state

COVARIANCE_TYPES = ("full", "tied", "diag", "spherical")
#: scikit-learn's defaults: the lower bound's stop, the covariances'
#: regularisation, and the EM's iterations.
GMM_TOL, GMM_REG_COVAR, GMM_MAX_ITER = 1e-3, 1e-6, 100


def _gaussian_parameters(X: torch.Tensor, resp: torch.Tensor, reg_covar: float, covariance_type: str):
    """(nk, means, covariances) of `resp` (scikit-learn's
    `_estimate_gaussian_parameters`)."""
    nk = resp.sum(0) + 10 * torch.finfo(resp.dtype).eps
    means = (resp.T @ X) / nk[:, None]
    d = X.shape[1]
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    if covariance_type == "full":
        cov = torch.stack([((resp[:, k] * (X - means[k]).T) @ (X - means[k])) / nk[k] for k in range(len(nk))])
        cov = cov + reg_covar * eye
    elif covariance_type == "tied":
        cov = (X.T @ X - (nk * means.T) @ means) / nk.sum() + reg_covar * eye
    else:
        cov = (resp.T @ (X * X)) / nk[:, None] - means**2 + reg_covar
        if covariance_type == "spherical":
            cov = cov.mean(1)
    return nk, means, cov


def _precision_cholesky(cov: torch.Tensor, covariance_type: str) -> torch.Tensor:
    """Upper factors of the precisions (scikit-learn's
    `_compute_precision_cholesky`): inv(chol(cov)).T, or 1/sqrt(cov)."""
    if covariance_type in ("full", "tied"):
        L = torch.linalg.cholesky(cov)
        eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device).expand_as(L)
        return torch.linalg.solve_triangular(L, eye, upper=False).transpose(-1, -2)
    return 1.0 / torch.sqrt(cov)


def _log_gaussian_prob(X: torch.Tensor, means: torch.Tensor, prec_chol: torch.Tensor, covariance_type: str):
    """[n, K] log N(x | mean_k, cov_k) (scikit-learn's
    `_estimate_log_gaussian_prob`)."""
    d = X.shape[1]
    if covariance_type == "full":
        log_det = torch.log(torch.diagonal(prec_chol, dim1=1, dim2=2)).sum(1)
        log_prob = torch.stack([((X @ P - means[k] @ P) ** 2).sum(1) for k, P in enumerate(prec_chol)], 1)
    elif covariance_type == "tied":
        log_det = torch.log(torch.diagonal(prec_chol)).sum()
        log_prob = torch.stack([((X @ prec_chol - means[k] @ prec_chol) ** 2).sum(1)
                                for k in range(len(means))], 1)
    elif covariance_type == "diag":
        log_det = torch.log(prec_chol).sum(1)
        prec = prec_chol**2
        log_prob = (means**2 * prec).sum(1) - 2.0 * (X @ (means * prec).T) + (X**2 @ prec.T)
    else:
        log_det = d * torch.log(prec_chol)
        prec = prec_chol**2
        log_prob = (means**2).sum(1) * prec - 2 * (X @ means.T * prec) + torch.outer((X * X).sum(1), prec)
    return -0.5 * (d * math.log(2 * math.pi) + log_prob) + log_det


class GaussianMixture:
    """``sklearn.mixture.GaussianMixture(n_components, covariance_type,
    random_state, n_init)`` (`tol` 1e-3, `reg_covar` 1e-6, `max_iter` 100,
    ``init_params="kmeans"``) on `device`, in float64. The inits share one
    ``RandomState``, which each init's k-means advances, and the init of the
    largest lower bound wins (the first on a tie), as in scikit-learn. `fit`
    sets ``weights_``, ``means_``, ``covariances_``,
    ``precisions_cholesky_``, ``converged_``, ``n_iter_`` and
    ``lower_bound_`` (host numpy); `predict` gives each point's most probable
    component, and `fit_predict` the same after `fit`."""

    def __init__(self, n_components: int = 1, covariance_type: str = "full", random_state: Optional[int] = None,
                 n_init: int = 1, device="cuda"):
        if covariance_type not in COVARIANCE_TYPES:
            raise ValueError(f"covariance_type must be one of {COVARIANCE_TYPES}, got {covariance_type!r}")
        self.n_components = n_components
        self.covariance_type = covariance_type
        self.random_state = random_state
        self.n_init = int(n_init)
        self.device = device

    def _weighted_log_prob(self, X: torch.Tensor) -> torch.Tensor:
        return _log_gaussian_prob(X, self._means, self._prec_chol, self.covariance_type) + torch.log(self._weights)

    def _set(self, weights, means, cov):
        self._weights, self._means, self._cov = weights, means, cov
        self._prec_chol = _precision_cholesky(cov, self.covariance_type)

    def _fit_one(self, X: np.ndarray, Xd: torch.Tensor, rs: np.random.RandomState):
        """One init's k-means start and EM: (lower bound, n_iter, converged)."""
        n = X.shape[0]
        labels = KMeans(self.n_components, n_init=1, random_state=rs, device=self.device).fit(X).labels_
        resp = torch.zeros((n, self.n_components), dtype=Xd.dtype, device=Xd.device)
        resp[torch.arange(n, device=Xd.device), torch.as_tensor(labels, dtype=torch.int64, device=Xd.device)] = 1
        nk, means, cov = _gaussian_parameters(Xd, resp, GMM_REG_COVAR, self.covariance_type)
        self._set(nk / n, means, cov)
        lower_bound = -np.inf
        n_iter = 0
        for n_iter in range(1, GMM_MAX_ITER + 1):
            prev = lower_bound
            wlp = self._weighted_log_prob(Xd)
            log_norm = torch.logsumexp(wlp, dim=1)
            log_resp = wlp - log_norm[:, None]
            weights, means, cov = _gaussian_parameters(Xd, torch.exp(log_resp), GMM_REG_COVAR, self.covariance_type)
            self._set(weights / weights.sum(), means, cov)
            lower_bound = float(log_norm.mean())
            if abs(lower_bound - prev) < GMM_TOL:
                return lower_bound, n_iter, True
        return lower_bound, n_iter, False

    def fit(self, X) -> "GaussianMixture":
        X = np.asarray(X, dtype=np.float64)
        if X.shape[0] < self.n_components:
            raise ValueError(f"Expected n_samples >= n_components but got n_components = {self.n_components}, "
                             f"n_samples = {X.shape[0]}")
        rs = check_random_state(self.random_state)
        Xd = torch.as_tensor(X, device=self.device)
        best = None
        for _ in range(self.n_init):
            lower_bound, n_iter, converged = self._fit_one(X, Xd, rs)
            if best is None or lower_bound > best[0]:
                best = (lower_bound, n_iter, converged, (self._weights, self._means, self._cov))
        self.lower_bound_, self.n_iter_, self.converged_, params = best
        self._set(*params)
        self.weights_ = self._weights.cpu().numpy()
        self.means_ = self._means.cpu().numpy()
        self.covariances_ = self._cov.cpu().numpy()
        self.precisions_cholesky_ = self._prec_chol.cpu().numpy()
        return self

    def fit_predict(self, X) -> np.ndarray:
        return self.fit(X).predict(X)

    def predict(self, X) -> np.ndarray:
        Xd = torch.as_tensor(np.asarray(X, dtype=np.float64), device=self.device)
        return self._weighted_log_prob(Xd).argmax(1).cpu().numpy()
