"""Negative-binomial mixture EM, batched, on the device.

Counterpart of `spateo_tpu.ops.em`: B independent 2-component NB mixtures
fit at once in the lambda/theta parameterisation, each row frozen at its own
convergence, an invalid step (NaN, Inf, r <= 0, theta or w outside [0, 1])
reverting that row to its previous parameters.

`torch.lgamma` and `torch.digamma` differ from XLA's at the ulp level, so
fitted parameters agree with the JAX package's to about 1e-4 relative, not
bit for bit.

The loop is a Python loop of about 30 small operations per iteration. Where
the JAX package tested "all rows done" on the device every iteration, this
one reads that flag back to the host every `_DONE_CHECK_EVERY` iterations
(a read is a device sync). Rows that are done keep their parameters, so the
extra iterations change nothing and the result is the same as checking
every iteration; the loop never runs past `max_iter`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..errors import SegmentationError

_DONE_CHECK_EVERY = 16


def lamtheta_to_r(lam, theta):
    return -lam / torch.log(theta)


def muvar_to_lamtheta(mu, var):
    r = mu**2 / (var - mu)
    theta = mu / var
    lam = -r * torch.log(theta)
    return lam, theta


def lamtheta_to_muvar(lam, theta):
    r = lamtheta_to_r(lam, theta)
    mu = r / theta - r
    var = mu + mu**2 / r
    return mu, var


def nb_logpmf(x, r, p):
    """log NB pmf with scipy's (n, p) convention: support k successes with
    failure prob 1-p."""
    return torch.lgamma(x + r) - torch.lgamma(r) - torch.lgamma(x + 1.0) + r * torch.log(p) + x * torch.log1p(-p)


def _nbn_em_batched(
    X: torch.Tensor,  # [B, S] padded samples
    mask: torch.Tensor,  # [B, S] True for real samples
    w0: torch.Tensor,  # [B, 2]
    mu0: torch.Tensor,  # [B, 2]
    var0: torch.Tensor,  # [B, 2]
    max_iter: int = 2000,
    precision: float = 1e-6,
    stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit B independent 2-component NB mixtures at once.

    Returns (w, r, theta), each [B, 2] f32. If `stats` is given, it receives
    ``n_iter``: the number of EM steps the slowest row took before it
    converged or froze."""
    X = X.to(torch.float32)
    maskf = mask.to(torch.float32)
    lam, theta = muvar_to_lamtheta(mu0.to(torch.float32), var0.to(torch.float32))
    w = w0.to(torch.float32)
    Xs = X[:, None, :]

    def em_step(w, lam, theta):
        r = lamtheta_to_r(lam, theta)  # [B,2]
        # E-step: responsibilities tau [B,2,S]
        logpmf = nb_logpmf(Xs, r[:, :, None], theta[:, :, None])
        tau = w[:, :, None] * torch.exp(logpmf)
        tau = torch.clamp(tau, 1e-10, 1e10)
        tau = tau / torch.sum(tau, dim=1, keepdim=True)
        tau = tau * maskf[:, None, :]

        beta = 1.0 - 1.0 / (1.0 - theta) - 1.0 / torch.log(theta)  # [B,2]
        delta = r[:, :, None] * (torch.digamma(r[:, :, None] + Xs) - torch.digamma(r[:, :, None]))  # [B,2,S]

        tau_sum = torch.sum(tau, dim=2)  # [B,2]
        w_new = tau_sum / torch.sum(tau_sum, dim=1, keepdim=True)
        td = torch.sum(tau * delta, dim=2)  # [B,2]
        lam_new = td / tau_sum
        denom = torch.sum(tau * (Xs - (1.0 - beta)[:, :, None] * delta), dim=2)
        theta_new = beta * td / denom
        return w_new, lam_new, theta_new

    done = torch.zeros(X.shape[0], dtype=torch.bool, device=X.device)
    n_iter = torch.zeros(X.shape[0], dtype=torch.int32, device=X.device) if stats is not None else None
    for i in range(max_iter):
        if i % _DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        w_new, lam_new, theta_new = em_step(w, lam, theta)
        r_new = lamtheta_to_r(lam_new, theta_new)
        invalid = (
            torch.any(torch.isnan(r_new) | torch.isnan(w_new) | torch.isnan(theta_new), dim=1)
            | torch.any(torch.isinf(r_new) | torch.isinf(w_new) | torch.isinf(theta_new), dim=1)
            | torch.any((r_new <= 0) | (theta_new > 1) | (theta_new < 0) | (w_new < 0) | (w_new > 1), dim=1)
        )  # [B]
        delta_max = torch.maximum(
            torch.amax(torch.abs(w_new - w), dim=1),
            torch.maximum(torch.amax(torch.abs(lam_new - lam), dim=1), torch.amax(torch.abs(theta_new - theta), dim=1)),
        )
        converged = delta_max < precision
        if n_iter is not None:
            n_iter += (~done).to(torch.int32)
        # frozen rows (done, or an invalid step) keep their previous params
        keep_prev = (done | invalid)[:, None]
        w = torch.where(keep_prev, w, w_new)
        lam = torch.where(keep_prev, lam, lam_new)
        theta = torch.where(keep_prev, theta, theta_new)
        done = done | invalid | converged
    if stats is not None:
        stats["n_iter"] = int(n_iter.max()) if n_iter.numel() else 0
    return w, lamtheta_to_r(lam, theta), theta


def nbn_em(
    X: np.ndarray,
    w: Tuple[float, float] = (0.99, 0.01),
    mu: Tuple[float, float] = (10.0, 300.0),
    var: Tuple[float, float] = (20.0, 400.0),
    max_iter: int = 2000,
    precision: float = 1e-3,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Single-population NB mixture EM on `device`; returns host arrays
    (w, r, theta), each of length 2."""
    Xd = torch.as_tensor(np.asarray(X, dtype=np.float32).ravel(), device=device)[None, :]
    params = [torch.tensor([v], dtype=torch.float32, device=device) for v in (w, mu, var)]
    w_, r_, p_ = _nbn_em_batched(Xd, torch.ones_like(Xd, dtype=torch.bool), *params, max_iter=max_iter, precision=precision)
    return w_[0].cpu().numpy(), r_[0].cpu().numpy(), p_[0].cpu().numpy()


def conditionals(
    X: torch.Tensor,
    em_results,
    bins: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel P(observed UMI | background) and P(observed UMI | cell), on
    X's device. `em_results` is ``(w, r, theta)``, or with `bins` a dict
    ``{bin label: (w, r, theta)}``."""
    X = X.to(torch.float32)
    if isinstance(em_results, dict):
        if bins is None:
            raise SegmentationError("`em_results` indicate binning was used, but `bins` was not provided")
        background_cond = torch.ones_like(X)
        cell_cond = torch.zeros_like(X)
        for label, (_, r, p) in em_results.items():
            m = bins == label
            background_cond = torch.where(m, _conditional(X, r[0], p[0]), background_cond)
            cell_cond = torch.where(m, _conditional(X, r[1], p[1]), cell_cond)
        return background_cond, cell_cond
    _, r, p = em_results
    return _conditional(X, r[0], p[0]), _conditional(X, r[1], p[1])


def _conditional(X: torch.Tensor, r, p) -> torch.Tensor:
    r = torch.as_tensor(r, dtype=torch.float32, device=X.device)
    p = torch.as_tensor(p, dtype=torch.float32, device=X.device)
    return torch.exp(nb_logpmf(X, r, p))
