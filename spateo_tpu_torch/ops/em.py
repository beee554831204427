"""Negative-binomial mixture EM, batched, on the device.

Counterpart of `spateo_tpu.ops.em`: B independent 2-component NB mixtures
fit at once in the lambda/theta parameterisation, each row frozen at its own
convergence, an invalid step (NaN, Inf, r <= 0, theta or w outside [0, 1])
reverting that row to its previous parameters.

`torch.lgamma` and `torch.digamma` differ from XLA's at the ulp level, so
fitted parameters agree with the JAX package's to about 1e-4 relative, not
bit for bit.

`run_em` fits every density bin in one batched call, after drawing each
bin's weighted downsample with numpy's `default_rng(seed).choice` in the
JAX package's order, so the samples are the same values.

With ``rowwise=True`` a row's sums over its samples are taken row by row
(`_row_sums`): CUDA picks a reduction's tree by the number of outputs, so
one [B, 2, S] sum adds a row's terms in another order than a [1, 2, S] sum.
Fitting tiles together (`starro_em_bp_stream(em_batch > 1)`) thus gives each
tile exactly its own fit, for 3 B more launches an iteration (B sums and
a stack in place of one sum, three times).

The loop is a Python loop of about 30 small operations per iteration. Where
the JAX package tested "all rows done" on the device every iteration, this
one reads that flag back to the host every `_DONE_CHECK_EVERY` iterations
(a read is a device sync). Rows that are done keep their parameters, so the
extra iterations change nothing and the result is the same as checking
every iteration; the loop never runs past `max_iter`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.bridge import _to_device
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


def nbn_pmf(n, p, X, device="cuda") -> np.ndarray:
    """NB pmf, a host array."""
    return _conditional(_to_device(np.asarray(X, np.float32), device), n, p).cpu().numpy()


def _row_sums(x: torch.Tensor, rowwise: bool = False) -> torch.Tensor:
    """[B, 2, S] -> [B, 2]: the sum over samples; with `rowwise`, each row
    reduced on its own, so that its order of addition is that of B = 1."""
    if x.shape[0] == 1 or not rowwise:
        return torch.sum(x, dim=2)
    return torch.stack([torch.sum(x[b], dim=1) for b in range(x.shape[0])])


def _nbn_em_batched(
    X: torch.Tensor,  # [B, S] padded samples
    mask: torch.Tensor,  # [B, S] True for real samples
    w0: torch.Tensor,  # [B, 2]
    mu0: torch.Tensor,  # [B, 2]
    var0: torch.Tensor,  # [B, 2]
    max_iter: int = 2000,
    precision: float = 1e-6,
    stats: Optional[dict] = None,
    rowwise: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit B independent 2-component NB mixtures at once (each row's sums on
    their own with `rowwise`).

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

        tau_sum = _row_sums(tau, rowwise)  # [B,2]
        w_new = tau_sum / torch.sum(tau_sum, dim=1, keepdim=True)
        td = _row_sums(tau * delta, rowwise)  # [B,2]
        lam_new = td / tau_sum
        denom = _row_sums(tau * (Xs - (1.0 - beta)[:, :, None] * delta), rowwise)
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


def _host(X) -> np.ndarray:
    return X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)


def _split_by_bin(X: np.ndarray, bins: np.ndarray) -> Dict[int, np.ndarray]:
    """{bin label > 0: X[bins == label]} (row-major order) from one stable
    sort of the labels, not one full-raster comparison a bin."""
    flat = np.asarray(bins).ravel()
    order = np.argsort(flat, kind="stable")
    labels, starts = np.unique(flat[order], return_index=True)
    xs = np.asarray(X).ravel()[order]
    ends = list(starts[1:]) + [flat.size]
    return {int(lab): xs[lo:hi] for lab, lo, hi in zip(labels, starts, ends) if lab > 0}


def _bin_samples(X: np.ndarray, bins: Optional[np.ndarray], params) -> Dict[int, np.ndarray]:
    """{bin label > 0: its pixels in row-major order}, or {0: all pixels},
    checking that each bin's `params` has exactly w, mu, var."""
    samples = {}
    if bins is not None:
        samples = _split_by_bin(X, bins)
        for label in samples:
            if set(params.get(label, params).keys()) != {"w", "mu", "var"}:
                raise SegmentationError("`params` must contain exactly the keys `w`, `mu`, `var`.")
    else:
        samples[0] = X.ravel()
        if set(params.keys()) != {"w", "mu", "var"}:
            raise SegmentationError("`params` must contain exactly the keys `w`, `mu`, `var`.")
    return samples


def run_em(
    X,
    downsample: Union[int, float] = 0.001,
    params: Union[Dict[str, Tuple[float, float]], Dict[int, Dict[str, Tuple[float, float]]]] = dict(
        w=(0.5, 0.5), mu=(10.0, 300.0), var=(20.0, 400.0)
    ),
    max_iter: int = 2000,
    precision: float = 1e-6,
    bins=None,
    seed: Optional[int] = None,
    device="cuda",
) -> Union[Tuple, Dict[int, Tuple]]:
    """Downsample-weighted NB-mixture EM over the raster, per density bin,
    every bin in one `_nbn_em_batched` call on `device`. Returns
    ``(w, r, theta)`` tuples, or with `bins` a dict of them by bin label."""
    X = _host(X)
    bins = None if bins is None else _host(bins)
    samples = _bin_samples(X, bins, params)
    downsample_scale = downsample <= 1
    rng = np.random.default_rng(seed)
    total = sum(len(s) for s in samples.values())
    final = {}
    for label, _samples in samples.items():
        n_target = int(len(_samples) * downsample) if downsample_scale else int(downsample * (len(_samples) / total))
        if len(_samples) > n_target:
            weights = np.log1p(_samples + 1)
            _samples = rng.choice(_samples, n_target, replace=False, p=weights / weights.sum())
        final[label] = np.asarray(_samples, dtype=np.float32)

    labels = list(final)
    S, B = max(len(v) for v in final.values()), len(labels)
    Xb = np.zeros((B, S), np.float32)
    maskb = np.zeros((B, S), bool)
    w0, mu0, var0 = (np.zeros((B, 2), np.float32) for _ in range(3))
    for i, label in enumerate(labels):
        v = final[label]
        Xb[i, : len(v)] = v
        maskb[i, : len(v)] = True
        p = params.get(label, params)
        w0[i], mu0[i], var0[i] = p["w"], p["mu"], p["var"]
    w, r, theta = (
        t.cpu().numpy()
        for t in _nbn_em_batched(*(_to_device(a, device) for a in (Xb, maskb, w0, mu0, var0)), max_iter=max_iter,
                                 precision=precision)
    )
    results = {label: (tuple(w[i]), tuple(r[i]), tuple(theta[i])) for i, label in enumerate(labels)}
    return results if bins is not None else results[0]


def _tensors(X, bins, device):
    """(X as f32 and bins as tensors, whether X came from the host): a host
    array goes to `device`, a tensor stays where it is."""
    host = not isinstance(X, torch.Tensor)
    X = _to_device(np.asarray(X, np.float32), device) if host else X.to(torch.float32)
    if bins is not None and not isinstance(bins, torch.Tensor):
        bins = _to_device(np.asarray(bins), X.device)
    return X, bins, host


def conditionals(X, em_results, bins=None, device="cuda"):
    """Per-pixel P(observed UMI | background) and P(observed UMI | cell).
    `em_results` is ``(w, r, theta)``, or with `bins` a dict ``{bin label:
    (w, r, theta)}``. A tensor `X` gives tensors on its device (for chaining
    stages); a host array gives host arrays, computed on `device`."""
    X, bins, host = _tensors(X, bins, device)
    if isinstance(em_results, dict):
        if bins is None:
            raise SegmentationError("`em_results` indicate binning was used, but `bins` was not provided")
        background_cond = torch.ones_like(X)
        cell_cond = torch.zeros_like(X)
        for label, (_, r, p) in em_results.items():
            m = bins == label
            background_cond = torch.where(m, _conditional(X, r[0], p[0]), background_cond)
            cell_cond = torch.where(m, _conditional(X, r[1], p[1]), cell_cond)
    else:
        _, r, p = em_results
        background_cond, cell_cond = _conditional(X, r[0], p[0]), _conditional(X, r[1], p[1])
    return (background_cond.cpu().numpy(), cell_cond.cpu().numpy()) if host else (background_cond, cell_cond)


def _conditional(X: torch.Tensor, r, p) -> torch.Tensor:
    r = torch.as_tensor(r, dtype=torch.float32, device=X.device)
    p = torch.as_tensor(p, dtype=torch.float32, device=X.device)
    return torch.exp(nb_logpmf(X, r, p))


def confidence(X, em_results, bins=None, device="cuda"):
    """Posterior P(cell | UMI) per pixel, w1 c1 / (w0 c0 + w1 c1); outside
    the bins (with `bins`) 0 / 0, NaN, as in the JAX package. Tensor in,
    tensor out; host array in, host array out."""
    X, bins, host = _tensors(X, bins, device)
    bg, cell = conditionals(X, em_results, bins)
    if isinstance(em_results, dict):
        tau0 = torch.zeros_like(bg)
        tau1 = torch.zeros_like(cell)
        for label, (w, _, _) in em_results.items():
            m = bins == label
            tau0 = torch.where(m, float(w[0]) * bg, tau0)
            tau1 = torch.where(m, float(w[1]) * cell, tau1)
    else:
        w = em_results[0]
        tau0, tau1 = float(w[0]) * bg, float(w[1]) * cell
    out = tau1 / (tau0 + tau1)
    return out.cpu().numpy() if host else out
