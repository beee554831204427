"""Gaussian-process (sparse inducing-point) interpolation
(capability parity: reference spateo/tdr/interpolations/interpolation_gp.py:179;
counterpart of `spateo_tpu.tdr.interpolations.interpolation_gp`): Titsias'
collapsed SGPR bound with an RBF kernel, its hyperparameters and inducing
points (`SGPRParams`, an `nn.Module`) fitted by autograd and
``torch.optim.Adam(lr=0.05)`` on a device.

The bound and the prediction run in float64, where the JAX package runs
float32: with its default 512 inducing points spread through a 3D tissue
(the E9.5 cloud of `chip_smoke.py`'s phase 26) the inducing kernel's
rounding in float32 exceeds its 1e-6 jitter, the Cholesky factor fails, and
the JAX package's fit is NaN from its first step (ROADMAP Queue 3). Where
float32 holds, the two agree to float32's rounding (`tests/
test_torch_interpolation.py`).

`sgpr_train` runs all `n_epochs` steps with no host read (Cholesky through
`cholesky_ex`, whose status is not read) and returns the losses on the
device; `_fit_sgpr` reads them once after the loop (`_fit_sgpr.host_reads`).
The inducing points start at the same host ``default_rng(0)`` draw of the
source cells as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import pandas as pd
import torch
from torch import nn

from ...core.anndata import AnnData
from ...core.bridge import _to_device
from ...logging import logger_manager as lm


def _rbf(x: torch.Tensor, y: torch.Tensor, lengthscale: torch.Tensor) -> torch.Tensor:
    d2 = (x**2).sum(1)[:, None] + (y**2).sum(1)[None, :] - 2 * (x @ y.T)
    return torch.exp(-0.5 * torch.clamp(d2, min=0) / lengthscale**2)


class SGPRParams(nn.Module):
    """The SGPR's parameters: log lengthscale (0), log noise (-2), log
    amplitude (0) and the inducing points `Z` [M, D], the JAX package's
    initial values, in float64."""

    def __init__(self, Z0, device="cuda"):
        super().__init__()
        Z0 = _to_device(Z0, device, torch.float64)
        self.log_ls = nn.Parameter(torch.zeros((), dtype=torch.float64, device=Z0.device))
        self.log_noise = nn.Parameter(torch.full((), -2.0, dtype=torch.float64, device=Z0.device))
        self.log_amp = nn.Parameter(torch.zeros((), dtype=torch.float64, device=Z0.device))
        self.Z = nn.Parameter(Z0.clone())

    def terms(self):
        """(lengthscale, noise, amplitude) as used by the bound."""
        return torch.exp(self.log_ls), torch.exp(self.log_noise) + 1e-6, torch.exp(self.log_amp)


def sgpr_neg_mll(params: SGPRParams, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """The collapsed SGPR bound's negative (per output dimension, summed),
    the JAX package's `neg_mll`."""
    ls, noise, amp = params.terms()
    N, M, D = X.shape[0], params.Z.shape[0], Y.shape[1]
    eye = torch.eye(M, dtype=X.dtype, device=X.device)
    Kuf = amp * _rbf(params.Z, X, ls)
    Kuu = amp * _rbf(params.Z, params.Z, ls) + 1e-6 * eye
    L = torch.linalg.cholesky_ex(Kuu).L
    A = torch.linalg.solve_triangular(L, Kuf, upper=False) / torch.sqrt(noise)
    B = A @ A.T + eye
    LB = torch.linalg.cholesky_ex(B).L
    AY = A @ Y / torch.sqrt(noise)
    c = torch.linalg.solve_triangular(LB, AY, upper=False)
    logdet = 2 * torch.log(torch.diagonal(LB)).sum() + N * torch.log(noise)
    quad = (Y * Y).sum() / noise - (c * c).sum()
    trace_term = (amp * N - (A * A).sum() * noise) / noise
    return 0.5 * (D * logdet + quad + D * trace_term)


def sgpr_train(params: SGPRParams, X: torch.Tensor, Y: torch.Tensor, n_epochs: int = 200,
               lr: float = 0.05) -> torch.Tensor:
    """`n_epochs` Adam steps on the bound, with no host read: the [n_epochs]
    losses (each at the parameters before its step) on the device."""
    opt = torch.optim.Adam(params.parameters(), lr=lr)
    losses = torch.empty(n_epochs, dtype=X.dtype, device=X.device)
    for i in range(n_epochs):
        opt.zero_grad(set_to_none=True)
        loss = sgpr_neg_mll(params, X, Y)
        loss.backward()
        opt.step()
        losses[i] = loss.detach()
    return losses


def _fit_sgpr(X, Y, Z0, n_epochs: int = 200, lr: float = 0.05, device="cuda"):
    """Fit the SGPR from the inducing points `Z0` on `device` in float64:
    (params, host losses), read once."""
    Xd, Yd = _to_device(X, device, torch.float64), _to_device(Y, device, torch.float64)
    params = SGPRParams(Z0, device=device)
    losses = sgpr_train(params, Xd, Yd, n_epochs=n_epochs, lr=lr)
    _fit_sgpr.host_reads += 1
    return params, losses.cpu().numpy()


_fit_sgpr.host_reads = 0


@torch.no_grad()
def _sgpr_predict(params: SGPRParams, X: torch.Tensor, Y: torch.Tensor, Xnew: torch.Tensor) -> torch.Tensor:
    """The SGPR's predictive mean at `Xnew` (the JAX package's
    `_sgpr_predict`), on the device of the parameters."""
    ls, noise, amp = params.terms()
    Z = params.Z
    M = Z.shape[0]
    Kuf = amp * _rbf(Z, X, ls)
    Kuu = amp * _rbf(Z, Z, ls) + 1e-6 * torch.eye(M, dtype=Z.dtype, device=Z.device)
    Sigma = Kuu + Kuf @ Kuf.T / noise
    mu_u = Kuu @ torch.linalg.solve(Sigma, Kuf @ Y) / noise
    Ksu = amp * _rbf(Xnew, Z, ls)
    return Ksu @ torch.linalg.solve(Kuu, mu_u)


def gp_interpolation(
    source_adata: AnnData,
    target_points: Optional[np.ndarray] = None,
    keys: Union[str, list, None] = None,
    spatial_key: str = "spatial",
    layer: str = "X",
    training_iter: int = 50,
    device="cuda",
    method: str = "SVGP",
    batch_size: int = 1024,
    shuffle: bool = True,
    inducing_num: int = 512,
) -> AnnData:
    """Sparse-GP interpolation of expression onto target points on `device`
    (parity: interpolation_gp.py:179): coordinates and values standardised,
    `inducing_num` inducing points, `training_iter` Adam steps."""
    from scipy.sparse import issparse

    X = np.asarray(source_adata.obsm[spatial_key], dtype=np.float32)
    keys = [keys] if isinstance(keys, str) else (list(keys) if keys else list(source_adata.var_names[:1]))
    V = source_adata[:, np.asarray(keys)].X if layer == "X" else source_adata[:, np.asarray(keys)].layers[layer]
    Y = (V.toarray() if issparse(V) else np.asarray(V)).astype(np.float32)

    x_mean, x_std = X.mean(0), X.std(0) + 1e-8
    y_mean, y_std = Y.mean(0), Y.std(0) + 1e-8
    Xn = (X - x_mean) / x_std
    Yn = (Y - y_mean) / y_std

    rng = np.random.default_rng(0)
    Z0 = Xn[rng.choice(len(Xn), min(inducing_num, len(Xn)), replace=False)]
    params, losses = _fit_sgpr(Xn, Yn, Z0, n_epochs=training_iter, device=device)
    lm.main_info(f"SGPR trained: nll {float(losses[0]):.1f} -> {float(losses[-1]):.1f}")

    target_points = np.asarray(target_points, dtype=np.float32)
    Tn = (target_points - x_mean) / x_std
    pred = _sgpr_predict(params, *(_to_device(a, device, torch.float64) for a in (Xn, Yn, Tn))).cpu().numpy()
    pred = (pred * y_std + y_mean).astype(np.float32)

    interp_adata = AnnData(
        X=pred,
        obs=pd.DataFrame(index=[f"target_{i}" for i in range(len(target_points))]),
        var=pd.DataFrame(index=keys),
    )
    interp_adata.obsm[spatial_key] = target_points
    interp_adata.uns["__type"] = "UMI"
    return interp_adata


class Imputation_GPR:
    """GP-regression imputation class (parity surface: reference
    interpolation_gp.py:24 Imputation_GPR / gpytorch SVGP), realized by the
    collapsed-bound SGPR of this module."""

    def __init__(self, source_adata, target_points=None, keys=None, spatial_key: str = "spatial", layer: str = "X",
                 **kwargs):
        self.source_adata = source_adata
        self.target_points = target_points
        self.keys = keys
        self.spatial_key = spatial_key
        self.layer = layer
        self.kwargs = kwargs

    def train(self, method: str = "SVGP", **kwargs):
        return self  # the SGPR trains inside `inference`

    def interpolate(self, use_chunk: bool = False, chunk_num: int = 20, target_points=None):
        """Predict at the target points (parity signature: reference
        interpolation_gp.py:149); training runs in the same call, so
        interpolate == inference."""
        return self.inference(target_points=target_points)

    def inference(self, training_iter: int = 50, verbose: bool = True, target_points=None):
        """Fit + impute (parity signature: reference interpolation_gp.py:115)."""
        tp = target_points if target_points is not None else self.target_points
        kwargs = dict(self.kwargs)
        kwargs.setdefault("training_iter", training_iter)
        return gp_interpolation(
            source_adata=self.source_adata,
            target_points=tp,
            keys=self.keys,
            spatial_key=self.spatial_key,
            layer=self.layer,
            **kwargs,
        )
