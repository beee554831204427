"""Model morphology metrics (capability parity: reference
spateo/tdr/morphometrics/morphology.py:11,74). The counterpart of
`spateo_tpu.tdr.morphometrics.morphology`: `model_morphology` is its host
code, and `pc_KDE` computes what the JAX package asks scikit-learn's
`KernelDensity(kernel, bandwidth).score_samples` for, at its exact defaults
(atol = rtol = 0), on `device` (default ``"cuda"``) without scikit-learn:
``log sum_j K(|x_i - x_j| / h) - log N + log(norm)`` in float64, by a
log-sum-exp over row chunks of the distance matrix, with scikit-learn's six
kernels and their normalisations."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import math

import numpy as np
import torch

from ...core.bridge import _to_device
from ...logging import logger_manager as lm
from ..models.mesh_core import Mesh, PointCloud


def model_morphology(model: Union[Mesh, PointCloud], pc: Optional[PointCloud] = None) -> Dict[str, Any]:
    """Length/width/height, surface area, volume, V/SA ratio, cell density
    (parity: morphology.py:11)."""
    morphology: Dict[str, Any] = {}
    b = model.bounds
    morphology["Length(x)"] = round(abs(b[1] - b[0]), 5)
    morphology["Width(y)"] = round(abs(b[3] - b[2]), 5)
    morphology["Height(z)"] = round(abs(b[5] - b[4]), 5) if len(b) >= 6 else 0.0
    if isinstance(model, Mesh):
        morphology["Surface_area"] = round(model.area, 5)
        morphology["Volume"] = round(model.volume, 5)
        morphology["V/SA_ratio"] = round(morphology["Volume"] / max(morphology["Surface_area"], 1e-12), 5)
        if pc is not None:
            morphology["cell_density"] = round(pc.n_points / max(morphology["Volume"], 1e-12), 5)
    for k, v in morphology.items():
        lm.main_info(f"{k} of model: {v};")
    return morphology


#: Elements of the [rows, N] float64 distance block `pc_KDE` computes at once.
KDE_ELEMS = 1 << 25
KDE_KERNELS = ("gaussian", "tophat", "epanechnikov", "exponential", "linear", "cosine")


def _log_vn(n: int) -> float:
    return 0.5 * n * math.log(math.pi) - math.lgamma(0.5 * n + 1)


def _log_sn(n: int) -> float:
    return math.log(2 * math.pi) + _log_vn(n - 1)


def _log_kernel_norm(h: float, d: int, kernel: str) -> float:
    """scikit-learn's `_log_kernel_norm` (neighbors/_binary_tree.pxi.tp)."""
    if kernel == "gaussian":
        factor = 0.5 * d * math.log(2 * math.pi)
    elif kernel == "tophat":
        factor = _log_vn(d)
    elif kernel == "epanechnikov":
        factor = _log_vn(d) + math.log(2.0 / (d + 2.0))
    elif kernel == "exponential":
        factor = _log_sn(d - 1) + math.lgamma(d)
    elif kernel == "linear":
        factor = _log_vn(d) - math.log(d + 1.0)
    else:  # cosine, from a chain rule integration
        factor, tmp = 0.0, 2.0 / math.pi
        for k in range(1, d + 1, 2):
            factor += tmp
            tmp *= -(d - k) * (d - k - 1) * (2.0 / math.pi) ** 2
        factor = math.log(factor) + _log_sn(d - 1)
    return -factor - d * math.log(h)


def _log_kernel(dist: torch.Tensor, h: float, kernel: str) -> torch.Tensor:
    """scikit-learn's unnormalised log kernels; -inf at and beyond h for
    the compact ones."""
    if kernel == "gaussian":
        return -0.5 * (dist * dist) / (h * h)
    if kernel == "exponential":
        return -dist / h
    inside = dist < h
    if kernel == "tophat":
        val = torch.zeros_like(dist)
    elif kernel == "epanechnikov":
        val = torch.log(1.0 - (dist * dist) / (h * h))
    elif kernel == "linear":
        val = torch.log(1 - dist / h)
    else:
        val = torch.log(torch.cos(0.5 * math.pi * dist / h))
    return torch.where(inside, val, -math.inf)


def kde_log_density(X: np.ndarray, kernel: str = "gaussian", bandwidth: float = 1.0, device="cuda") -> np.ndarray:
    """`KernelDensity(kernel=kernel, bandwidth=bandwidth).fit(X)
    .score_samples(X)`: the log density of each point of X, float64."""
    if kernel not in KDE_KERNELS:
        raise ValueError(f"kernel must be one of {KDE_KERNELS}, got {kernel!r}")
    h = float(bandwidth)
    if not h > 0:
        raise ValueError(f"bandwidth must be > 0, got {bandwidth!r}")
    X = np.asarray(X, dtype=np.float64)
    N, D = X.shape
    Xd = _to_device(X, device)
    rows = max(1, KDE_ELEMS // N)
    out = []
    for Xc in Xd.split(rows):
        d2 = (Xc[:, None, 0] - Xd[None, :, 0]) ** 2
        for d in range(1, D):
            d2 = d2 + (Xc[:, None, d] - Xd[None, :, d]) ** 2
        out.append(torch.logsumexp(_log_kernel(torch.sqrt(d2), h, kernel), dim=1))
    log_dens = torch.cat(out).cpu().numpy()
    return log_dens + _log_kernel_norm(h, D, kernel) - np.log(N)


def pc_KDE(
    pc: PointCloud,
    key_added: str = "kde",
    kernel: str = "gaussian",
    bandwidth: float = 1.0,
    colormap: Union[str, list, dict] = "hot_r",
    alphamap: Union[float, list, dict] = 1.0,
    inplace: bool = False,
    device="cuda",
) -> Tuple[Optional[PointCloud], Optional[str]]:
    """Kernel density of a 3D point cloud (parity: morphology.py:74)."""
    pc_out = pc if inplace else pc.copy()
    dens = np.exp(kde_log_density(np.asarray(pc_out.points), kernel, bandwidth, device))
    pc_out[key_added] = dens
    return (None if inplace else pc_out), None
