"""2D coarse slice pre-alignment (capability parity: reference
spateo/tools/coarse_align.py:20-260).

A copy of `spateo_tpu.tools.coarse_align` (host numpy): its SVDs and
eigendecompositions are 2x2 or 3x3, where a device launch costs more than
the work."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.anndata import AnnData
from ..logging import logger_manager as lm


def procrustes(X: np.ndarray, Y: np.ndarray, scaling: bool = True, reflection: str = "best") -> Tuple[float, np.ndarray, dict]:
    """MATLAB-style Procrustes: map Y onto X with translation, rotation and
    optional scaling/reflection (parity: coarse_align.py:20)."""
    X = np.asarray(X, dtype=float)
    Y = np.asarray(Y, dtype=float)
    n, m = X.shape
    ny, my = Y.shape
    muX, muY = X.mean(0), Y.mean(0)
    X0, Y0 = X - muX, Y - muY
    ssX = (X0**2).sum()
    ssY = (Y0**2).sum()
    normX, normY = np.sqrt(ssX), np.sqrt(ssY)
    X0 /= normX
    Y0 /= normY
    if my < m:
        Y0 = np.concatenate((Y0, np.zeros((n, m - my))), 1)
    A = X0.T @ Y0
    U, s, Vt = np.linalg.svd(A, full_matrices=False)
    V = Vt.T
    T = V @ U.T
    if reflection != "best":
        have_reflection = np.linalg.det(T) < 0
        if bool(reflection) != have_reflection:
            V[:, -1] *= -1
            s[-1] *= -1
            T = V @ U.T
    traceTA = s.sum()
    if scaling:
        b = traceTA * normX / normY
        d = 1 - traceTA**2
        Z = normX * traceTA * (Y0 @ T) + muX
    else:
        b = 1
        d = 1 + ssY / ssX - 2 * traceTA * normY / normX
        Z = normY * (Y0 @ T) + muX
    if my < m:
        T = T[:my, :]
    c = muX - b * (muY @ T)
    return d, Z, {"rotation": T, "scale": b, "translation": c}


def AffineTrans(
    x: np.ndarray,
    y: np.ndarray,
    centroid_x: float,
    centroid_y: float,
    theta: Optional[float] = None,
    R: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Translation-to-centroid + rotation transform matrices (parity:
    coarse_align.py:121). Returns (T_t, T_r, points_transformed?) as the
    homogeneous translation and rotation matrices."""
    T_t = np.array([[1, 0, -centroid_x], [0, 1, -centroid_y], [0, 0, 1]], dtype=float)
    if R is None:
        R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    T_r = np.eye(3)
    T_r[:2, :2] = R
    pts = np.c_[x, y, np.ones(len(x))]
    out = (T_r @ (T_t @ pts.T)).T
    return T_t, T_r, out[:, :2]


def pca_align(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate a point set so its principal axes align with the coordinate
    axes (parity: coarse_align.py:174). Returns (Y, R)."""
    X = np.asarray(X, dtype=float)
    Xc = X - X.mean(0)
    cov = Xc.T @ Xc / len(X)
    evals, evecs = np.linalg.eigh(cov)
    order = np.argsort(-evals)
    R = evecs[:, order].T
    if np.linalg.det(R) < 0:
        R[-1] *= -1
    return Xc @ R.T + X.mean(0), R


def align_slices_pca(
    adata: AnnData,
    spatial_key: str = "spatial",
    inplace: bool = False,
    result_key: Optional[str] = None,
) -> Optional[AnnData]:
    """PCA-axis pre-alignment of a slice (parity: coarse_align.py:196)."""
    if not inplace:
        adata = adata.copy()
    coords = np.asarray(adata.obsm[spatial_key], dtype=float)[:, :2]
    aligned, R = pca_align(coords)
    adata.obsm[result_key or f"{spatial_key}_pca"] = aligned
    adata.uns["pca_align_R"] = R
    if not inplace:
        return adata
