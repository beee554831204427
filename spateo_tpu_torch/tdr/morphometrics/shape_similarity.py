"""Pairwise 3D shape similarity via subspace eigenvectors
(capability parity: reference spateo/tdr/morphometrics/shape_similarity.py:15-220).

A copy of `spateo_tpu.tdr.morphometrics.shape_similarity`."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ...logging import logger_manager as lm


def rough_subspace(pcs: np.ndarray, n: int = 20) -> list:
    """Split a point cloud into an n x n x n spatial grid of subspaces
    (parity: shape_similarity.py:15)."""
    pcs = np.asarray(pcs, dtype=float)
    mins, maxs = pcs.min(0), pcs.max(0)
    span = np.maximum(maxs - mins, 1e-12)
    idx = np.minimum(((pcs - mins) / span * n).astype(int), n - 1)
    key = idx[:, 0] * n * n + idx[:, 1] * n + idx[:, 2] if pcs.shape[1] == 3 else idx[:, 0] * n + idx[:, 1]
    out = []
    for u in np.unique(key):
        out.append(pcs[key == u])
    return out


def subspace_surface_fitting(pcs: np.ndarray, order: str = "linear") -> np.ndarray:
    """Least-squares polynomial surface z = f(x, y) per subspace (parity:
    shape_similarity.py:59). Returns the coefficient vector."""
    pcs = np.asarray(pcs, dtype=float)
    x, y = pcs[:, 0], pcs[:, 1]
    z = pcs[:, 2] if pcs.shape[1] == 3 else np.zeros(len(pcs))
    if order == "linear":
        A = np.c_[np.ones(len(x)), x, y]
    elif order == "quadratic":
        A = np.c_[np.ones(len(x)), x, y, x * y, x**2, y**2]
    else:  # cubic
        A = np.c_[np.ones(len(x)), x, y, x * y, x**2, y**2, x**2 * y, x * y**2, x**3, y**3]
    coef, *_ = np.linalg.lstsq(A, z, rcond=None)
    return coef


def dist_global_centroid_to_subspace(centroid: np.ndarray, pcs: np.ndarray) -> float:
    """Distance from the global centroid to a subspace centroid (parity:
    shape_similarity.py:113)."""
    return float(np.linalg.norm(np.asarray(centroid) - np.asarray(pcs).mean(0)))


def cos_global_centroid_to_subspace(global_centroid, subspace_pcs: np.ndarray) -> float:
    """|cos| of the angle between the centroid->subspace vector and the
    z-axis (parity: shape_similarity.py:123-133 — same formula:
    (subspace_z - global_z) / ||subspace_centroid - global_centroid||)."""
    global_centroid = np.asarray(global_centroid, float)
    subspace_centroid = np.asarray(subspace_pcs, float).mean(axis=0)
    denom = np.linalg.norm(subspace_centroid - global_centroid) + 1e-300
    return float(np.abs((subspace_centroid[-1] - global_centroid[-1]) / denom))


def calculate_eigenvector(vetorspaces: np.ndarray, m: int = 10, s: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Eigen decomposition of the subspace feature matrix (parity:
    shape_similarity.py:136)."""
    V = np.asarray(vetorspaces, dtype=float)
    V = V[np.isfinite(V).all(axis=1)]
    C = V.T @ V
    evals, evecs = np.linalg.eigh(C)
    order = np.argsort(-evals)
    return evals[order][:m], evecs[:, order][:, :m]


def model_eigenvector(model_pcs: np.ndarray, n_subspace: int = 20, m: int = 10, s: int = 5) -> np.ndarray:
    """Shape descriptor: eigenvectors of per-subspace surface features
    (parity: shape_similarity.py:164)."""
    pcs = np.asarray(model_pcs, dtype=float)
    # normalize to unit box for scale invariance
    pcs = (pcs - pcs.min(0)) / np.maximum(pcs.max(0) - pcs.min(0), 1e-12)
    centroid = pcs.mean(0)
    # coarsen the grid until enough subspaces have >= 4 points to fit a plane
    n = n_subspace
    feats = []
    while n >= 2:
        feats = []
        for sub in rough_subspace(pcs, n=n):
            if len(sub) < 4:
                continue
            coef = subspace_surface_fitting(sub, order="linear")
            d = dist_global_centroid_to_subspace(centroid, sub)
            cosv = cos_global_centroid_to_subspace(centroid, sub)
            feats.append(np.concatenate([coef, [d], [cosv]]))
        if len(feats) >= max(m, 8):
            break
        n //= 2
    if not feats:
        raise ValueError("Too few points per subspace for shape descriptors; provide more points.")
    V = np.asarray(feats)
    _, evecs = calculate_eigenvector(V, m=m, s=s)
    return evecs.ravel()


def pairwise_shape_similarity(
    model1_pcs: np.ndarray, model2_pcs: np.ndarray, n_subspace: int = 20, m: int = 10, s: int = 5
) -> float:
    """Cosine similarity of the two models' shape descriptors (parity:
    shape_similarity.py:180)."""
    v1 = model_eigenvector(model1_pcs, n_subspace=n_subspace, m=m, s=s)
    v2 = model_eigenvector(model2_pcs, n_subspace=n_subspace, m=m, s=s)
    n = min(len(v1), len(v2))
    v1, v2 = v1[:n], v2[:n]
    return float(abs(np.dot(v1, v2)) / (np.linalg.norm(v1) * np.linalg.norm(v2) + 1e-12))
