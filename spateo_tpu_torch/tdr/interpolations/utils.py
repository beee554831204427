"""Interpolation utilities (counterpart of
`spateo_tpu.tdr.interpolations.utils`; reference
spateo/tdr/interpolations/utils.py:10). Host-side scipy, as there."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.sparse import issparse
from scipy.spatial import ConvexHull, Delaunay

from ...core.anndata import AnnData


def polyhull(x, y, z=None):
    """Convex hull of a 2D/3D point set."""
    pts = np.c_[x, y] if z is None else np.c_[x, y, z]
    hull = ConvexHull(pts)
    return hull, pts


def in_hull(p: np.ndarray, hull_points: np.ndarray) -> np.ndarray:
    """Test points inside a convex hull via Delaunay simplex lookup."""
    return Delaunay(hull_points).find_simplex(np.asarray(p)) >= 0


def get_X_Y_grid(
    adata: Optional[AnnData] = None,
    genes: Optional[List] = None,
    X: Optional[np.ndarray] = None,
    Y: Optional[np.ndarray] = None,
    grid_num: List = [50, 50, 50],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Spatial coords, expression and a bounding grid restricted to the
    convex hull (parity: interpolations/utils.py:10)."""
    X = np.asarray(adata.obsm["spatial"]) if X is None else np.asarray(X)
    if Y is None:
        Y = adata[:, np.asarray(genes)].X
        Y = Y.toarray() if issparse(Y) else np.asarray(Y)
    else:
        Y = np.asarray(Y)
    D = X.shape[1]
    grid_num = list(grid_num)[:D]
    min_vec, max_vec = X.min(0), X.max(0)
    span = np.abs(max_vec - min_vec)
    min_vec = min_vec - 0.01 * span
    max_vec = max_vec + 0.01 * span
    Grid_list = np.meshgrid(*[np.linspace(i, j, int(k)) for i, j, k in zip(min_vec, max_vec, grid_num)])
    Grid = np.array([g.flatten() for g in Grid_list]).T
    hull = ConvexHull(X)
    grid_in_hull = in_hull(Grid, hull.points[hull.vertices, :])
    return X, Y, Grid, grid_in_hull
