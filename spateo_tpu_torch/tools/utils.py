"""Shared tool helpers (capability parity: reference spateo/tools/utils.py:18-
onwards — rescaling, mappers, moments, affine transforms, hull tests,
polarity/new-coordinate helpers)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import pandas as pd
import scipy.sparse as sp
from scipy.sparse import diags, issparse


def rescaling(mat, new_shape) -> np.ndarray:
    """Rescale a spatial-domain matrix to `new_shape` by block aggregation /
    repetition (parity: reference tools/utils.py:18)."""
    mat = mat.toarray() if issparse(mat) else np.asarray(mat)
    out = np.zeros(tuple(new_shape), dtype=mat.dtype)
    fy = mat.shape[0] / new_shape[0]
    fx = mat.shape[1] / new_shape[1]
    ys = (np.arange(new_shape[0]) * fy).astype(int)
    xs = (np.arange(new_shape[1]) * fx).astype(int)
    out = mat[np.clip(ys, 0, mat.shape[0] - 1)][:, np.clip(xs, 0, mat.shape[1] - 1)]
    return out


def get_mapper(smoothed: bool = True) -> dict:
    """Layer-name mapper (parity: reference tools/utils.py:36)."""
    return {
        "X_spliced": "M_s" if smoothed else "X_spliced",
        "X_unspliced": "M_u" if smoothed else "X_unspliced",
        "X_new": "M_n" if smoothed else "X_new",
        "X_old": "M_o" if smoothed else "X_old",
        "X_total": "M_t" if smoothed else "X_total",
    }


def update_dict(dict1: dict, dict2: dict) -> dict:
    """Update dict1's existing keys from dict2 (parity: utils.py:53)."""
    dict1.update((k, dict2[k]) for k in dict1.keys() & dict2.keys())
    return dict1


def flatten(arr) -> np.ndarray:
    """Flatten Series / sparse / ndarray uniformly (parity: utils.py:59)."""
    if isinstance(arr, pd.Series):
        return arr.values.flatten()
    if sp.issparse(arr):
        return arr.toarray().flatten()
    return np.asarray(arr).flatten()


def compute_corr_ci(
    r: float,
    n: int,
    confidence: float = 95,
    decimals: int = 2,
    alternative: str = "two-sided",
):
    """Fisher-z parametric CI for a correlation coefficient
    (parity: utils.py:69). Returns (lo, hi)."""
    from scipy import stats

    z = np.arctanh(np.clip(r, -0.999999, 0.999999))
    se = 1.0 / np.sqrt(max(n - 3, 1))
    if alternative == "two-sided":
        crit = stats.norm.ppf(1 - (1 - confidence / 100) / 2)
        lo, hi = z - crit * se, z + crit * se
    elif alternative == "greater":
        crit = stats.norm.ppf(confidence / 100)
        lo, hi = z - crit * se, np.inf
    else:
        crit = stats.norm.ppf(confidence / 100)
        lo, hi = -np.inf, z + crit * se
    return np.round(np.tanh(lo), decimals), np.round(np.tanh(hi), decimals)


def calc_1nd_moment(X, W, normalize_W: bool = True):
    """First spatial moment W @ X with optional row normalization
    (parity: utils.py:115)."""
    if normalize_W:
        d = np.asarray(W.sum(1)).flatten() if issparse(W) else np.sum(W, 1).flatten()
        Wn = diags(1 / np.maximum(d, 1e-12)) @ W if issparse(W) else np.diag(1 / np.maximum(d, 1e-12)) @ W
        return Wn @ X, Wn
    return W @ X


def affine_transform(X, A, b) -> np.ndarray:
    """(A @ X^T)^T + b (parity: utils.py:127)."""
    return (np.asarray(A) @ np.asarray(X).T).T + np.asarray(b)


def gen_rotation_2d(degree: float) -> np.ndarray:
    """2D rotation matrix from degrees (parity: utils.py:134)."""
    rad = np.deg2rad(degree)
    return np.array([[np.cos(rad), -np.sin(rad)], [np.sin(rad), np.cos(rad)]])


def compute_smallest_distance(
    coords: np.ndarray, leaf_size: int = 40, sample_num: Optional[int] = None, use_unique_coords: bool = True
) -> float:
    """Median nearest-neighbor distance of a (sub)sample
    (parity: utils.py:145)."""
    from scipy.spatial import cKDTree

    coords = np.asarray(coords)
    if use_unique_coords:
        coords = np.unique(coords, axis=0)
    if sample_num and sample_num < len(coords):
        coords = coords[np.random.default_rng(0).choice(len(coords), sample_num, replace=False)]
    tree = cKDTree(coords, leafsize=leaf_size)
    d, _ = tree.query(coords, k=2)
    return float(np.median(d[:, 1]))


def in_hull(p: np.ndarray, hull) -> np.ndarray:
    """Boolean mask of points inside a convex hull (parity: utils.py:204)."""
    from scipy.spatial import Delaunay

    if not isinstance(hull, Delaunay):
        hull = Delaunay(np.asarray(hull))
    return hull.find_simplex(np.asarray(p)) >= 0


def create_new_coordinate(adata, spatial_key: str = "spatial", plane: str = "xy", centerline_points: Optional[np.ndarray] = None):
    """Project cells onto the diagonal of a coordinate plane and measure
    the distance along it (reference semantics, tools/utils.py:304): the
    axis runs from the plane's min corner toward its max corner ("xy",
    "yz", "xz"), or from max of the second axis for the "-" variants.
    Writes `.obs["{plane} Coordinate"]` and `.uns["{plane} Line"]`.

    With `centerline_points` (an extension kept from this framework's
    earlier API), instead projects onto the given polyline and writes
    `.obs['new_x']` (arc length) / `.obs['new_y']` (signed offset)."""
    if centerline_points is None:
        arr = np.asarray(adata.obsm[spatial_key], float)
        if "z" in plane and arr.shape[1] < 3:
            raise ValueError("Cannot project onto z-axis if there are only 2 spatial dimensions.")
        axes = {"xy": (0, 1), "yz": (1, 2), "xz": (0, 2)}
        key = plane.lstrip("-")
        if key not in axes:
            raise ValueError("Invalid coord_column")
        i, j = axes[key]
        p0, p1 = arr[:, i], arr[:, j]
        min_point = np.array([p0.min(), p1.min()])
        max_point = np.array([p0.max(), p1.max()])
        if plane.startswith("-"):
            min_point[1], max_point[1] = p1.max(), p1.min()
            reference_point = max_point
        else:
            reference_point = min_point
        (c0, d0), (c1, d1) = min_point, max_point
        dc, dd = c1 - c0, d1 - d0
        if dc != 0:
            m = dd / dc
            b = d0 - m * c0
            proj0 = (m * p1 + p0 - m * b) / (m**2 + 1)
            proj1 = (m**2 * p1 + m * p0 + b) / (m**2 + 1)
        else:
            m, b = np.inf, c0
            proj0 = np.full_like(p0, b)
            proj1 = p1
        dist = np.sqrt((proj0 - reference_point[0]) ** 2 + (proj1 - reference_point[1]) ** 2)
        adata.obs[f"{plane} Coordinate"] = dist
        adata.uns[f"{plane} Line"] = {"start": min_point, "end": max_point, "m": m, "b": b}
        return adata
    coords = np.asarray(adata.obsm[spatial_key], float)[:, :2]
    line = np.asarray(centerline_points, float)
    seg = np.diff(line, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    cum = np.concatenate([[0], np.cumsum(seg_len)])
    best_d = np.full(len(coords), np.inf)
    along = np.zeros(len(coords))
    across = np.zeros(len(coords))
    for i, (p0, s, L) in enumerate(zip(line[:-1], seg, seg_len)):
        t = np.clip(((coords - p0) @ s) / max(L**2, 1e-12), 0, 1)
        proj = p0 + t[:, None] * s
        d = np.linalg.norm(coords - proj, axis=1)
        normal = np.array([-s[1], s[0]]) / max(L, 1e-12)
        sgn = np.sign((coords - proj) @ normal)
        m = d < best_d
        best_d[m] = d[m]
        along[m] = cum[i] + t[m] * L
        across[m] = (sgn * d)[m]
    adata.obs["new_x"] = along
    adata.obs["new_y"] = across
    return adata


def filter_adata_spatial(adata, coords_key: str, instructions, col_alias_map: Optional[dict] = None):
    """Filter by spatial coordinates (parity: reference tools/utils.py:257-297).

    `instructions` is the reference's list of natural-language conditions,
    executed sequentially through `parse_instruction` + pandas query, e.g.
    ["x less than 950 and z less than or equal to 350"]; the default alias
    map sends x/y/z to the points_x/points_y/points_z frame columns. A list
    of per-axis (lo, hi) range tuples is also accepted as a convenience."""
    import pandas as pd

    coords = np.asarray(adata.obsm[coords_key], float)
    # convenience form: [(xlo, xhi), (ylo, yhi), ...]
    if len(instructions) and not isinstance(instructions[0], str):
        mask = np.ones(len(coords), bool)
        for ax, (lo, hi) in enumerate(instructions):
            mask &= (coords[:, ax] >= lo) & (coords[:, ax] <= hi)
        return adata[np.flatnonzero(mask)]

    if col_alias_map is None:
        col_alias_map = {"x": "points_x", "y": "points_y", "z": "points_z"}
    if coords.shape[1] == 2:
        df = pd.DataFrame(coords, index=adata.obs_names, columns=["points_x", "points_y"])
    elif coords.shape[1] == 3:
        df = pd.DataFrame(coords, index=adata.obs_names, columns=["points_x", "points_y", "points_z"])
    else:
        raise ValueError(f"Coordinates must be 2D or 3D. Given shape: {coords.shape}.")
    for instruction in instructions:
        df = df.query(parse_instruction(instruction, col_alias_map))
    from ..logging import logger_manager as lm

    lm.main_info(f"Filtered {adata.n_obs} cells to {len(df)} cells.")
    keep = [list(adata.obs_names).index(i) for i in df.index]
    return adata[np.asarray(keep, int)].copy()


def parse_instruction(instruction: str, axis_map: Optional[dict] = None) -> str:
    """Natural-language filter -> pandas query string (parity: reference
    tools/utils.py:227): "x less than 950 and z less than or equal to 350"
    -> "(x < 950) & (z <= 350)"."""
    s = instruction
    if axis_map:
        for alias, col in axis_map.items():
            s = s.replace(alias, col)
    replacements = [
        (" less than or equal to ", " <= "),
        (" greater than or equal to ", " >= "),
        (" less than ", " < "),
        (" greater than ", " > "),
        (" equal to ", " == "),
        (" not equal to ", " != "),
    ]
    for a, b in replacements:
        s = s.replace(a, b)
    parts = [p.strip() for p in s.split(" and ")]
    out = " & ".join(f"({p})" for p in parts)
    out = out.replace("not (", "~(")
    return out


def polyhull(x: np.ndarray, y: np.ndarray, z: np.ndarray):
    """Convex-hull surface of 3D points (parity: reference
    tools/utils.py:184; pyvista PolyData replaced by the framework Mesh)."""
    from scipy.spatial import ConvexHull

    from ..tdr.models.mesh_core import Mesh

    pts = np.stack([np.asarray(x, float).ravel(), np.asarray(y, float).ravel(), np.asarray(z, float).ravel()], 1)
    hull = ConvexHull(pts)
    return Mesh(pts, hull.simplices)
