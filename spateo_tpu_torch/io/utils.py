"""IO utility functions: binning, label properties, hull tests.

Counterpart of `spateo_tpu.io.utils`, host code as there: label areas,
boxes and centroids from bincounts over the raster, contours as float
vertex arrays. OpenCV (hulls, moments, contours) and matplotlib (the
concave-hull test) are imported inside the functions that use them, so
importing the package needs neither.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import pandas as pd
from scipy.sparse import csr_matrix, issparse, spmatrix
from scipy.spatial import Delaunay


def bin_indices(coords: np.ndarray, coord_min: float, binsize: int = 50) -> np.ndarray:
    """Bin index for each coordinate given the minimum coordinate and bin size."""
    num = np.floor((coords - coord_min) / binsize)
    return num.astype(np.uint32)


def centroids(bin_indices: np.ndarray, coord_min: float = 0, binsize: int = 50) -> np.ndarray:
    """Centroid coordinate of each bin."""
    return coord_min + bin_indices * binsize + binsize / 2


def _hull_contour(points: np.ndarray) -> np.ndarray:
    """Convex-hull polygon (as vertex array) of integer points."""
    import cv2

    points = np.asarray(points, dtype=np.int32)
    if points.shape[0] >= 3:
        hull = cv2.convexHull(points, returnPoints=True).squeeze(1)
        return hull.astype(float)
    return points.astype(float)


def get_points_props(data: pd.DataFrame) -> pd.DataFrame:
    """Properties (area/bbox/centroid/contour) of labeled point sets.

    Args:
        data: DataFrame with ``x``, ``y``, ``label`` columns.

    Returns:
        DataFrame indexed by label (as str) with columns area, bbox-0..3,
        centroid-0/1, contour.
    """
    import cv2

    rows = []
    for label, _df in data.drop_duplicates(subset=["label", "x", "y"]).groupby("label", observed=True):
        points = _df[["x", "y"]].values.astype(int)
        mins = points.min(axis=0)
        maxs = points.max(axis=0)
        hull = _hull_contour(points)
        if hull.shape[0] >= 3:
            moments = cv2.moments(hull.astype(np.float32))
            area = moments["m00"]
        else:
            area = 0.0
        if area > 0:
            centroid0 = moments["m10"] / area
            centroid1 = moments["m01"] / area
        else:
            area = float(len(points))
            centroid0, centroid1 = points.mean(axis=0) + 0.5
        rows.append([str(label), area, mins[0], mins[1], maxs[0] + 1, maxs[1] + 1, centroid0, centroid1, hull])
    return pd.DataFrame(
        rows,
        columns=["label", "area", "bbox-0", "bbox-1", "bbox-2", "bbox-3", "centroid-0", "centroid-1", "contour"],
    ).set_index("label")


def get_label_props(labels: np.ndarray) -> pd.DataFrame:
    """Measure properties of labeled cell regions (vectorized).

    Area, box and centroid come from single-pass bincounts over the raster;
    only the per-label contour extraction touches OpenCV.
    """
    import cv2

    labels = np.asarray(labels)
    uniq = np.unique(labels)
    uniq = uniq[uniq > 0]
    if uniq.size == 0:
        return pd.DataFrame(
            columns=["area", "bbox-0", "bbox-1", "bbox-2", "bbox-3", "centroid-0", "centroid-1", "contour"]
        )
    max_label = int(uniq.max())
    flat = labels.ravel()
    xs = np.repeat(np.arange(labels.shape[0]), labels.shape[1]).astype(np.int64)
    ys = np.tile(np.arange(labels.shape[1]), labels.shape[0]).astype(np.int64)
    mask = flat > 0
    flat_m, xs_m, ys_m = flat[mask], xs[mask], ys[mask]

    area = np.bincount(flat_m, minlength=max_label + 1)
    sum_x = np.bincount(flat_m, weights=xs_m, minlength=max_label + 1)
    sum_y = np.bincount(flat_m, weights=ys_m, minlength=max_label + 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        cx = sum_x / area
        cy = sum_y / area
    # bbox via min/max per label
    INF = np.iinfo(np.int64).max
    min_x = np.full(max_label + 1, INF)
    min_y = np.full(max_label + 1, INF)
    max_x = np.full(max_label + 1, -1)
    max_y = np.full(max_label + 1, -1)
    np.minimum.at(min_x, flat_m, xs_m)
    np.minimum.at(min_y, flat_m, ys_m)
    np.maximum.at(max_x, flat_m, xs_m)
    np.maximum.at(max_y, flat_m, ys_m)

    rows = []
    for label in uniq:
        x0, y0, x1, y1 = min_x[label], min_y[label], max_x[label] + 1, max_y[label] + 1
        sub = (labels[x0:x1, y0:y1] == label).astype(np.uint8)
        contours = cv2.findContours(sub, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
        # findContours returns (col, row); convert to (x, y) = (row, col) offsets
        contour = max(contours, key=cv2.contourArea).squeeze(1)[:, ::-1] + np.array([x0, y0])
        rows.append(
            [str(label), float(area[label]), x0, y0, x1, y1, cx[label], cy[label], contour.astype(float)]
        )
    return pd.DataFrame(
        rows,
        columns=["label", "area", "bbox-0", "bbox-1", "bbox-2", "bbox-3", "centroid-0", "centroid-1", "contour"],
    ).set_index("label")


def get_bin_props(data: pd.DataFrame, binsize: int) -> pd.DataFrame:
    """Simulated properties of square bin regions."""

    def square(row):
        x, y = row["x"] * binsize, row["y"] * binsize
        if binsize > 1:
            return np.array(
                [(x, y), (x + binsize, y), (x + binsize, y + binsize), (x, y + binsize), (x, y)], dtype=float
            )
        return np.array([(x, y)], dtype=float)

    props = pd.DataFrame(
        {
            "label": data["label"].copy(),
            "contour": data.apply(square, axis=1),
            "centroid-0": centroids(data["x"].values, 0, binsize),
            "centroid-1": centroids(data["y"].values, 0, binsize),
        }
    )
    props["area"] = binsize**2
    props["bbox-0"] = data["x"].values * binsize
    props["bbox-1"] = data["y"].values * binsize
    props["bbox-2"] = (data["x"].values + 1) * binsize + 1
    props["bbox-3"] = (data["y"].values + 1) * binsize + 1
    return props.set_index("label")


#: Points a block of `in_concave_hull` tests against every edge at once.
_HULL_BLOCK_ELEMS = 1 << 22


def in_concave_hull(p: np.ndarray, concave_hull: np.ndarray) -> np.ndarray:
    """Test if 2D points lie inside a polygon given as an (M, 2) vertex array.

    ``matplotlib.path.Path(concave_hull).contains_points(p)`` (radius 0),
    without matplotlib: Agg's crossing test (`point_in_path_impl` in
    matplotlib's `_path.h`) in float64 numpy. The polygon is closed by the
    edge from its last vertex back to its first; a point's upward flag is
    ``vertex_y >= y``, an edge whose end flags differ is crossed when
    ``(y1 - y) (x0 - x1) >= (x1 - x) (y0 - y1)`` equals the end flag, and an
    odd number of crossings puts the point inside. That settles points on an
    edge or a vertex as matplotlib does. Fewer than 3 vertices contain
    nothing, and a non-finite point is outside.
    """
    assert p.shape[1] == 2, "this function only works for two dimensional data points."
    v = np.asarray(concave_hull, dtype=np.float64).reshape(-1, 2)
    pts = np.asarray(p, dtype=np.float64)
    inside = np.zeros(len(pts), dtype=bool)
    if len(v) < 3:
        return inside
    x0, y0 = v[:, 0], v[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    block = max(1, _HULL_BLOCK_ELEMS // len(v))
    for s in range(0, len(pts), block):
        tx, ty = pts[s : s + block, 0:1], pts[s : s + block, 1:2]
        flag0 = y0 >= ty
        flag1 = y1 >= ty
        hit = ((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == flag1
        crossings = np.count_nonzero((flag0 != flag1) & hit, axis=1)
        inside[s : s + block] = (crossings % 2 == 1) & np.isfinite(tx[:, 0]) & np.isfinite(ty[:, 0])
    return inside


def in_convex_hull(p: np.ndarray, convex_hull: Union[Delaunay, np.ndarray]) -> np.ndarray:
    """Test if points are inside a convex hull via Delaunay simplex lookup."""
    if not isinstance(convex_hull, Delaunay):
        assert p.shape[1] == convex_hull.shape[1], "the second dimension of p and hull must be the same."
        convex_hull = Delaunay(convex_hull)
    return convex_hull.find_simplex(p) >= 0


def bin_matrix(X: Union[np.ndarray, spmatrix], binsize: int) -> Union[np.ndarray, csr_matrix]:
    """Sum-pool a matrix into bins of `binsize` (vectorized for dense and sparse)."""
    shape = (math.ceil(X.shape[0] / binsize), math.ceil(X.shape[1] / binsize))
    if issparse(X):
        nz = X.nonzero()
        x, y = nz
        data = np.asarray(X[nz]).ravel()
        return csr_matrix((data, (bin_indices(x, 0, binsize), bin_indices(y, 0, binsize))), shape=shape, dtype=X.dtype)
    X = np.asarray(X)
    pad0 = shape[0] * binsize - X.shape[0]
    pad1 = shape[1] * binsize - X.shape[1]
    Xp = np.pad(X, ((0, pad0), (0, pad1)))
    return Xp.reshape(shape[0], binsize, shape[1], binsize).sum(axis=(1, 3)).astype(X.dtype)


def get_coords_labels(labels: np.ndarray) -> pd.DataFrame:
    """Labels raster -> sparse (x, y, label) DataFrame."""
    nz = labels.nonzero()
    x, y = nz
    data = labels[nz]
    values = np.vstack((x, y, data)).T
    return pd.DataFrame(values, columns=["x", "y", "label"])


def contour_to_geo(contour) -> np.ndarray:
    """Contour -> geometry: the vertex array itself (no shapely)."""
    return np.asarray(contour, dtype=float).reshape(-1, 2)
