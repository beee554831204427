"""Ground-truth simulation for segmentation evaluation: elliptical cells with
NB expression and dropout.

Counterpart of `spateo_tpu.segmentation.simulation`, host numpy and scipy with
the same `default_rng(seed)` draws in the same order, so a seed gives the JAX
package's rasters. OpenCV draws the ellipses and is imported there.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np
from scipy import stats

from ..configuration import SKM
from ..core.anndata import AnnData
from ..errors import SegmentationError


def _create_labels(
    shape: Tuple[int, int],
    xs: np.ndarray,
    ys: np.ndarray,
    axes1: np.ndarray,
    axes2: np.ndarray,
    angles: np.ndarray,
    shift: int = 3,
) -> np.ndarray:
    """Rasterize simulated elliptical cells, shifting overlaps apart."""
    import cv2

    n = xs.size
    if n != ys.size or n != axes1.size or n != axes2.size or n != angles.size:
        raise SegmentationError(f"All input arrays must have size {n}")
    indices_to_add = deque(range(n))
    labels = np.zeros(shape, dtype=np.int32)
    i = 0
    while indices_to_add:
        if i >= n * 100:
            raise SegmentationError(
                f"Reached iteration {i}. Try reducing the number of cells or turn off shifting by setting `shift=0`."
            )
        idx = indices_to_add.popleft()
        label = idx + 1
        x, y, axis1, axis2, angle = int(xs[idx]), int(ys[idx]), int(axes1[idx]), int(axes2[idx]), angles[idx]
        prev_labels = labels.copy()
        cv2.ellipse(labels, (x, y), (axis1, axis2), angle, 0, 360, label, -1)
        if shift > 1:
            overlapping = np.unique(prev_labels[(labels == label) & (prev_labels > 0)])
            labels[np.isin(labels, overlapping)] = 0
            for ov_label in overlapping:
                ov_idx = ov_label - 1
                if ov_idx not in indices_to_add:
                    indices_to_add.append(int(ov_idx))
                diff_x = xs[ov_idx] - x
                diff_y = ys[ov_idx] - y
                distance = np.sqrt(diff_x**2 + diff_y**2) + 1e-5
                xs[ov_idx] = min(max(0, round(xs[ov_idx] + (diff_x + 1e-5) / distance * shift)), shape[0])
                ys[ov_idx] = min(max(0, round(ys[ov_idx] + (diff_y + 1e-5) / distance * shift)), shape[1])
        i += 1
    return labels


def simulate_cells(
    shape: Tuple[int, int],
    n: int,
    axis1_range: Tuple[int, int] = (7, 15),
    axis2_range: Tuple[int, int] = (5, 14),
    shift: int = 3,
    foreground_params: Tuple[float, float, float] = (0.512, 1.96, 11.4),
    background_params: Tuple[float, float, float] = (0.921, 1.08, 1.74),
    seed: Optional[int] = None,
) -> AnnData:
    """Simulate elliptical cells with NB expression and dropout; an AGG
    AnnData with the true labels in ``layers["labels"]``."""

    def muvar_to_np(mu, var):
        return mu**2 / (var - mu), mu / var

    f_do, f_mu, f_var = foreground_params
    b_do, b_mu, b_var = background_params
    if f_var < f_mu or b_var < b_mu:
        raise SegmentationError("Variance must be larger than mean.")
    f_n, f_p = muvar_to_np(f_mu, f_var)
    b_n, b_p = muvar_to_np(b_mu, b_var)

    rng = np.random.default_rng(seed)
    xs = rng.integers(0, shape[0], n)
    ys = rng.integers(0, shape[1], n)
    axes1 = stats.loguniform.rvs(axis1_range[0], axis1_range[1], size=n, random_state=rng).astype(np.int32)
    axes2 = stats.loguniform.rvs(axis2_range[0], axis2_range[1], size=n, random_state=rng).astype(np.int32)
    angles = rng.uniform(0, 360, n)
    labels = _create_labels(shape, xs, ys, axes1, axes2, angles, shift=shift)

    f_X = stats.nbinom.rvs(f_n, f_p, size=shape, random_state=rng)
    b_X = stats.nbinom.rvs(b_n, b_p, size=shape, random_state=rng)
    f_X[rng.random(shape) < f_do] = 0
    b_X[rng.random(shape) < b_do] = 0
    X = np.where(labels > 0, f_X, b_X)

    adata = AnnData(X=X, layers={"labels": labels})
    SKM.init_adata_type(adata, SKM.ADATA_AGG_TYPE)
    SKM.init_uns_pp_namespace(adata)
    SKM.init_uns_spatial_namespace(adata)
    SKM.set_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_BINSIZE_KEY, 1)
    SKM.set_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_SCALE_KEY, 1)
    SKM.set_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_SCALE_UNIT_KEY, None)
    return adata
