"""Segmentation QC: region selection + random-label generation
(counterpart of `spateo_tpu.segmentation.qc`; reference
spateo/segmentation/qc.py:12-170). Host numpy, a copy: the draws come from
``np.random.default_rng(seed)`` in the JAX package's order."""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from ..configuration import SKM
from ..core.anndata import AnnData
from ..errors import SegmentationError
from ..logging import logger_manager as lm


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def select_qc_regions(
    adata: AnnData,
    regions: Union[List[Tuple[int, int]], List[Tuple[int, int, int, int]], None] = None,
    n: int = 4,
    size: int = 2000,
    seed: Optional[int] = None,
    use_scale: bool = True,
    absolute: bool = False,
    weight_func: Optional[Callable[[AnnData], float]] = lambda adata: float(np.log1p(adata.X.sum())),
):
    """Select QC regions, weighted by UMI content by default (parity: qc.py:12)."""
    if not regions:
        _regions = np.zeros((n, 4), dtype=int)
        indices = np.dstack(
            np.meshgrid(np.arange(0, adata.n_obs - size, size), np.arange(0, adata.n_vars - size, size))
        ).reshape(-1, 2)
        if indices.shape[0] == 0:
            raise SegmentationError("No possible regions found. This may indicate the `size` argument is too big.")
        rng = np.random.default_rng(seed)
        if weight_func is None:
            idx = rng.choice(np.arange(indices.shape[0]), n, replace=False)
        else:
            p = np.array([weight_func(adata[x : x + size, y : y + size]) for x, y in indices])
            idx = rng.choice(np.arange(indices.shape[0]), n, replace=False, p=p / p.sum())
        for i, (x, y) in enumerate(indices[idx]):
            xmin = int(adata.obs_names[x])
            ymin = int(adata.var_names[y])
            _regions[i] = [xmin, xmin + size, ymin, ymin + size]
    else:
        _regions = np.zeros((len(regions), 4), dtype=float)
        adata_bounds = SKM.get_agg_bounds(adata)
        binsize = SKM.get_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_BINSIZE_KEY)
        scale = SKM.get_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_SCALE_KEY) * binsize
        unit = SKM.get_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_SCALE_UNIT_KEY)
        for i, region in enumerate(regions):
            if len(region) == 4:
                xmin, xmax, ymin, ymax = region
            elif len(region) == 2:
                xmin, ymin = region
                xmax, ymax = xmin + size, ymin + size
            else:
                raise SegmentationError("`regions` must be a list of 4-element or 2-element tuples.")
            if use_scale and unit is not None:
                xmin, xmax, ymin, ymax = xmin / scale, xmax / scale, ymin / scale, ymax / scale
            if not absolute:
                xmin += adata_bounds[0]
                xmax += adata_bounds[0]
                ymin += adata_bounds[2]
                ymax += adata_bounds[2]
            if xmin < adata_bounds[0] or xmax >= adata_bounds[1] or ymin < adata_bounds[2] or ymax >= adata_bounds[3]:
                lm.main_warning(f"Region {region} is out of bounds. It will be clipped into bounds.")
            _regions[i] = (
                max(xmin, adata_bounds[0]),
                min(xmax, adata_bounds[1]),
                max(ymin, adata_bounds[2]),
                min(ymax, adata_bounds[3]),
            )
    SKM.set_uns_spatial_attribute(adata, SKM.UNS_SPATIAL_QC_KEY, _regions.astype(int))


def _generate_random_labels(shape: Tuple[int, int], areas, seed: Optional[int] = None) -> np.ndarray:
    n = int(np.prod(shape))
    if sum(areas) > n:
        raise SegmentationError("Sum of `areas` exceeds the total area")
    rng = np.random.default_rng(seed)
    labels = np.zeros(n, dtype=int)
    indices = np.arange(n)
    rng.shuffle(indices)
    for i, area in enumerate(areas):
        labels[indices[:area]] = i + 1
        indices = indices[area:]
    return labels.reshape(shape)


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def generate_random_labels(adata: AnnData, areas: List[int], seed: Optional[int] = None, out_layer: str = "random_labels"):
    """Random labels for benchmarking (parity: qc.py:136)."""
    SKM.set_layer_data(adata, out_layer, _generate_random_labels(adata.shape, areas, seed))


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def generate_random_labels_like(adata: AnnData, layer: str, seed: Optional[int] = None, out_layer: str = "random_labels"):
    """Random labels matching another layer's label-size distribution (parity: qc.py:155)."""
    labels = np.asarray(SKM.select_layer_data(adata, layer))
    bincount = np.bincount(labels.ravel())
    SKM.set_layer_data(adata, out_layer, _generate_random_labels(labels.shape, bincount[1:], seed))
