"""Point-cloud model construction (capability parity: reference
spateo/tdr/models/models_individual/point_clouds.py:21).

A copy of `spateo_tpu.tdr.models.models_individual.point_clouds`."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from ....core.anndata import AnnData
from ....logging import logger_manager as lm
from ..mesh_core import PointCloud


def construct_pc(
    adata: AnnData,
    layer: str = "X",
    spatial_key: str = "spatial",
    groupby: Optional[str] = None,
    key_added: str = "groups",
    mask: Union[str, int, float, list, None] = None,
    colormap: Union[str, list, dict] = "rainbow",
    alphamap: Union[float, list, dict] = 1.0,
) -> Tuple[PointCloud, Optional[str]]:
    """Build a 3D point cloud from cell coordinates + group labels
    (parity: point_clouds.py:21). Returns (pc, plot_cmap placeholder)."""
    coords = np.asarray(adata.obsm[spatial_key], dtype=float)
    if coords.shape[1] == 2:
        coords = np.c_[coords, np.zeros(len(coords))]
    pc = PointCloud(coords)
    pc["obs_index"] = np.asarray(adata.obs_names)
    if groupby is not None:
        groups = np.asarray(adata.obs[groupby]).astype(str)
        if mask is not None:
            mask_list = mask if isinstance(mask, list) else [mask]
            groups = np.where(np.isin(groups, [str(m) for m in mask_list]), "mask", groups)
        pc[key_added] = groups
    else:
        pc[key_added] = np.full(len(coords), "same")
    return pc, None
