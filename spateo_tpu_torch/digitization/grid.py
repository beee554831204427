"""Layer/column digitization: the entry points `digitize` and `gridit`.

Counterpart of `spateo_tpu.digitization.grid`. The two heat-equation solves
run on ``device=`` (the Jacobi kernel on the card); the per-cell field
lookup is one vectorized gather (the reference loops over cells in Python,
grid.py:86-106)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..configuration import SKM
from ..core.anndata import AnnData
from ..logging import logger_manager as lm
from .utils import domain_heat_eqn_solver, field_contours


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def digitize(
    adata: AnnData,
    ctrs: Tuple,
    ctr_idx: int,
    pnt_xy: Tuple[int, int],
    pnt_Xy: Tuple[int, int],
    pnt_xY: Tuple[int, int],
    pnt_XY: Tuple[int, int],
    spatial_key: str = "spatial",
    dgl_layer_key: str = "digital_layer",
    dgl_column_key: str = "digital_column",
    max_itr: int = int(1e6),
    lh: float = 1,
    hh: float = 100,
    device="cuda",
) -> None:
    """Digitize a closed domain into layer and column heat fields by solving
    the heat equation with corner-point boundary conditions on `device`."""
    import cv2

    coords = np.asarray(adata.obsm[spatial_key])
    empty_field = np.zeros((int(coords[:, 0].max()) + 1, int(coords[:, 1].max()) + 1), dtype=np.float32)

    field_border = np.zeros_like(empty_field)
    cv2.drawContours(field_border, ctrs, ctr_idx, ctr_idx + 1, 1)
    field_mask = np.zeros_like(empty_field)
    cv2.drawContours(field_mask, ctrs, ctr_idx, ctr_idx + 1, cv2.FILLED)

    min_line_l, max_line_l, min_line_c, max_line_c = field_contours(ctrs[ctr_idx], pnt_xy, pnt_Xy, pnt_xY, pnt_XY)

    lm.main_info(f"Solving the layer heat equation on {device}.")
    of_layer = domain_heat_eqn_solver(
        empty_field, min_line_l, max_line_l, min_line_c, max_line_c, field_border, field_mask,
        lh=lh, hh=hh, max_itr=max_itr, device=device,
    )
    lm.main_info(f"Solving the column heat equation on {device}.")
    of_column = domain_heat_eqn_solver(
        empty_field, min_line_c, max_line_c, min_line_l, max_line_l, field_border, field_mask,
        lh=lh, hh=hh, max_itr=max_itr, device=device,
    )

    # vectorized per-cell lookups (replaces reference's per-cell Python loop)
    ix = coords[:, 0].astype(int)
    iy = coords[:, 1].astype(int)
    adata.obs[dgl_layer_key] = of_layer[ix, iy]
    adata.obs[dgl_column_key] = of_column[ix, iy]


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def gridit(
    adata: AnnData,
    layer_num: int,
    column_num: int,
    lh: float = 1,
    hh: float = 100,
    dgl_layer_key: str = "digital_layer",
    dgl_column_key: str = "digital_column",
    layer_border_width: int = 2,
    column_border_width: int = 2,
    layer_label_key: str = "layer_label",
    column_label_key: str = "column_label",
    grid_label_key: str = "grid_label",
) -> None:
    """Bin precomputed heat values into discrete layers/columns/grids
    (parity: reference grid.py:110)."""
    layer_heat = np.asarray(adata.obs[dgl_layer_key], dtype=float)
    column_heat = np.asarray(adata.obs[dgl_column_key], dtype=float)

    grid_label = np.where((layer_heat != 0) | (column_heat != 0), "Grid Area", "NA")
    adata.obs[grid_label_key] = grid_label

    layer_edges = np.linspace(lh, hh, layer_num + 1)
    column_edges = np.linspace(lh, hh, column_num + 1)
    layer_label = np.clip(np.digitize(layer_heat, layer_edges[1:-1], right=True) + 1, 1, layer_num)
    column_label = np.clip(np.digitize(column_heat, column_edges[1:-1], right=True) + 1, 1, column_num)
    layer_label = np.where(layer_heat > 0, layer_label, 0)
    column_label = np.where(column_heat > 0, column_label, 0)
    adata.obs[layer_label_key] = layer_label
    adata.obs[column_label_key] = column_label

    # mark buckets near layer/column borders on the grid
    def near_border(heat, edges, width, num):
        span = (hh - lh) / num
        frac = width / 100.0 * span
        dist = np.min(np.abs(heat[:, None] - edges[None, 1:-1]), axis=1) if num > 1 else np.full_like(heat, np.inf)
        return dist <= frac

    border = near_border(layer_heat, layer_edges, layer_border_width, layer_num) | near_border(
        column_heat, column_edges, column_border_width, column_num
    )
    grid_label = np.where((grid_label == "Grid Area") & border, "Region Boundary", grid_label)
    adata.obs[grid_label_key] = grid_label
