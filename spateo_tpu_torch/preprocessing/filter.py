"""Cell / gene / coordinate filters (parity: reference spateo/preprocessing/filter.py:9,68,125).

A copy of `spateo_tpu.preprocessing.filter` (host numpy)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.anndata import AnnData


def _apply_obs_filter(adata: AnnData, filter_bool, detected_bool, keep_filtered: bool):
    filter_bool = filter_bool & detected_bool if filter_bool is not None else detected_bool
    filter_bool = np.asarray(filter_bool).ravel()
    if keep_filtered:
        adata.obs["pass_basic_filter"] = filter_bool
    else:
        adata._inplace_subset_obs(filter_bool)
        adata.obs["pass_basic_filter"] = True
    return adata


def filter_cells(
    adata: AnnData,
    filter_bool: Optional[np.ndarray] = None,
    keep_filtered: bool = False,
    min_expr_genes: int = 50,
    max_expr_genes: float = np.inf,
    min_area: float = 0,
    max_area: float = np.inf,
    inplace: bool = False,
) -> Optional[AnnData]:
    """Select valid cells by expressed-gene count and (optionally) area."""
    if not inplace:
        adata = adata.copy()
    n_genes = np.asarray((adata.X > 0).sum(1)).ravel()
    detected_bool = (n_genes >= min_expr_genes) & (n_genes <= max_expr_genes)
    if (min_area != 0) or (max_area != np.inf):
        if "area" not in adata.obs.columns:
            print("`area` is not in the adata.obs")
        else:
            area = np.asarray(adata.obs["area"].values)
            detected_bool &= (area >= min_area) & (area <= max_area)
    adata = _apply_obs_filter(adata, filter_bool, detected_bool, keep_filtered)
    return adata if not inplace else None


def filter_genes(
    adata: AnnData,
    filter_bool: Optional[np.ndarray] = None,
    keep_filtered: bool = False,
    min_cells: int = 1,
    max_cells: float = np.inf,
    min_avg_exp: float = 0,
    max_avg_exp: float = np.inf,
    min_counts: float = 0,
    max_counts: float = np.inf,
    inplace: bool = False,
) -> Optional[AnnData]:
    """Select valid genes by cell count, mean expression, and total counts."""
    if not inplace:
        adata = adata.copy()
    n_cells = np.asarray((adata.X > 0).sum(0)).ravel()
    mean_exp = np.asarray(adata.X.mean(0)).ravel()
    total = np.asarray(adata.X.sum(0)).ravel()
    detected_bool = (
        (n_cells >= min_cells)
        & (n_cells <= max_cells)
        & (mean_exp >= min_avg_exp)
        & (mean_exp <= max_avg_exp)
        & (total >= min_counts)
        & (total <= max_counts)
    )
    filter_bool = filter_bool & detected_bool if filter_bool is not None else detected_bool
    filter_bool = np.asarray(filter_bool).ravel()
    if keep_filtered:
        adata.var["pass_basic_filter"] = filter_bool
    else:
        adata._inplace_subset_var(filter_bool)
        adata.var["pass_basic_filter"] = True
    return adata if not inplace else None


def filter_by_coordinates(
    adata: AnnData,
    filter_bool: Optional[np.ndarray] = None,
    keep_filtered: bool = False,
    x_range: Sequence[float] = (-np.inf, np.inf),
    y_range: Sequence[float] = (-np.inf, np.inf),
    inplace: bool = False,
) -> Optional[AnnData]:
    """Select cells inside a spatial rectangle."""
    if not inplace:
        adata = adata.copy()
    spatial = np.asarray(adata.obsm["spatial"])
    detected_bool = (
        (spatial[:, 0] >= x_range[0])
        & (spatial[:, 0] <= x_range[1])
        & (spatial[:, 1] >= y_range[0])
        & (spatial[:, 1] <= y_range[1])
    )
    adata = _apply_obs_filter(adata, filter_bool, detected_bool, keep_filtered)
    return adata if not inplace else None
