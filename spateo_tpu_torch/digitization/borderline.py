"""Borderline detection between cluster interfaces
(capability parity: reference spateo/digitization/borderline.py:17,110)."""

from __future__ import annotations

from typing import List

import numpy as np

from ..configuration import SKM
from ..core.anndata import AnnData
from ..logging import logger_manager as lm
from .contour import extract_cluster_contours, gen_cluster_image
from .utils import draw_seg_grid, extend_layer, fill_grid_label, segment_bd_line


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def get_borderline(
    adata: AnnData,
    cluster_key: str,
    source_clusters,
    target_clusters,
    bin_size: int = 1,
    spatial_key: str = "spatial",
    borderline_key: str = "borderline",
    k_size: int = 8,
    min_area: int = 30,
    dilate_k_size: int = 3,
) -> np.ndarray:
    """Borderline at the interface of source and target clusters
    (parity: borderline.py:17)."""
    import cv2

    adata_tmp = adata.copy()
    vals = np.zeros(adata.n_obs, dtype=int)
    vals[np.isin(np.asarray(adata.obs[cluster_key]), source_clusters)] = 1
    vals[np.isin(np.asarray(adata.obs[cluster_key]), target_clusters)] = 2
    adata_tmp.obs["tmp_borderline"] = vals

    boundary_img = gen_cluster_image(adata_tmp, bin_size, spatial_key, "tmp_borderline", show=False)
    labels = np.asarray(adata_tmp.obs["cluster_img_label"])
    source_label = np.unique(labels[vals == 1])
    target_label = np.unique(labels[vals == 2])

    _, _, ctr_img = extract_cluster_contours(
        boundary_img, source_label, bin_size=bin_size, k_size=k_size, min_area=min_area, show=False
    )
    _, tgt_img, _ = extract_cluster_contours(
        boundary_img, target_label, bin_size=bin_size, k_size=k_size, min_area=min_area, show=False
    )
    dilate_kernel = np.ones((dilate_k_size, dilate_k_size), np.uint8)
    tgt_img = cv2.dilate(tgt_img, dilate_kernel, iterations=1)
    borderline_img = np.where(tgt_img != 0, ctr_img, 0)

    coords = np.asarray(adata.obsm[spatial_key]).astype(int)
    on_line = borderline_img[coords[:, 0], coords[:, 1]] != 0
    adata.obs[borderline_key] = np.where(on_line, "Borderline", " ")
    return borderline_img.astype(np.uint8)


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def grid_borderline(
    adata: AnnData,
    borderline_img: np.ndarray,
    borderline_list: List,
    layer_num: int = 3,
    column_num: int = 25,
    layer_width: int = 10,
    spatial_key: str = "spatial",
    init: bool = False,
    device="cuda",
) -> None:
    """Extend the borderline into `layer_num` interior/exterior layers and
    `column_num` columns each (parity: borderline.py:110); the extensions'
    connected components run on `device`."""
    bdl_seg_ori = segment_bd_line(borderline_list, column_num)

    bdl_seg_inner_list, bdl_seg_outer_list = [], []
    for i_layer in range(layer_num):
        extend_width = layer_width * (i_layer + 1)
        img_ex, ext_bdl_list = extend_layer(borderline_img, borderline_list, extend_width=extend_width, device=device)
        if not ext_bdl_list:
            lm.main_warning(f"Layer {i_layer + 1}: no extended borderline found; stopping extension.")
            break
        ext_bdl_tmp = ext_bdl_list + [ext_bdl_list[0]]
        end_points_indices = [
            i
            for i in range(len(ext_bdl_tmp) - 1)
            if max(abs(ext_bdl_tmp[i][0] - ext_bdl_tmp[i + 1][0]), abs(ext_bdl_tmp[i][1] - ext_bdl_tmp[i + 1][1])) > 1
        ]
        if len(end_points_indices) >= 1:
            split = end_points_indices[0] + 1
            side_a = ext_bdl_list[:split]
            side_b = ext_bdl_list[split:]
        else:
            half = len(ext_bdl_list) // 2
            side_a, side_b = ext_bdl_list[:half], ext_bdl_list[half:]
        if len(side_a) < 2 or len(side_b) < 2:
            continue
        bdl_seg_inner_list.append(segment_bd_line(side_a, column_num))
        bdl_seg_outer_list.append(segment_bd_line(side_b[::-1], column_num))

    segs = [bdl_seg_ori] + bdl_seg_inner_list
    for i in range(len(segs) - 1):
        grid_img = draw_seg_grid(borderline_img, segs[i], segs[i + 1])
        if grid_img is not None:
            fill_grid_label(
                adata, spatial_key, grid_img, segs[i], segs[i + 1], i + 1, 1, init=(init and i == 0)
            )
    segs_out = [bdl_seg_ori] + bdl_seg_outer_list
    for i in range(len(segs_out) - 1):
        grid_img = draw_seg_grid(borderline_img, segs_out[i], segs_out[i + 1])
        if grid_img is not None:
            fill_grid_label(adata, spatial_key, grid_img, segs_out[i], segs_out[i + 1], i + 1, -1)
