"""Boundary identification and layered gridding between two cluster regions.

Capability parity with reference spateo/digitization/boundary_old.py
(`identify_boundary`:16, `boundary_gridding`:80) and utils_old.py
(`format_boundary_line`:75) — the boundary-centric digitization workflow:
find the interface between a source and a target cluster region, then grid
layers/columns outward from it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.anndata import AnnData
from ..logging import logger_manager as lm
from .contour import extract_cluster_contours, gen_cluster_image
from .utils import draw_seg_grid, extend_layer, fill_grid_label, segment_bd_line


def format_boundary_line(boundary_line_img: np.ndarray, pt_start, pt_end) -> Tuple[List, np.ndarray]:
    """Order the boundary pixels into a polyline from `pt_start` to
    `pt_end` (parity: reference utils_old.py:75)."""
    import cv2

    ctrs, _ = cv2.findContours(boundary_line_img.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    formatted_bdl_img = np.zeros_like(boundary_line_img, dtype=np.uint8)
    ctrs_pt_list = [(int(pt[0][0]), int(pt[0][1])) for pt in ctrs[0]]
    pt_start, pt_end = tuple(map(int, pt_start)), tuple(map(int, pt_end))

    def _loc(p):
        if p in ctrs_pt_list:
            return ctrs_pt_list.index(p)
        d = [(px - p[0]) ** 2 + (py - p[1]) ** 2 for px, py in ctrs_pt_list]
        return int(np.argmin(d))

    start_idx, end_idx = _loc(pt_start), _loc(pt_end)
    formatted_bdl_list = ctrs_pt_list[min(start_idx, end_idx) : max(start_idx, end_idx) + 2]
    for i in range(len(formatted_bdl_list) - 1):
        cv2.line(formatted_bdl_img, formatted_bdl_list[i], formatted_bdl_list[i + 1], 255, 1)
    lm.main_info(f"Extracted boundary line length: {len(formatted_bdl_list)}.")
    return formatted_bdl_list, formatted_bdl_img


def identify_boundary(
    adata: AnnData,
    cluster_key: str,
    source_id,
    target_id,
    bin_size: int = 1,
    spatial_key: str = "spatial",
    boundary_key: str = "boundary_line",
    k_size: float = 8,
    min_area: float = 30,
    dilate_k_size: int = 3,
) -> np.ndarray:
    """Identify the boundary between a source and a target cluster region
    (parity: reference boundary_old.py:16): rasterize a temporary
    source/target labeling, take the source contour, keep the part adjacent
    to the dilated target area, and tag the adata cells lying on it."""
    import cv2

    source_id = list(np.atleast_1d(source_id))
    target_id = list(np.atleast_1d(target_id))
    lm.main_info("Setting up source and target area.")
    adata_tmp = adata.copy()
    groups = np.asarray(adata_tmp.obs[cluster_key])
    tmp = np.zeros(adata_tmp.n_obs, int)
    tmp[np.isin(groups, source_id)] = 1
    tmp[np.isin(groups, target_id)] = 2
    adata_tmp.obs["tmp_boundary"] = tmp

    lm.main_info("Identifying boundary.")
    boundary_img = gen_cluster_image(
        adata_tmp, bin_size=bin_size, spatial_key=spatial_key, cluster_key="tmp_boundary", show=False
    )
    img_labels = np.asarray(adata_tmp.obs["cluster_img_label"])
    source_label = np.unique(img_labels[tmp == 1])
    target_label = np.unique(img_labels[tmp == 2])
    _, _, ctr_img = extract_cluster_contours(
        boundary_img, list(source_label), bin_size=bin_size, k_size=k_size, min_area=min_area, show=False
    )
    _, tgt_img, _ = extract_cluster_contours(
        boundary_img, list(target_label), bin_size=bin_size, k_size=k_size, min_area=min_area, show=False
    )
    dilate_kernel = np.ones((dilate_k_size, dilate_k_size), np.uint8)
    tgt_img = cv2.dilate(tgt_img.astype(np.uint8), dilate_kernel, iterations=1)

    lm.main_info("Generating boundary line image.")
    boundary_line_img = np.where(tgt_img != 0, ctr_img, 0)

    lm.main_info(f"Saving boundary into adata.obs['{boundary_key}'].")
    coords = np.asarray(adata.obsm[spatial_key]).astype(int)
    on_line = boundary_line_img[coords[:, 0], coords[:, 1]] != 0
    adata.obs[boundary_key] = np.where(on_line, "Boundary Line", " ")
    return boundary_line_img.astype(np.uint8)


def boundary_gridding(
    adata: AnnData,
    boundary_line_img: np.ndarray,
    boundary_line_list: List,
    n_layer: int = 3,
    n_column: int = 25,
    layer_width: int = 10,
    spatial_key: str = "spatial",
    init: bool = False,
    device="cuda",
):
    """Grid `n_layer` layers on each side of a boundary line into
    `n_column` columns (parity: reference boundary_old.py:80): extend the
    line outward layer by layer, split each extension into inner/outer
    arcs, arclength-segment them and flood-fill layer/column labels. The
    extensions' connected components run on `device`."""
    bdl_seg_inner_list: List = []
    bdl_seg_outer_list: List = []
    bdl_seg_ori = segment_bd_line(boundary_line_list, n_column)

    for i_layer in range(n_layer):
        extend_width = layer_width * (i_layer + 1)
        _, ext_bdl_list = extend_layer(boundary_line_img, boundary_line_list, extend_width=extend_width, device=device)
        if len(ext_bdl_list) < 4:
            lm.main_warning(f"Layer {i_layer + 1}: extension produced too few boundary points; stopping.")
            break
        # split the closed extension contour into the inner and outer arcs
        # at the two discontinuities (where the end caps were removed)
        ext_tmp = ext_bdl_list + [ext_bdl_list[0]]
        edge_point_index = [
            i
            for i in range(len(ext_tmp) - 1)
            if max(abs(ext_tmp[i][0] - ext_tmp[i + 1][0]), abs(ext_tmp[i][1] - ext_tmp[i + 1][1])) > 1
        ]
        if len(edge_point_index) < 2:
            lm.main_warning(f"Layer {i_layer + 1}: could not split extension into arcs; stopping.")
            break
        ext_bdl_inner = ext_bdl_list[edge_point_index[0] + 1 : edge_point_index[1] + 1]
        ext_bdl_outer = (ext_bdl_list[edge_point_index[1] + 1 :] + ext_bdl_list[: edge_point_index[0] + 1])[::-1]
        bdl_seg_inner_list.append(segment_bd_line(ext_bdl_inner, n_column))
        bdl_seg_outer_list.append(segment_bd_line(ext_bdl_outer, n_column))

    n_built = len(bdl_seg_inner_list)
    bdl_seg_all_list = bdl_seg_inner_list[::-1] + [bdl_seg_ori] + bdl_seg_outer_list
    for i_layer in range(2 * n_built):
        # generalizes the reference's hardcoded n_layer=3 numbering
        # (boundary_old.py:125 `i_layer % 3 + 1`): layers 1..n_built inner
        # (sign -1) then 1..n_built outer (sign +1)
        curr_layer_num = i_layer % n_built + 1
        curr_sign = (-1) ** (i_layer // n_built + 1)
        seg_grid_img = draw_seg_grid(boundary_line_img, bdl_seg_all_list[i_layer], bdl_seg_all_list[i_layer + 1])
        fill_grid_label(
            adata,
            spatial_key,
            seg_grid_img,
            bdl_seg_all_list[i_layer],
            bdl_seg_all_list[i_layer + 1],
            curr_layer_num,
            curr_sign,
            init=init and (i_layer == 0),
        )
    return bdl_seg_all_list
