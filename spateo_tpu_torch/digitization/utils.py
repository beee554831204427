"""Digitization support: boundary seeding, contour arcs, PDE solvers.

Counterpart of `spateo_tpu.digitization.utils`. The drawing and tracing are
OpenCV on the host, imported inside the functions that use it, so that the
package imports without OpenCV. The heat solves run `ops.stencil` on
``device=`` (default ``"cuda"``): the Jacobi kernel on the card.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from ..core.anndata import AnnData
from ..logging import logger_manager as lm
from ..ops.labels import connected_components
from ..ops.stencil import graph_heat_solve, jacobi_solve


def euclidean_dist(point_x, point_y) -> float:
    return math.sqrt((point_x[0] - point_y[0]) ** 2 + (point_x[1] - point_y[1]) ** 2)


def order_borderline(
    borderline_img: np.ndarray,
    pt_start: Optional[Tuple[int, int]] = None,
    pt_end: Optional[Tuple[int, int]] = None,
):
    """Order borderline pixels into a connected sequence (parity:
    reference utils.py:105-142).

    With ``pt_start``/``pt_end`` given, follows the reference exactly:
    cv2 contour trace, slice between the two points' contour indices
    (min..max+2), and return ``(ordered_bdl_list, ordered_bdl_img)`` with
    the segment re-rendered as 255-valued lines. Without them, orders ALL
    borderline pixels by nearest-neighbor chaining and returns the list.
    """
    if pt_start is not None and pt_end is not None:
        import cv2

        lm.main_info(
            f"Reorder the coordinates along the borderline with the givien start {pt_start} and end {pt_end} points."
        )
        ctrs, _ = cv2.findContours(
            np.asarray(borderline_img, np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE
        )
        ordered_bdl_img = np.zeros_like(borderline_img, dtype=np.uint8)
        ctrs_pt_list = [(pt[0][0], pt[0][1]) for pt in ctrs[0]]
        start_idx = ctrs_pt_list.index(tuple(pt_start))
        end_idx = ctrs_pt_list.index(tuple(pt_end))
        ordered_bdl_list = ctrs_pt_list[min(start_idx, end_idx) : max(start_idx, end_idx) + 2]
        for i in range(len(ordered_bdl_list) - 1):
            cv2.line(ordered_bdl_img, ordered_bdl_list[i], ordered_bdl_list[i + 1], 255, 1)
        lm.main_info(f"Extracted boundary line length: {len(ordered_bdl_list)}.")
        return ordered_bdl_list, ordered_bdl_img

    pts = np.argwhere(borderline_img != 0)[:, ::-1]  # (x, y) order
    if len(pts) == 0:
        return []
    remaining = {tuple(p) for p in pts}
    # start from an endpoint: the point with fewest neighbors
    def n_neighbors(p):
        return sum(
            (p[0] + dx, p[1] + dy) in remaining for dx in (-1, 0, 1) for dy in (-1, 0, 1) if (dx, dy) != (0, 0)
        )

    start = min(remaining, key=n_neighbors)
    seq = [start]
    remaining.discard(start)
    while remaining:
        cur = seq[-1]
        cand = [
            (cur[0] + dx, cur[1] + dy)
            for dx in (-1, 0, 1)
            for dy in (-1, 0, 1)
            if (dx, dy) != (0, 0) and (cur[0] + dx, cur[1] + dy) in remaining
        ]
        if not cand:
            # jump to the nearest remaining point
            arr = np.array(list(remaining))
            d = np.abs(arr - np.array(cur)).sum(1)
            nxt = tuple(arr[np.argmin(d)])
        else:
            nxt = cand[0]
        seq.append(nxt)
        remaining.discard(nxt)
    return seq


def segment_bd_line(borderline_list: List, column_num: int) -> np.ndarray:
    """Split a polyline into `column_num` arclength-even segments (parity:
    reference utils.py:193-259 EXACTLY, including its quirks: the
    error-compensating greedy walk over the dynamically-rebased cumulative
    arclengths, the positive-error branch selecting the PREVIOUS point, and
    the off-by-one between the arclength array (which accumulates to point
    i+1) and the point it selects (point i))."""
    pts = np.asarray(borderline_list)
    dist_ls = np.sqrt(((np.asarray(pts[1:], float) - np.asarray(pts[:-1], float)) ** 2).sum(1))
    arclen_ls = np.cumsum(dist_ls)
    arclen = float(arclen_ls[-1]) if len(arclen_ls) else 0.0
    len_per_seg = arclen / column_num
    lm.main_info(
        f"Line total length: {round(arclen, 2)}. Segmenting into {column_num} columns, with "
        f"{round(len_per_seg, 2)} each."
    )
    dynamic_arclen = np.array(arclen_ls, dtype=float)
    seg_index = []
    first = True
    error_dist = 0.0
    for i in range(len(dynamic_arclen)):
        if i == 0 or i == len(dynamic_arclen) - 1:
            seg_index.append(i)
        else:
            if (dynamic_arclen[i] >= len_per_seg) and first:
                error_dist = dynamic_arclen[i] - len_per_seg
                seg_index.append(i)
                dynamic_arclen = dynamic_arclen - dynamic_arclen[i]
                first = False
            if (dynamic_arclen[i] >= len_per_seg) and (error_dist > 0):
                error_dist = error_dist + dynamic_arclen[i - 1] - len_per_seg
                seg_index.append(i - 1)
                dynamic_arclen = dynamic_arclen - dynamic_arclen[i - 1]
            elif (dynamic_arclen[i] >= len_per_seg) and (error_dist < 0):
                error_dist = error_dist + dynamic_arclen[i] - len_per_seg
                seg_index.append(i)
                dynamic_arclen = dynamic_arclen - dynamic_arclen[i]
    return np.array(borderline_list)[seg_index]


def extend_layer(
    borderline_img: np.ndarray,
    borderline_list: List,
    extend_width: int = 10,
    device="cuda",
) -> Tuple[np.ndarray, List]:
    """Extend the borderline by `extend_width` to both sides (parity:
    reference utils.py:262); small pieces go by connected components on
    `device`."""
    import cv2

    extend_layer_mask = np.zeros_like(borderline_img, dtype=np.uint8)
    extend_layer_img = np.zeros_like(borderline_img, dtype=np.uint8)
    for pt in borderline_list:
        cv2.circle(extend_layer_mask, tuple(int(v) for v in pt), extend_width, 255, -1)
    extend_layer_contour, _ = cv2.findContours(extend_layer_mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    cv2.drawContours(extend_layer_img, extend_layer_contour, -1, 255, 1)

    extend_layer_tmp = np.zeros_like(borderline_img, dtype=np.uint8)
    cv2.circle(extend_layer_tmp, tuple(int(v) for v in borderline_list[0]), extend_width, 255, -1)
    cv2.circle(extend_layer_tmp, tuple(int(v) for v in borderline_list[-1]), extend_width, 255, -1)
    contours_edge, _ = cv2.findContours(extend_layer_tmp, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    extend_layer_tmp = np.zeros_like(borderline_img, dtype=np.uint8)
    cv2.drawContours(extend_layer_tmp, contours_edge, -1, 255, 1)
    extend_layer_img = np.where(extend_layer_tmp != 0, 0, extend_layer_img).astype(np.uint8)

    # remove small objects (skimage-free: device CCA + area filter)
    labels, n = connected_components(extend_layer_img > 0, connectivity=8, device=device)
    areas = np.bincount(labels.ravel(), minlength=n + 1)
    keep = areas >= 5
    keep[0] = False
    extend_layer_img = (keep[labels] * 255).astype(np.uint8)

    extend_layer_bdl = []
    for pt in extend_layer_contour[0]:
        pt_x, pt_y = int(pt[0][0]), int(pt[0][1])
        if extend_layer_img[pt_y, pt_x] != 0:
            extend_layer_bdl.append((pt_x, pt_y))
    return extend_layer_img, extend_layer_bdl


def draw_seg_grid(borderline_img, bdl_seg_coor_x, bdl_seg_coor_y, gridline_width: int = 1, mode: str = "grid"):
    """Draw grid lines between two segmented borderlines (parity: utils.py:145)."""
    import cv2

    seg_grid_img = np.zeros_like(borderline_img, dtype=np.uint8)
    if len(bdl_seg_coor_x) != len(bdl_seg_coor_y):
        lm.main_info("Warning: segmentation does not match between two borderlines. Using the shorter borderline.")
    min_seg_num = min(len(bdl_seg_coor_x), len(bdl_seg_coor_y))
    for i in range(min_seg_num):
        cv2.line(seg_grid_img, tuple(map(int, bdl_seg_coor_x[i])), tuple(map(int, bdl_seg_coor_y[i])), 255, gridline_width)
        if i < min_seg_num - 1:
            cv2.line(seg_grid_img, tuple(map(int, bdl_seg_coor_x[i])), tuple(map(int, bdl_seg_coor_x[i + 1])), 255, gridline_width)
            cv2.line(seg_grid_img, tuple(map(int, bdl_seg_coor_y[i])), tuple(map(int, bdl_seg_coor_y[i + 1])), 255, gridline_width)
    if mode == "grid":
        return seg_grid_img


def fill_grid_label(
    adata: AnnData,
    spatial_key: str,
    seg_grid_img: np.ndarray,
    bdl_seg_coor_x: np.ndarray,
    bdl_seg_coor_y: np.ndarray,
    curr_layer: int,
    curr_sign: int,
    layer_label_key: str = "layer_label",
    column_label_key: str = "column_label",
    init: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Flood-fill layer/column ids between segment lines and assign to buckets
    (parity: utils.py:17; per-cell lookup vectorized)."""
    import cv2

    # the greedy arclength segmentation can return one more/fewer point on
    # one side of a layer than the other (reference utils.py:228-257 walk);
    # columns pair up to the common count
    n_pair = min(len(bdl_seg_coor_x), len(bdl_seg_coor_y))
    bdl_seg_coor_x = np.asarray(bdl_seg_coor_x)[:n_pair]
    bdl_seg_coor_y = np.asarray(bdl_seg_coor_y)[:n_pair]
    layer_grid_img = seg_grid_img.copy()
    layer_mask = np.zeros((layer_grid_img.shape[0] + 2, layer_grid_img.shape[1] + 2), dtype=np.uint8)
    layer_mask[1:-1, 1:-1] = layer_grid_img
    column_grid_img = seg_grid_img.copy()
    column_mask = np.zeros((column_grid_img.shape[0] + 2, column_grid_img.shape[1] + 2), dtype=np.uint8)
    column_mask[1:-1, 1:-1] = column_grid_img

    for i in range(len(bdl_seg_coor_x) - 1):
        curr_column = i + 1
        fpx = int(np.mean([bdl_seg_coor_x[i][0], bdl_seg_coor_x[i + 1][0], bdl_seg_coor_y[i][0], bdl_seg_coor_y[i + 1][0]]))
        fpy = int(np.mean([bdl_seg_coor_x[i][1], bdl_seg_coor_x[i + 1][1], bdl_seg_coor_y[i][1], bdl_seg_coor_y[i + 1][1]]))
        cv2.floodFill(layer_grid_img, layer_mask, (fpx, fpy), curr_layer)
        cv2.floodFill(column_grid_img, column_mask, (fpx, fpy), curr_column)

    if init or layer_label_key not in adata.obs.columns:
        adata.obs[layer_label_key] = 0
    if init or column_label_key not in adata.obs.columns:
        adata.obs[column_label_key] = 0

    coords = np.asarray(adata.obsm[spatial_key]).astype(int)
    lay = layer_grid_img[coords[:, 0], coords[:, 1]].astype(int) * curr_sign
    col = column_grid_img[coords[:, 0], coords[:, 1]].astype(int)
    cur_lay = np.asarray(adata.obs[layer_label_key]).astype(int)
    cur_col = np.asarray(adata.obs[column_label_key]).astype(int)
    cur_lay = np.where(cur_lay == 0, lay, cur_lay)
    cur_col = np.where(cur_col == 0, col, cur_col)
    cur_lay[np.abs(cur_lay) == 255] = 0
    cur_col[cur_col == 255] = 0
    adata.obs[layer_label_key] = cur_lay
    adata.obs[column_label_key] = cur_col
    return layer_grid_img, column_grid_img


def field_contour_line(ctr_seq, pnt_pos, min_pnt, max_pnt) -> list:
    """Arc of a closed contour from min_pnt to max_pnt avoiding other corner
    points (parity: utils.py:317)."""
    ctr_seq_rev = ctr_seq[::-1].copy()
    min_idx = ctr_seq.index(min_pnt)
    max_idx = ctr_seq.index(max_pnt) + 1
    if min_idx < max_idx:
        if sum(pnt_pos[min_idx + 1 : max_idx - 1]) == 0:
            line_seq = ctr_seq[min_idx:max_idx]
        else:
            min_idx = ctr_seq_rev.index(min_pnt)
            max_idx = ctr_seq_rev.index(max_pnt) + 1
            line_seq = ctr_seq_rev[min_idx:] + ctr_seq_rev[:max_idx]
    else:
        if sum(pnt_pos[min_idx + 1 :]) + sum(pnt_pos[: max_idx - 1]) == 0:
            line_seq = ctr_seq[min_idx:] + ctr_seq[:max_idx]
        else:
            min_idx = ctr_seq_rev.index(min_pnt)
            max_idx = ctr_seq_rev.index(max_pnt) + 1
            line_seq = ctr_seq_rev[min_idx:max_idx]
    return line_seq


def field_contours(contour, pnt_xy, pnt_Xy, pnt_xY, pnt_XY):
    """Split a closed contour into 4 arcs at the corner points (parity:
    utils.py:360)."""
    ctr_seq = [tuple(i) for i in contour[:, 0]]
    pnt_pos = np.zeros(len(ctr_seq))
    for p in (pnt_xy, pnt_Xy, pnt_xY, pnt_XY):
        pnt_pos[ctr_seq.index(tuple(p))] = 1
    min_line_l = field_contour_line(ctr_seq, pnt_pos, tuple(pnt_xy), tuple(pnt_Xy))
    max_line_l = field_contour_line(ctr_seq, pnt_pos, tuple(pnt_xY), tuple(pnt_XY))
    min_line_c = field_contour_line(ctr_seq, pnt_pos, tuple(pnt_xy), tuple(pnt_xY))
    max_line_c = field_contour_line(ctr_seq, pnt_pos, tuple(pnt_Xy), tuple(pnt_XY))
    return min_line_l, max_line_l, min_line_c, max_line_c


def add_eh_boundary(heat_field: np.ndarray, field_line, value: float) -> None:
    """Constant Dirichlet value along an isoline (parity: utils.py:400)."""
    line = np.asarray(field_line, int)
    heat_field[line[:, 1], line[:, 0]] = value


def add_gh_boundary(heat_field: np.ndarray, field_line, value_s: float, value_e: float) -> None:
    """Linearly increasing Dirichlet values along a line (parity: utils.py:420)."""
    line = np.asarray(field_line, int)
    heat_field[line[:, 1], line[:, 0]] = np.linspace(value_s, value_e, len(line))


def effective_L2_error(heat_field_i: np.ndarray, heat_field_j: np.ndarray, field_mask: np.ndarray) -> float:
    """Masked relative L2 difference (parity: utils.py:445)."""
    return float(np.sqrt(np.sum((heat_field_j - heat_field_i) ** 2 * field_mask) / np.sum(heat_field_j**2 * field_mask)))


def domain_heat_eqn_solver(
    heat_field: np.ndarray,
    min_line,
    max_line,
    edge_line_a,
    edge_line_b,
    field_border: np.ndarray,
    field_mask: np.ndarray,
    max_err: float = 1e-10,
    max_itr: float = 1e6,
    lh: float = 1,
    hh: float = 100,
    device="cuda",
) -> np.ndarray:
    """Solve the Dirichlet heat equation over a closed domain; the sweeps run
    on `device` (reference utils.py:464 runs them on the host)."""
    init_field = np.asarray(heat_field, dtype=np.float32).copy()
    add_eh_boundary(init_field, min_line, lh)
    add_eh_boundary(init_field, max_line, hh)
    add_gh_boundary(init_field, edge_line_a, lh, hh)
    add_gh_boundary(init_field, edge_line_b, lh, hh)
    grid_field, itr, err = jacobi_solve(
        init_field, field_border, field_mask, max_err=max_err, max_itr=int(max_itr), device=device
    )
    lm.main_info(f"Total iteration: {itr} (L2 err {err:.2e})")
    return grid_field


def digitize_general(
    pc: np.ndarray,
    adj_mtx,
    boundary_lower: np.ndarray,
    boundary_upper: np.ndarray,
    max_itr: int = 100_000,
    lh: float = 1,
    hh: float = 100,
    device="cuda",
) -> np.ndarray:
    """Heat equation on a general point cloud's neighbor graph (parity:
    reference utils.py:527), on `device`."""
    from scipy import sparse

    A = sparse.coo_matrix(adj_mtx)
    v, itr, err = graph_heat_solve(
        n=pc.shape[0],
        adj_rows=A.row,
        adj_cols=A.col,
        boundary_lower=boundary_lower,
        boundary_upper=boundary_upper,
        lh=lh,
        hh=hh,
        max_itr=max_itr,
        device=device,
    )
    lm.main_info(f"Total iteration: {itr} (L2 err {err:.2e})")
    return v


# reference-named aliases for the *_old API surface (reference
# utils_old.py:283 add_ep_boundary, :303 add_gp_boundary, :347 calc_op_field:
# the same math as the current-named functions and the heat solver)
add_ep_boundary = add_eh_boundary
add_gp_boundary = add_gh_boundary


def calc_op_field(
    op_field,
    min_line,
    max_line,
    edge_line_a,
    edge_line_b,
    field_border,
    field_mask,
    max_err: float = 1e-5,
    max_itr: float = 1e5,
    lp: float = 1,
    hp: float = 100,
    device="cuda",
):
    """Weight field for given boundary weights (parity: reference
    utils_old.py:347): `domain_heat_eqn_solver` under the old parameter
    names."""
    return domain_heat_eqn_solver(
        op_field, min_line, max_line, edge_line_a, edge_line_b, field_border, field_mask,
        max_err=max_err, max_itr=max_itr, lh=lp, hh=hp, device=device,
    )
