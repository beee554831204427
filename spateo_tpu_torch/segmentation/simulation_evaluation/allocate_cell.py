"""Place elliptical cells without overlap and assign signal from empirical
distributions (capability parity: reference
simulation_evaluation/allocate_cell.py:17-223; cv2.ellipse replaced by a
vectorized ellipse rasterizer)."""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd


class Cell:
    """Ellipse parameters for one simulated cell
    (parity: allocate_cell.py:17)."""

    def __init__(self, center, axes, color, angle):
        self.center = center
        self.axes = axes
        self.color = color
        self.angle = angle

    def set_center(self, center):
        self.center = center


def _ellipse_mask(shape: Tuple[int, int], center, axes, angle_deg: float) -> np.ndarray:
    """Boolean mask of a filled rotated ellipse (cv2.ellipse thickness=-1
    equivalent). center is (x, y) following the cv2 convention."""
    h, w = shape
    a, b = max(float(axes[0]), 0.5), max(float(axes[1]), 0.5)
    cx, cy = float(center[0]), float(center[1])
    th = np.deg2rad(angle_deg)
    # bounding box to avoid full-image math
    r = int(np.ceil(max(a, b))) + 2
    x0, x1 = max(int(cx) - r, 0), min(int(cx) + r + 1, w)
    y0, y1 = max(int(cy) - r, 0), min(int(cy) + r + 1, h)
    if x0 >= x1 or y0 >= y1:
        return np.zeros(shape, bool)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    dx, dy = xx - cx, yy - cy
    u = dx * np.cos(th) + dy * np.sin(th)
    v = -dx * np.sin(th) + dy * np.cos(th)
    sub = (u / a) ** 2 + (v / b) ** 2 <= 1.0
    out = np.zeros(shape, bool)
    out[y0:y1, x0:x1] = sub
    return out


def get_center(height: int, width: int, cell_num: int, seed: int) -> List[Tuple[int, int]]:
    np.random.seed(seed)
    heights = np.random.randint(height, size=cell_num)
    widths = np.random.randint(width, size=cell_num)
    return list(zip(heights, widths))


def select_area(area_df: pd.DataFrame, cell_num: int, seed: int) -> np.ndarray:
    np.random.seed(seed)
    area_df = area_df[area_df["prob"] > 0]
    areas = np.repeat(area_df["area"].to_numpy(), area_df["cell_num"].astype(int).to_numpy())
    while len(areas) < cell_num:
        areas = np.tile(areas, 2)
    np.random.shuffle(areas)
    return areas[:cell_num]


def select_ctoa(c_to_a_ratios: np.ndarray, cell_num: int, seed: int) -> np.ndarray:
    c_to_a_ratios = np.asarray(c_to_a_ratios)
    while cell_num > len(c_to_a_ratios):
        c_to_a_ratios = np.tile(c_to_a_ratios, 2)
    np.random.seed(seed)
    np.random.shuffle(c_to_a_ratios)
    return c_to_a_ratios[:cell_num]


def get_axes_from_area_and_ltos(areas: np.ndarray, ltos: np.ndarray, seed: int) -> List[Tuple[int, int]]:
    """Ellipse axes from area + long/short ratio: S = pi*a*b, R = a/b
    (parity: allocate_cell.py:142)."""
    np.random.seed(seed)
    ltos = np.asarray(ltos, float)
    while len(areas) > len(ltos):
        ltos = np.tile(ltos, 2)
    ltos = ltos[: len(areas)]
    shorts = np.sqrt(np.asarray(areas, float) / (ltos * np.pi))
    longs = (shorts * ltos).astype(np.uint16)
    shorts = shorts.astype(np.uint16)
    return list(zip(longs, shorts))


def shift_cells(cells: List[Cell], labels: np.ndarray, max_iter: int, seed: int, shift_length: int = 10) -> None:
    """Greedy non-overlap placement: draw each cell; on collision, shift by
    a random offset and retry (parity: allocate_cell.py:49)."""
    first = _ellipse_mask(labels.shape, cells[0].center, cells[0].axes, 0.0)
    labels[first] = cells[0].color
    deal_list = list(cells[1:])
    np.random.seed(seed)
    center_shifts = np.random.randint(-shift_length, shift_length + 1, 2 * max_iter + 2).reshape(-1, 2)
    c = 0
    while deal_list:
        c += 1
        one = deal_list.pop(0)
        m = _ellipse_mask(labels.shape, one.center, one.axes, one.angle)
        if (labels[m] > 0).any() or not m.any():
            tmp = np.array(one.center) - center_shifts[c]
            tmp[tmp < 0] = 0
            tmp[0] = min(labels.shape[1] - 1, tmp[0])
            tmp[1] = min(labels.shape[0] - 1, tmp[1])
            one.set_center(tuple(tmp))
            deal_list.append(one)
        else:
            labels[m] = one.color
        if c >= max_iter:
            print("max iteration has reached, please check the result.")
            break


def get_cell_pos(
    area_df: pd.DataFrame,
    ltos: np.ndarray,
    cell_num: int = 100,
    height: int = 500,
    width: int = 500,
    seed: int = 1,
    max_iter: int = 20000,
    shift_length: int = 100,
) -> np.ndarray:
    """Place `cell_num` non-overlapping ellipses; returns the label image
    (parity: allocate_cell.py:28)."""
    labels = np.zeros([height, width], dtype=np.uint16)
    areas = select_area(area_df, cell_num, seed)
    axes = get_axes_from_area_and_ltos(areas, ltos, seed)
    centers = get_center(height, width, cell_num, seed)
    np.random.seed(seed)
    angles = np.random.rand(cell_num) * 360
    cells = [Cell(centers[i], axes[i], i + 1, angles[i]) for i in range(cell_num)]
    shift_cells(cells, labels, max_iter, seed, shift_length)
    return labels


def add_sig_to_cell(labels: np.ndarray, cell_mean_df: pd.DataFrame, bg_mean_df: pd.DataFrame, seed: int) -> np.ndarray:
    """Sample per-pixel signal from the empirical fg/bg distributions
    (parity: allocate_cell.py:160)."""
    rng = np.random.default_rng(seed)
    sigs = np.zeros_like(labels, dtype=np.int16)
    for df, mask in ((cell_mean_df, labels > 0), (bg_mean_df, labels == 0)):
        df = df[df["prob"] > 0]
        vals = df.index.to_numpy()
        p = df["prob"].to_numpy()
        p = p / p.sum()
        sigs[mask] = rng.choice(vals, size=int(mask.sum()), p=p)
    return sigs


def simulate_cell_and_sig(
    area_df: pd.DataFrame,
    ltos: np.ndarray,
    cell_sig_df: pd.DataFrame,
    bg_sig_df: pd.DataFrame,
    prefix: str,
    cell_num: int = 100,
    height: int = 500,
    width: int = 500,
    seed: int = 1,
    max_iter: int = 20000,
    shift_length: int = 100,
):
    """Full simulation: placement + signal; writes the GEM-format txt and a
    labels .npy (parity: allocate_cell.py:185 — pickle replaced by npy)."""
    labels = get_cell_pos(area_df, ltos, cell_num, height, width, seed, max_iter, shift_length)
    sigs = add_sig_to_cell(labels, cell_sig_df, bg_sig_df, seed)
    os.makedirs(prefix, exist_ok=True)
    out_file = os.path.join(prefix, f"seed{seed}.txt")
    x, y = np.where(sigs > 0)
    pd.DataFrame({"geneID": "Malat1", "x": x, "y": y, "MIDCounts": sigs[sigs > 0]}).to_csv(out_file, sep="\t", index=False)
    np.save(os.path.join(prefix, f"seed{seed}.labels.npy"), labels)
    return labels, sigs


def get_axes_from_area_and_ctoa(areas: np.ndarray, ctoas: np.ndarray, seed: int) -> List[Tuple[int, int]]:
    """Ellipse axes from area + circumference/area ratio
    (parity: reference allocate_cell.py:124): with S = pi a b and
    R = C/S, x = R S, y = S/pi -> long = sqrt(y - pi y/2 + x/4),
    short = y/long."""
    areas = np.asarray(areas, float)
    ctoas = np.asarray(ctoas, float)
    while len(areas) > len(ctoas):
        ctoas = np.tile(ctoas, 2)
    ctoas = ctoas[: len(areas)]
    x = ctoas * areas
    y = areas / np.pi
    longs = np.sqrt(np.maximum(y - np.pi * y / 2 + x / 4, 1.0))
    shorts = np.maximum(y / longs, 1.0)
    return list(zip(longs.astype(np.uint16), shorts.astype(np.uint16)))
