"""Empirical distributions from real stains/labels, used to parameterize the
simulator (capability parity: reference simulation_evaluation/prepare.py:12-111;
cv2 imread/contours replaced by imageio + vectorized boundary counting).

All functions accept either file paths (.tif) or in-memory arrays."""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import pandas as pd


def _load(x) -> np.ndarray:
    if isinstance(x, (str, bytes)):
        import imageio.v2 as imageio

        return np.asarray(imageio.imread(x))
    return np.asarray(x)


def get_fb_dis(image_tif, labels_tif) -> pd.DataFrame:
    """Foreground/background signal-intensity distributions
    (parity: prepare.py:12)."""
    data = _load(image_tif).astype(np.int64)
    labels = _load(labels_tif)
    cell_sigs = np.bincount(data[labels > 0].ravel()) / max(np.sum(labels > 0), 1)
    bg_sigs = np.bincount(data[labels == 0].ravel()) / max(np.sum(labels == 0), 1)
    n = max(len(cell_sigs), len(bg_sigs))
    cell_sigs = np.pad(cell_sigs, (0, n - len(cell_sigs)))
    bg_sigs = np.pad(bg_sigs, (0, n - len(bg_sigs)))
    return pd.DataFrame({"signal": range(n), "cell_sigs": cell_sigs, "bg_sigs": bg_sigs}).set_index("signal")


def cell_area_dis(labels_tifs: Sequence) -> pd.DataFrame:
    """Distribution of cell areas across label images (parity: prepare.py:36)."""
    all_areas = []
    for lt in labels_tifs:
        labels = _load(lt)
        all_areas.extend(list(np.bincount(labels.ravel().astype(np.int64))[1:]))
    all_areas = np.asarray(all_areas)
    all_areas = all_areas[all_areas > 0]
    area_dis = np.bincount(all_areas)
    return pd.DataFrame({"area": range(len(area_dis)), "cell_num": area_dis, "prob": area_dis / max(area_dis.sum(), 1)})


def _perimeter(mask: np.ndarray) -> float:
    """Boundary length of a binary mask: count of exposed 4-neighbor faces."""
    m = mask.astype(bool)
    pad = np.pad(m, 1)
    exposed = (
        (pad[1:-1, 1:-1] & ~pad[:-2, 1:-1]).sum()
        + (pad[1:-1, 1:-1] & ~pad[2:, 1:-1]).sum()
        + (pad[1:-1, 1:-1] & ~pad[1:-1, :-2]).sum()
        + (pad[1:-1, 1:-1] & ~pad[1:-1, 2:]).sum()
    )
    return float(exposed)


def c_to_a_ratio_dis(labels_tif) -> np.ndarray:
    """Per-cell perimeter/area ratios (parity: prepare.py:53)."""
    labels = _load(labels_tif)
    out = []
    for c in np.unique(labels):
        if c <= 0:
            continue
        m = labels == c
        out.append(_perimeter(m) / max(m.sum(), 1))
    return np.asarray(out)


def ltos_ratio_dis(labels_tifs: Sequence) -> np.ndarray:
    """Long-to-short axis ratio per cell via the label's covariance
    eigenvalues (parity: prepare.py:67; cv2 minAreaRect replaced by PCA
    axes)."""
    out = []
    for lt in labels_tifs:
        labels = _load(lt)
        for c in np.unique(labels):
            if c <= 0:
                continue
            ys, xs = np.nonzero(labels == c)
            if len(ys) < 3:
                continue
            cov = np.cov(np.stack([ys, xs]))
            ev = np.sort(np.linalg.eigvalsh(cov))
            if ev[0] <= 1e-9:
                continue
            out.append(float(np.sqrt(ev[1] / ev[0])))
    return np.asarray(out)


def get_fb_dis_window(image_tif, labels_tif, win: int = 200) -> Tuple[pd.DataFrame, pd.DataFrame, pd.DataFrame, pd.DataFrame]:
    """Windowed signal distributions (parity: prepare.py:85)."""
    data = _load(image_tif).astype(np.int64)
    labels = _load(labels_tif)
    cell_rows, bg_rows = [], []
    nmax = int(data.max()) + 1
    for i in range(0, data.shape[0], win):
        for j in range(0, data.shape[1], win):
            d = data[i : i + win, j : j + win]
            l = labels[i : i + win, j : j + win]
            cs = np.bincount(d[l > 0].ravel(), minlength=nmax) / max((l > 0).sum(), 1)
            bs = np.bincount(d[l == 0].ravel(), minlength=nmax) / max((l == 0).sum(), 1)
            cell_rows.append(cs[:nmax])
            bg_rows.append(bs[:nmax])
    cell_df = pd.DataFrame(np.stack(cell_rows), columns=range(nmax))
    bg_df = pd.DataFrame(np.stack(bg_rows), columns=range(nmax))
    cell_mean_df = pd.DataFrame({"prob": cell_df.mean(axis=0)})
    bg_mean_df = pd.DataFrame({"prob": bg_df.mean(axis=0)})
    return cell_df, bg_df, cell_mean_df, bg_mean_df
