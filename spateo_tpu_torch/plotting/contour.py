"""Spatial-domain contour image (counterpart of
`spateo_tpu.plotting.contour`; reference
spateo/plotting/static/contour.py:14 `spatial_domains` — cv2 findContours
replaced by a vectorized 4-neighbor boundary mask).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from .utils import _pyplot


def spatial_domains(
    adata,
    bin_size: Optional[int] = None,
    spatial_key: str = "spatial",
    label_key: str = "cluster_img_label",
    plot_size: Tuple[float, float] = (3, 3),
    save_img: Optional[str] = None,
):
    """Rasterize cluster labels onto a bin grid and draw domain contours
    (parity: reference contour.py:14)."""
    plt = _pyplot()

    labels_raw = np.asarray(adata.obs[label_key])
    cats = np.unique(labels_raw)
    labels = np.searchsorted(cats, labels_raw) + 1

    if bin_size is None:
        bin_size = adata.uns.get("bin_size", 1)
    pts = np.asarray(adata.obsm[spatial_key])[:, :2]
    ix = (pts[:, 0] // bin_size).astype(int)
    iy = (pts[:, 1] // bin_size).astype(int)
    label_img = np.zeros((ix.max() + 1, iy.max() + 1))
    label_img[ix, iy] = labels

    # boundary pixels: label differs from any 4-neighbor (inside a domain)
    contour_img = np.full_like(label_img, 255.0)
    pad = np.pad(label_img, 1, mode="edge")
    diff = (
        (pad[:-2, 1:-1] != label_img)
        | (pad[2:, 1:-1] != label_img)
        | (pad[1:-1, :-2] != label_img)
        | (pad[1:-1, 2:] != label_img)
    )
    contour_img[diff & (label_img > 0)] = 0.5

    fig = plt.figure(figsize=plot_size)
    plt.imshow(contour_img, cmap="tab20", origin="lower")
    if save_img:
        plt.imsave(save_img, contour_img.astype(np.uint8), cmap="gray")
    return contour_img
