"""Domain contouring (capability parity: reference
spateo/digitization/contour.py:17,97,163).

Counterpart of `spateo_tpu.digitization.contour`: OpenCV on the host,
imported inside each function."""

from __future__ import annotations

import random
from typing import List, Optional, Tuple, Union

import numpy as np

from ..configuration import SKM
from ..core.anndata import AnnData
from ..logging import logger_manager as lm


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def gen_cluster_image(
    adata: AnnData,
    bin_size: Optional[int] = None,
    spatial_key: str = "spatial",
    cluster_key: str = "scc",
    label_mapping_key: str = "cluster_img_label",
    cmap: str = "tab20",
    show: bool = False,
) -> np.ndarray:
    """Rasterize cluster labels into an integer image (parity: contour.py:17)."""
    import cv2

    if bin_size is None:
        bin_size = adata.uns.get("bin_size", 1)

    cluster_list = np.unique(np.asarray(adata.obs[cluster_key]))
    mapping = {c: i + 1 for i, c in enumerate(cluster_list)}
    labels = np.asarray([mapping[c] for c in adata.obs[cluster_key]])
    adata.obs[label_mapping_key] = labels

    coords = np.asarray(adata.obsm[spatial_key])
    max_coords = [int(coords[:, 0].max()) + 1, int(coords[:, 1].max()) + 1]
    cluster_label_image = np.zeros((max_coords[0], max_coords[1]), np.uint8)
    radius = max(bin_size // 2, 1)
    for i in range(adata.n_obs):
        cv2.circle(
            img=cluster_label_image,
            center=(int(coords[i, 1]), int(coords[i, 0])),
            radius=radius,
            color=int(labels[i]),
            thickness=-1,
        )

    if show:
        import matplotlib as mpl
        import matplotlib.pyplot as plt

        cm = mpl.colormaps[cmap]
        colors = (np.array([cm(i)[:3] for i in range(cm.N)]) * 255).astype(int)
        random.seed(1)
        sampled = random.sample(list(map(tuple, colors)), len(cluster_list))
        rgb = np.zeros((*cluster_label_image.shape, 3), np.uint8)
        for i in range(1, len(cluster_list) + 1):
            rgb[cluster_label_image == i] = sampled[i - 1]
        plt.imshow(rgb)
    return cluster_label_image


def extract_cluster_contours(
    cluster_label_image: np.ndarray,
    cluster_labels: Union[int, List],
    bin_size: int,
    k_size: float = 2,
    min_area: float = 9,
    close_kernel: int = 2,  # cv2.MORPH_ELLIPSE
    show: bool = False,
) -> Tuple[Tuple, np.ndarray, np.ndarray]:
    """Extract contours of the area formed by given cluster label(s)
    (parity: contour.py:97). Returns (contours, filled image, contour image)."""
    import cv2

    k_size = int(k_size * bin_size)
    if k_size % 2 == 0:
        k_size += 1
    min_area = min_area * bin_size * bin_size
    labels = np.atleast_1d(np.asarray(cluster_labels))
    mask = np.isin(cluster_label_image, labels).astype(np.uint8) * 255
    kernel = cv2.getStructuringElement(close_kernel, (k_size, k_size))
    closed = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel)
    contours, _ = cv2.findContours(closed, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    contours = tuple(c for c in contours if cv2.contourArea(c) >= min_area)
    ctrs_img = np.zeros_like(mask)
    filled_img = np.zeros_like(mask)
    cv2.drawContours(ctrs_img, contours, -1, 255, 1)
    cv2.drawContours(filled_img, contours, -1, 255, cv2.FILLED)
    if show:
        import matplotlib.pyplot as plt

        plt.imshow(ctrs_img, cmap="gray")
    return contours, filled_img, ctrs_img


def set_domains(
    adata_high_res: AnnData,
    adata_low_res: Optional[AnnData] = None,
    spatial_key: str = "spatial",
    cluster_key: str = "scc",
    domain_key_prefix: str = "domain",
    bin_size_high: Optional[int] = None,
    bin_size_low: Optional[int] = None,
    k_size: float = 2,
    min_area: float = 9,
) -> None:
    """Assign every high-res bucket to a cluster-derived spatial domain
    (parity: contour.py:163)."""
    domain_key = domain_key_prefix + "_" + cluster_key
    if bin_size_high is None:
        bin_size_high = adata_high_res.uns.get("bin_size", 1)
    if adata_low_res is None:
        adata_low_res = adata_high_res
        bin_size_low = bin_size_high
    elif bin_size_low is None:
        bin_size_low = adata_low_res.uns.get("bin_size", 1)

    cluster_label_image = gen_cluster_image(
        adata_low_res, bin_size=bin_size_low, spatial_key=spatial_key, cluster_key=cluster_key, show=False
    )

    u, count = np.unique(np.asarray(adata_low_res.obs[cluster_key]), return_counts=True)
    order = np.argsort(-count)
    cluster_ids = [str(c) for c in u[order]]
    ul, countl = np.unique(np.asarray(adata_low_res.obs["cluster_img_label"]), return_counts=True)
    cluster_labels = list(ul[np.argsort(-countl)])

    domains = np.full(adata_high_res.n_obs, "NA", dtype=object)
    coords = np.asarray(adata_high_res.obsm[spatial_key]).astype(int)
    H, W = cluster_label_image.shape
    for cid, clabel in zip(cluster_ids, cluster_labels):
        ctrs, filled_img, _ = extract_cluster_contours(
            cluster_label_image, clabel, bin_size=bin_size_low, k_size=k_size, min_area=min_area, show=False
        )
        inside = (
            (coords[:, 0] >= 0)
            & (coords[:, 0] < H)
            & (coords[:, 1] >= 0)
            & (coords[:, 1] < W)
        )
        hit = np.zeros(adata_high_res.n_obs, bool)
        hit[inside] = filled_img[coords[inside, 0], coords[inside, 1]] > 0
        domains = np.where(hit & (domains == "NA"), cid, domains)
    adata_high_res.obs[domain_key] = domains
