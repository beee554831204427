"""Image IO (counterpart of `spateo_tpu.io.image`; reference
spateo/io/image.py:12, image_utils.py:9). Host code, copied; OpenCV is
imported inside `read_image`."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.anndata import AnnData


def add_image_layer(
    adata: AnnData,
    img: np.ndarray,
    scale_factor: float,
    slice: Optional[str] = None,
    img_layer: Optional[str] = None,
) -> AnnData:
    """Store an image + its scale factor under
    ``.uns['spatial'][slice]['images'/'scalefactors'][img_layer]``."""
    spatial = adata.uns.setdefault("spatial", {})
    entry = spatial.setdefault(slice, {})
    entry.setdefault("images", {})[img_layer] = img
    entry.setdefault("scalefactors", {})[img_layer] = scale_factor
    return adata


def read_image(
    adata: AnnData,
    filename: str,
    scale_factor: float,
    slice: Optional[str] = None,
    img_layer: Optional[str] = None,
) -> AnnData:
    """Load an image file into the AnnData's spatial namespace."""
    import cv2

    img = cv2.imread(filename)
    if img is None:
        raise FileNotFoundError(f"Could not find '{filename}'")
    return add_image_layer(adata, img, scale_factor, slice, img_layer)
