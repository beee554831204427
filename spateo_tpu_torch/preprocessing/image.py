"""Image preprocessing (counterpart of `spateo_tpu.preprocessing.image`;
reference spateo/preprocessing/image.py:12). Host code, copied; OpenCV's
Otsu threshold is imported inside `remove_background`, matplotlib where it
draws."""

from __future__ import annotations

from typing import Optional, Union

from ..core.anndata import AnnData
from ..io.image import add_image_layer


def remove_background(
    adata: AnnData,
    threshold: Union[float, str] = "auto",
    slice: Optional[str] = None,
    used_img_layer: Optional[str] = None,
    return_img_layer: Optional[str] = None,
    inplace: bool = False,
    show: bool = False,
) -> Optional[AnnData]:
    """Zero out image pixels below a global (Otsu by default) threshold."""
    import cv2

    if not inplace:
        adata = adata.copy()
    img = adata.uns["spatial"][slice]["images"][used_img_layer].copy()
    scale_factor = adata.uns["spatial"][slice]["scalefactors"][used_img_layer]
    if threshold == "auto":
        threshold, _ = cv2.threshold(img.copy(), 0, 255, cv2.THRESH_OTSU)
    _, img = cv2.threshold(img.copy(), threshold, 255, cv2.THRESH_TOZERO)
    adata = add_image_layer(adata, img, scale_factor, slice, return_img_layer)
    if show:
        import matplotlib.pyplot as plt

        plt.figure(figsize=(16, 16))
        plt.imshow(img, "gray")
    return adata if not inplace else None
