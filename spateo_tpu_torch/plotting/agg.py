"""Aggregated-image (bin) plotting (counterpart of
`spateo_tpu.plotting.agg`; reference spateo/plotting/static/agg.py:25
`imshow`, :170 `box_qc_regions`, :258 `qc_regions`).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np

from ..configuration import SKM
from .utils import DEFAULT_PALETTE, _pyplot, save_return_show_fig_utils


def _layer_image(adata, layer: str) -> np.ndarray:
    from scipy.sparse import issparse

    M = adata.X if layer in (None, SKM.X_LAYER, "X") else adata.layers[layer]
    return np.asarray(M.toarray() if issparse(M) else M)


def _labels_cmap(img: np.ndarray) -> ListedColormap:
    from matplotlib.colors import ListedColormap

    n = int(img.max()) + 1
    rng = np.random.default_rng(0)
    colors = np.asarray([DEFAULT_PALETTE[i % len(DEFAULT_PALETTE)] for i in rng.permutation(max(n - 1, 1))], dtype=object)
    return ListedColormap(["black"] + list(colors))


def imshow(
    adata,
    layer: str = SKM.X_LAYER,
    ax: Optional[Axes] = None,
    show_cbar: bool = False,
    use_scale: bool = True,
    absolute: bool = False,
    labels: bool = False,
    downscale: float = 1.0,
    downscale_interpolation=None,
    background: Optional[str] = None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[Dict] = None,
    **kwargs,
) -> Optional[Tuple]:
    """Display an AGG-type AnnData as an image (parity: reference agg.py:25).
    `labels=True` renders integer segmentation labels with a categorical
    palette (0 = background, black)."""
    plt = _pyplot()

    if SKM.get_adata_type(adata) != SKM.ADATA_AGG_TYPE:
        raise ValueError("imshow requires an AGG-type AnnData (pixel grid)")
    img = _layer_image(adata, layer)
    if downscale < 1.0:
        step = max(int(round(1.0 / downscale)), 1)
        img = img[::step, ::step]

    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 8 * img.shape[0] / max(img.shape[1], 1)))
    else:
        fig = ax.figure

    extent = None
    unit = None
    xlabel, ylabel = "Y", "X"
    if use_scale and SKM.UNS_SPATIAL_KEY in adata.uns:
        sp = adata.uns[SKM.UNS_SPATIAL_KEY]
        binsize = sp.get(SKM.UNS_SPATIAL_BINSIZE_KEY, 1) or 1
        scale = (sp.get(SKM.UNS_SPATIAL_SCALE_KEY, 1.0) or 1.0) * binsize
        unit = sp.get(SKM.UNS_SPATIAL_SCALE_UNIT_KEY)
        h, w = img.shape[:2]
        x0 = y0 = 0.0
        if absolute:
            try:
                x0 = float(str(adata.obs_names[0]))
                y0 = float(str(adata.var_names[0]))
            except (ValueError, IndexError):
                pass
        extent = (x0 * scale, (x0 + w) * scale, (y0 + h) * scale, y0 * scale)
        if unit is not None:
            xlabel += f" ({unit})"
            ylabel += f" ({unit})"

    # overlay-consistency guards (reference agg.py:128-141): drawing onto an
    # axes that already holds an image requires matching shape and extent
    from ..errors import PlottingError

    if any(img.shape[:2] != im.get_array().shape[:2] for im in ax.get_images()):
        raise PlottingError(
            f"The dimensions of the matrix, {img.shape[:2]} must be equal to the dimensions of "
            "the images present in the axis. Make sure you are using the same AnnData and the `downscale` "
            "argument as you used to show the previous image(s)."
        )
    if extent is not None and any(
        not np.allclose(extent, im.get_extent(), atol=0.5) for im in ax.get_images()
    ):
        raise PlottingError(
            f"The extent of the matrix, {extent} must be equal to the extent of the images present in the "
            "axis. Make sure you are using the same AnnData and the `use_scale` and `absolute` arguments as "
            "you used to show the previous image(s)."
        )

    if labels:
        kwargs.setdefault("cmap", _labels_cmap(img))
        kwargs.setdefault("interpolation", "nearest")
    im = ax.imshow(img, extent=extent, **kwargs)
    ax.set_title(layer)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if show_cbar and not labels:
        plt.colorbar(im, ax=ax, shrink=0.7)
    return save_return_show_fig_utils(save_show_or_return, False, background, "imshow", save_kwargs, 1, fig, (fig, ax))


def box_qc_regions(
    adata,
    layer: str = SKM.X_LAYER,
    use_scale: bool = True,
    box_kwargs: Optional[Dict] = None,
    ax: Optional[Axes] = None,
    background: Optional[str] = None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[Dict] = None,
    **kwargs,
):
    """Draw the stored QC-region boxes over the full image
    (parity: reference agg.py:170; regions from `select_qc_regions`,
    stored at `.uns['spatial']['qc']` as [n, 4] xmin/xmax/ymin/ymax)."""
    from matplotlib.patches import Rectangle

    regions = np.asarray(adata.uns[SKM.UNS_SPATIAL_KEY][SKM.UNS_SPATIAL_QC_KEY])
    out = imshow(adata, layer, ax=ax, use_scale=use_scale, save_show_or_return="return", **kwargs)
    fig, ax = out
    bk = dict(fill=False, edgecolor="red", linewidth=1)
    bk.update(box_kwargs or {})
    scale = 1.0
    if use_scale and SKM.UNS_SPATIAL_KEY in adata.uns:
        scale = adata.uns[SKM.UNS_SPATIAL_KEY].get(SKM.UNS_SPATIAL_SCALE_KEY, 1.0) or 1.0
    for xmin, xmax, ymin, ymax in regions:
        ax.add_patch(Rectangle((ymin * scale, xmin * scale), (ymax - ymin) * scale, (xmax - xmin) * scale, **bk))
    return save_return_show_fig_utils(save_show_or_return, False, background, "box_qc_regions", save_kwargs, 1, fig, (fig, ax))


def qc_regions(
    adata,
    layer: str = SKM.X_LAYER,
    axes=None,
    ncols: int = 1,
    background: Optional[str] = None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[Dict] = None,
    **kwargs,
):
    """Plot each QC region as its own panel (parity: reference agg.py:258)."""
    plt = _pyplot()

    regions = np.asarray(adata.uns[SKM.UNS_SPATIAL_KEY][SKM.UNS_SPATIAL_QC_KEY])
    n = len(regions)
    ncols = min(ncols if ncols > 1 else int(np.ceil(np.sqrt(n))), max(n, 1))
    nrows = int(np.ceil(n / ncols))
    img = _layer_image(adata, layer)
    if axes is None:
        fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 4 * nrows), squeeze=False)
        axes_flat = axes.ravel()
    else:
        axes_flat = np.ravel(axes)
        fig = axes_flat[0].figure
    for i, (xmin, xmax, ymin, ymax) in enumerate(regions):
        crop = img[int(xmin):int(xmax), int(ymin):int(ymax)]
        axes_flat[i].imshow(crop, **kwargs)
        axes_flat[i].set_title(f"({int(xmin)}:{int(xmax)}, {int(ymin)}:{int(ymax)})", fontsize=8)
    for j in range(n, len(axes_flat)):
        axes_flat[j].axis("off")
    return save_return_show_fig_utils(save_show_or_return, False, background, "qc_regions", save_kwargs, n, fig, axes_flat[:n])
