"""Interactive AGG-raster exploration (counterpart of
`spateo_tpu.plotting.interactive.agg`; reference
spateo/plotting/interactive/agg.py:23 `contours`, :79 `select_polygon`, :183
`cellbin_select` — plotly/cv2 replaced by matplotlib + vectorized boundary
tracing; the PolygonSelector workflow is preserved, and every entry point
also works headlessly via the returned selector's `onselect`).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np

from ...configuration import SKM
from ...errors import PlottingError
from ..agg import imshow
from ..utils import DEFAULT_PALETTE, _pyplot


def contours(adata, layer: str, colors: Optional[List] = None, scale: float = 0.05):
    """Density-bin boundary overview (parity: reference interactive/agg.py:23;
    the plotly figure is replaced by a matplotlib axes with one boundary
    line-collection per bin)."""
    plt = _pyplot()

    if SKM.get_adata_type(adata) != SKM.ADATA_AGG_TYPE:
        raise PlottingError("Only `AGG` type AnnDatas are supported.")
    bins = np.asarray(SKM.select_layer_data(adata, layer, make_dense=True))
    colors = colors or DEFAULT_PALETTE
    fig, ax = plt.subplots(figsize=(max(3, bins.shape[1] * scale), max(3, bins.shape[0] * scale)))
    for i, b in enumerate(np.unique(bins)):
        if b <= 0:
            continue
        m = bins == b
        pad = np.pad(m, 1)
        boundary = m & ~(
            pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:]
        )
        ys, xs = np.nonzero(boundary)
        ax.scatter(xs, ys, s=1, color=colors[i % len(colors)], label=f"bin {int(b)}", linewidths=0)
    ax.invert_yaxis()
    ax.set_aspect("equal")
    ax.legend(fontsize=7, markerscale=5, frameon=False, loc="center left", bbox_to_anchor=(1, 0.5))
    return fig


def select_polygon(
    adata,
    layer: str,
    out_layer: Optional[str] = None,
    ax: Optional[Axes] = None,
    background: Optional[str] = None,
    **kwargs,
) -> PolygonSelector:
    """Interactive polygon selection over an AGG image: the enclosed pixels
    are written as a boolean mask layer (parity: reference
    interactive/agg.py:79). Esc resets. Returns the live PolygonSelector —
    headless drivers can call `selector.onselect(vertices)` directly."""
    from matplotlib.path import Path as MplPath
    from matplotlib.widgets import PolygonSelector

    plt = _pyplot()

    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 5), tight_layout=True)
    else:
        fig = ax.get_figure()
    kwargs["save_show_or_return"] = "return"
    kwargs.setdefault("interpolation", "none")
    imshow(adata, layer, ax=ax, **kwargs)
    out_layer = out_layer or SKM.gen_new_layer_key(layer, SKM.SELECTION_SUFFIX)

    h, w = adata.shape
    overlay = ax.imshow(np.zeros((h, w, 4), np.uint8), extent=ax.get_images()[0].get_extent())
    extent = ax.get_images()[0].get_extent()
    # pixel-center grid in data coordinates for point-in-polygon tests
    x0, x1, y1, y0 = extent  # imshow extent is (left, right, bottom, top)
    xs = np.linspace(x0, x1, w, endpoint=False) + (x1 - x0) / (2 * w)
    ys = np.linspace(y0, y1, h, endpoint=False) + (y1 - y0) / (2 * h)
    XX, YY = np.meshgrid(xs, ys)
    grid = np.stack([XX.ravel(), YY.ravel()], 1)

    def onselect(verts):
        path = MplPath(np.asarray(verts, float))
        mask = path.contains_points(grid).reshape(h, w)
        SKM.set_layer_data(adata, out_layer, mask)
        rgba = np.zeros((h, w, 4), np.uint8)
        rgba[~mask, 3] = 126  # dim everything outside the selection
        overlay.set_data(rgba)
        fig.canvas.draw_idle()

    def key_press_event(event):
        if event.key == "escape":
            overlay.set_data(np.zeros((h, w, 4), np.uint8))
            if out_layer in adata.layers:
                del adata.layers[out_layer]
            fig.canvas.draw_idle()

    selector = PolygonSelector(ax=ax, onselect=onselect)
    fig.canvas.mpl_connect("key_press_event", key_press_event)
    ax.set_title("Draw polygon with mouse.\nHold Ctrl to click and drag vertices.\nPress Esc to reset selection.", fontsize=8)
    return selector


def cellbin_select(
    adata,
    binsize: int = 50,
    spatial_key: str = "spatial",
    layer: Optional[str] = None,
    scale: float = 0.5,
    scale_unit: str = "um",
    return_all: bool = False,
):
    """Select cells by polygon on a binned total-count image of a UMI-type
    AnnData (parity: reference interactive/agg.py:183)."""
    from scipy.sparse import issparse

    from ...core.anndata import AnnData

    if SKM.get_adata_type(adata) != SKM.ADATA_UMI_TYPE:
        raise PlottingError("Only `UMI` type AnnDatas are supported.")
    half_bin = binsize / 2
    expression = adata.layers[layer] if layer else adata.X
    agg = np.asarray(expression.sum(axis=1)).ravel()
    coor = np.column_stack([np.asarray(adata.obsm[spatial_key])[:, :2], agg]).astype(int)
    coor[:, 0] = ((coor[:, 0] - half_bin) / binsize).astype(int)
    coor[:, 1] = ((coor[:, 1] - half_bin) / binsize).astype(int)
    coor[:, :2] = np.maximum(coor[:, :2], 0)
    img = np.zeros((coor[:, 0].max() + 1, coor[:, 1].max() + 1), int)
    np.maximum.at(img, (coor[:, 0], coor[:, 1]), coor[:, 2])

    import pandas as pd

    cellbin_img = AnnData(
        X=img.astype(np.float32),
        obs=pd.DataFrame(index=[str(i) for i in range(img.shape[0])]),
        var=pd.DataFrame(index=[str(j) for j in range(img.shape[1])]),
    )
    cellbin_img.layers["spliced"] = img.astype(np.float32)
    cellbin_img.uns["__type"] = SKM.ADATA_AGG_TYPE
    cellbin_img.uns["pp"] = {}
    cellbin_img.uns["spatial"] = {"scale": scale, "scale_unit": scale_unit}

    selection = select_polygon(cellbin_img, layer="spliced")
    if return_all:
        return selection, cellbin_img
    return selection
