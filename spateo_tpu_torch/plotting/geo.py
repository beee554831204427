"""Geometry (cell-polygon) plots (counterpart of `spateo_tpu.plotting.geo`;
reference spateo/plotting/static/geo.py:19 `geo`, :137 `space_polygons`,
colorlabel.py:15 `color_label`).

The reference renders shapely polygons via geopandas; here cell contours are
plain vertex arrays (lists of [K, 2]) stored in `.obs[basis]` or
`.uns['contours']`, rendered with a matplotlib PolyCollection — no GIS stack
needed.

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Union

import numpy as np
import pandas as pd

from .utils import (
    DEFAULT_PALETTE,
    _get_adata_color_vec,
    _pyplot,
    check_colornorm,
    resolve_cmap,
    save_return_show_fig_utils,
)


def _get_polygons(adata, basis: str) -> List[np.ndarray]:
    """Resolve per-cell polygons: `.obs[basis]` holding vertex arrays, or
    `.uns[basis]` as a dict name->vertices. Falls back to small squares at
    the spatial coordinates so plots degrade gracefully."""
    if basis in adata.obs.columns:
        vals = adata.obs[basis].values
        if len(vals) and not np.isscalar(vals[0]):
            return [np.asarray(v, dtype=float).reshape(-1, 2) for v in vals]
    if basis in adata.uns and isinstance(adata.uns[basis], dict):
        d = adata.uns[basis]
        return [np.asarray(d[n], dtype=float).reshape(-1, 2) for n in adata.obs_names if n in d]
    # fallback: unit squares centered on spatial coordinates
    key = "spatial" if "spatial" in adata.obsm else list(adata.obsm)[0]
    pts = np.asarray(adata.obsm[key])[:, :2]
    sub = pts[: min(len(pts), 500)]
    d2 = ((sub[:, None] - sub[None, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    r = 0.5 * float(np.sqrt(np.median(d2.min(1))))
    sq = np.asarray([[-r, -r], [r, -r], [r, r], [-r, r]])
    return [p + sq for p in pts]


def geo(
    adata,
    basis: str = "contour",
    color: Union[str, list, None] = None,
    genes: Optional[List[str]] = None,
    color_key=None,
    dpi: int = 100,
    boundary_width: float = 0.2,
    boundary_color="black",
    figsize=(6, 6),
    aspect: str = "equal",
    ax=None,
    cmap: Optional[str] = None,
    alpha: float = 0.8,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    *args,
    **kwargs,
):
    """Geometry plot of cell polygons colored by obs/gene values
    (parity: reference geo.py:19)."""
    from matplotlib.collections import PolyCollection

    plt = _pyplot()

    colors = [color] if isinstance(color, str) else list(color or [])
    colors += [genes] if isinstance(genes, str) else list(genes or [])
    polys = _get_polygons(adata, basis)
    n = max(len(colors), 1)
    if ax is None:
        fig, axes = plt.subplots(1, n, figsize=(figsize[0] * n, figsize[1]), dpi=dpi, squeeze=False)
        axes_flat = axes.ravel()
    else:
        fig = ax.figure
        axes_flat = np.asarray([ax])

    for i in range(n):
        a = axes_flat[min(i, len(axes_flat) - 1)]
        if colors:
            vals = _get_adata_color_vec(adata, "X", colors[i])
        else:
            vals = np.arange(len(polys))
        numeric = np.issubdtype(np.asarray(vals).dtype, np.number)
        if numeric:
            cm = resolve_cmap(cmap)
            norm = check_colornorm(float(np.nanmin(vals)), float(np.nanmax(vals)))
            face = cm(norm(np.asarray(vals, float)))
        else:
            svals = pd.Series(vals).astype(str).values
            cats = list(pd.unique(svals))
            mapping = color_key or {c: DEFAULT_PALETTE[j % len(DEFAULT_PALETTE)] for j, c in enumerate(cats)}
            face = [mapping[c] for c in svals]
        pc = PolyCollection(polys[: len(vals)], facecolors=face, edgecolors=boundary_color, linewidths=boundary_width, alpha=alpha)
        a.add_collection(pc)
        allv = np.concatenate(polys)
        a.set_xlim(allv[:, 0].min(), allv[:, 0].max())
        a.set_ylim(allv[:, 1].min(), allv[:, 1].max())
        a.set_aspect(aspect)
        a.set_title(colors[i] if colors else basis, fontsize=10)
        a.set_xticks([])
        a.set_yticks([])
    out = axes_flat[0] if n == 1 else list(axes_flat[:n])
    return save_return_show_fig_utils(save_show_or_return, False, None, "geo", save_kwargs, n, fig, out)


def space_polygons(adata, basis: str = "contour", **kwargs):
    """Polygon plot in physical space (parity: reference geo.py:137)."""
    return geo(adata, basis=basis, **kwargs)


def color_label(
    adata,
    basis: str = "contour",
    color_key: Optional[list] = None,
    dpi: int = 100,
    boundary_width: float = 0.2,
    boundary_color="black",
    figsize=(6, 6),
    aspect: str = "equal",
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    *args,
    **kwargs,
):
    """Color each segmented cell with a cycling palette
    (parity: reference colorlabel.py:15)."""
    from matplotlib.collections import PolyCollection

    plt = _pyplot()

    polys = _get_polygons(adata, basis)
    palette = color_key or DEFAULT_PALETTE
    cyc = itertools.cycle(palette)
    face = [next(cyc) for _ in polys]
    fig, ax = plt.subplots(figsize=figsize, dpi=dpi)
    pc = PolyCollection(polys, facecolors=face, edgecolors=boundary_color, linewidths=boundary_width)
    ax.add_collection(pc)
    allv = np.concatenate(polys)
    ax.set_xlim(allv[:, 0].min(), allv[:, 0].max())
    ax.set_ylim(allv[:, 1].min(), allv[:, 1].max())
    ax.set_aspect(aspect)
    ax.set_xticks([])
    ax.set_yticks([])
    return save_return_show_fig_utils(save_show_or_return, False, None, "color_label", save_kwargs, 1, fig, ax)


def create_polygon_object_nanostring(polygon_df: pd.DataFrame):
    """NanoString polygon table -> per-cell vertex arrays
    (parity: reference static/geo.py:195; shapely objects replaced by
    vertex arrays keyed by cellID)."""
    out = {}
    cid_col = "cellID" if "cellID" in polygon_df.columns else polygon_df.columns[0]
    xcol = "x_local_px" if "x_local_px" in polygon_df.columns else "x"
    ycol = "y_local_px" if "y_local_px" in polygon_df.columns else "y"
    for cid, sub in polygon_df.groupby(cid_col):
        out[str(cid)] = sub[[xcol, ycol]].to_numpy(float)
    return out
