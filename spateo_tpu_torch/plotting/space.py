"""Physical-space scatter plots (counterpart of `spateo_tpu.plotting.space`;
reference spateo/plotting/static/space.py:26 `space` and :155
`plot_cell_signaling`).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np

from .scatters import plot_vectors, scatters
from .utils import _pyplot, save_return_show_fig_utils


def space(
    adata,
    color: Optional[Union[List[str], str]] = None,
    genes: Optional[List[str]] = None,
    gene_cmaps=None,
    space: str = "spatial",
    width: float = 6,
    marker: str = ".",
    pointsize: Optional[float] = None,
    dpi: int = 100,
    ps_sample_num: int = 1000,
    alpha: float = 0.8,
    stack_genes: bool = False,
    stack_genes_threshold: float = 0.01,
    stack_colors_legend_size: int = 10,
    figsize: Optional[Tuple[float, float]] = None,
    *args,
    **kwargs,
):
    """Scatter in physical coordinates (parity: reference space.py:26).
    Figure aspect follows the data's physical aspect; point size is scaled
    to the typical nearest-neighbor distance."""
    genes = [genes] if isinstance(genes, str) else list(genes or [])
    if color is not None and stack_genes:
        stack_genes = False
    if color is not None:
        color = [color] if isinstance(color, str) else list(color)
        genes = genes + color
    if not genes:
        return None

    space_key = space if space in adata.obsm or f"X_{space}" in adata.obsm else "spatial"
    if f"X_{space_key}" not in adata.obsm and space_key in adata.obsm:
        adata.obsm[f"X_{space_key}"] = adata.obsm[space_key]
    pts = np.asarray(adata.obsm[f"X_{space_key}"])
    ptp = np.ptp(pts, axis=0)
    if figsize is None:
        figsize = (width, float(ptp[1] / max(ptp[0], 1e-9)) * width + 0.3)

    if pointsize is None:
        # estimate from nearest-neighbor spacing on a subsample
        sub = pts[np.random.default_rng(0).choice(len(pts), min(len(pts), ps_sample_num), replace=False)]
        d2 = ((sub[:, None, :2] - sub[None, :, :2]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        nn = float(np.sqrt(np.median(d2.min(1))))
        # convert physical spacing to points^2
        px_per_unit = figsize[0] * dpi / max(ptp[0], 1e-9)
        pointsize = max((nn * px_per_unit * 72.0 / dpi) ** 2 * 0.6, 0.3)

    kwargs.setdefault("aspect", "equal")
    return scatters(
        adata,
        basis=space_key,
        color=genes,
        figsize=figsize,
        pointsize=pointsize,
        dpi=dpi,
        alpha=alpha,
        marker=marker,
        stack_colors=stack_genes,
        stack_colors_threshold=stack_genes_threshold,
        stack_colors_legend_size=stack_colors_legend_size,
        stack_colors_cmaps=gene_cmaps,
        **kwargs,
    )


def plot_cell_signaling(
    adata,
    vf_key: str,
    color: Optional[Union[List[str], str]] = None,
    arrow_color: str = "tab:blue",
    edgewidth: float = 0.2,
    space: str = "spatial",
    width: float = 6,
    pointsize: Optional[float] = None,
    dpi: int = 100,
    ps_sample_num: int = 1000,
    alpha: float = 0.8,
    plot_method: str = "cell",
    scale: Optional[float] = None,
    scale_units: Optional[str] = None,
    grid_density: float = 1,
    grid_knn: Optional[int] = None,
    grid_scale: float = 1.0,
    grid_threshold: float = 1.0,
    grid_width: Optional[float] = None,
    stream_density: Optional[float] = None,
    stream_linewidth: Optional[float] = None,
    stream_cutoff_percentile: float = 5,
    figsize: Optional[Tuple[float, float]] = None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    **kwargs,
):
    """Overlay a CCI-inferred signaling vector field on the spatial scatter
    (parity: reference space.py:155; COMMOT-style rendering).

    `plot_method`:
      - 'cell': one arrow per cell (all-zero vectors suppressed).
      - 'grid': Gaussian-KNN interpolation of the cell vectors onto a
        rectangular lattice (reference space.py:312-345 — `grid_knn`
        neighbors weighted by norm.pdf at `gridsize*grid_scale`; lattice
        points with weight-sum below `grid_threshold` %o of the 99th
        percentile are dropped so the grid hugs the tissue).
      - 'stream': matplotlib streamplot over the same interpolated lattice,
        masking vectors below `stream_cutoff_percentile` of the local
        magnitude and scaling `stream_linewidth` by relative speed.
    """
    from scipy.stats import norm as _norm

    plt = _pyplot()

    key = vf_key if vf_key in adata.obsm else f"vf_{vf_key}"
    V = np.asarray(adata.obsm[key])[:, :2].astype(float)
    pts = np.asarray(adata.obsm[space])[:, :2].astype(float)

    ax = None
    if color is not None:
        ax = space_plot_axes(adata, color, space, width, pointsize, dpi, alpha, figsize, **kwargs)
    if ax is None:
        ptp = np.ptp(pts, axis=0)
        figsize = figsize or (width, float(ptp[1] / max(ptp[0], 1e-9)) * width + 0.3)
        fig, ax = plt.subplots(figsize=figsize, dpi=dpi)
        if pointsize is None:
            # smallest-distance-derived point size (reference space.py:293)
            from ..tools.utils import compute_smallest_distance

            sd = compute_smallest_distance(pts, sample_num=ps_sample_num)
            pointsize = max((sd * figsize[0] / max(ptp[0], 1e-9) * dpi) ** 2 * np.sqrt(len(pts)) / 16000.0, 0.5)
        ax.scatter(pts[:, 0], pts[:, 1], s=pointsize, color="#cccccc", alpha=alpha, linewidths=0)
        ax.set_aspect("equal")

    if plot_method == "cell":
        Vc = V.copy()
        Vc[np.abs(V).sum(1) == 0] = np.nan
        plot_vectors(ax, pts, Vc, method="cell", color=arrow_color, scale=scale,
                     scale_units=scale_units, width=grid_width)
    elif plot_method in ("grid", "stream"):
        from scipy.spatial import cKDTree

        # rectangular lattice padded 2% beyond the tissue (reference :314)
        xl, xr = pts[:, 0].min(), pts[:, 0].max()
        yl, yr = pts[:, 1].min(), pts[:, 1].max()
        xl, xr = xl - 0.02 * (xr - xl), xr + 0.02 * (xr - xl)
        yl, yr = yl - 0.02 * (yr - yl), yr + 0.02 * (yr - yl)
        ngrid_x = max(int(50 * grid_density), 4)
        gridsize = (xr - xl) / float(ngrid_x)
        ngrid_y = max(int((yr - yl) / max(gridsize, 1e-12)), 4)
        x_grid = np.linspace(xl, xr, ngrid_x)
        y_grid = np.linspace(yl, yr, ngrid_y)
        XX, YY = np.meshgrid(x_grid, y_grid)
        grid_pts = np.stack([XX.ravel(), YY.ravel()], 1)

        knn = grid_knn if grid_knn is not None else max(int(len(pts) / 50), 1)
        knn = min(knn, len(pts))
        distances, neighbors = cKDTree(pts).query(grid_pts, k=knn)
        distances = np.atleast_2d(distances.T).T
        neighbors = np.atleast_2d(neighbors.T).T
        w = _norm.pdf(x=distances, scale=gridsize * grid_scale)
        w_sum = w.sum(axis=1)
        vf_grid = (V[neighbors] * w[:, :, None]).sum(axis=1) / np.maximum(1, w_sum)[:, None]

        if plot_method == "grid":
            thr = grid_threshold * np.percentile(w_sum, 99) / 100
            keep = w_sum > thr
            plot_vectors(ax, grid_pts[keep], vf_grid[keep], method="cell", color=arrow_color,
                         scale=scale, scale_units=scale_units, width=grid_width)
        else:
            U = vf_grid[:, 0].reshape(ngrid_y, ngrid_x)
            W = vf_grid[:, 1].reshape(ngrid_y, ngrid_x)
            vlen = np.sqrt(U**2 + W**2)
            grid_thresh = min(10 ** (grid_threshold - 6), np.nanmax(vlen) * 0.9)
            cutoff = vlen < grid_thresh
            length = np.abs(V[neighbors]).mean(axis=1).sum(axis=1).reshape(ngrid_y, ngrid_x)
            cutoff |= length < np.percentile(length, stream_cutoff_percentile)
            U = np.where(cutoff, np.nan, U)
            lengths = np.sqrt(U**2 + W**2)
            lw = stream_linewidth if stream_linewidth is not None else edgewidth * 5
            with np.errstate(invalid="ignore"):
                lw = lw * 2 * lengths / max(np.nanmax(lengths), 1e-12)
            ax.streamplot(x_grid, y_grid, U, W, color=arrow_color,
                          density=stream_density if stream_density is not None else 1.0,
                          linewidth=np.nan_to_num(lw, nan=0.0))
    else:
        raise ValueError(f"plot_method must be one of 'cell', 'grid', or 'stream'. Got {plot_method}.")

    return save_return_show_fig_utils(save_show_or_return, False, None, "cell_signaling", save_kwargs, 1, ax.figure, ax)


def space_plot_axes(adata, color, space, width, pointsize, dpi, alpha, figsize, **kwargs):
    """Render the base space() panel and hand back its axes for overlays."""
    out = space(
        adata, color=color, space=space, width=width, pointsize=pointsize, dpi=dpi,
        alpha=alpha, figsize=figsize, save_show_or_return="return", **kwargs
    )
    if isinstance(out, list):
        return out[0]
    return out
