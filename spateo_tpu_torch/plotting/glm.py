"""GLM DEG visualizations (counterpart of `spateo_tpu.plotting.glm`;
reference spateo/plotting/static/glm.py:18 `glm_fit`, :143 `glm_heatmap`;
consumes the `.uns['glm_degs']` structure written by
`spateo_tpu.tools.glm.glm_degs`).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import pandas as pd

from ..svg.utils import loess_1d
from .utils import _pyplot, resolve_cmap, save_return_show_fig_utils


def glm_fit(
    adata,
    genes: Union[str, list, None] = None,
    feature_x: str = None,
    feature_y: str = "expression",
    glm_key: str = "glm_degs",
    remove_zero: bool = False,
    color_key: Optional[str] = None,
    color_key_cmap: str = "vlag",
    point_size: float = 14,
    point_color="skyblue",
    line_size: float = 2,
    line_color: str = "black",
    ax_size=(6, 4),
    ncols: int = 4,
    show_point: bool = True,
    show_line: bool = True,
    show_legend: bool = True,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    **kwargs,
):
    """Scatter of expression vs. the GLM's continuous covariate with the
    fitted trend (parity: reference glm.py:18)."""
    plt = _pyplot()

    assert feature_x is not None, "`feature_x` cannot be None."
    assert glm_key in adata.uns, f"`{glm_key}` not in .uns; run st.tl.glm_degs first."
    corr = adata.uns[glm_key]["correlation"]
    genes = list(adata.uns[glm_key]["glm_result"].index) if genes is None else np.atleast_1d(genes).tolist()
    genes = [g for g in genes if g in corr]

    n = len(genes)
    ncols = min(ncols, max(n, 1))
    nrows = int(np.ceil(n / ncols))
    fig, axes = plt.subplots(nrows, ncols, figsize=(ax_size[0] * ncols, ax_size[1] * nrows), squeeze=False)
    axes_flat = axes.ravel()
    for i, g in enumerate(genes):
        ax = axes_flat[i]
        df = pd.DataFrame(corr[g])
        if remove_zero:
            df = df[df[feature_y] != 0]
        xs = np.asarray(df[feature_x], float)
        ys = np.asarray(df[feature_y], float)
        order = np.argsort(xs)
        if show_point:
            if color_key is not None and color_key in df.columns:
                # color each point by another correlation column
                # (reference glm.py color_key/color_key_cmap)
                sc = ax.scatter(xs, ys, s=point_size, c=np.asarray(df[color_key], float),
                                cmap=color_key_cmap, alpha=0.6, linewidths=0)
                plt.colorbar(sc, ax=ax, shrink=0.7, label=color_key)
            else:
                ax.scatter(xs, ys, s=point_size, color=point_color, alpha=0.6, linewidths=0)
        if show_line and len(xs) > 3:
            _, smooth, _ = loess_1d(xs[order], ys[order], frac=0.3)
            ax.plot(xs[order], smooth, color=line_color, lw=line_size)
        ax.set_xlabel(feature_x)
        ax.set_ylabel(feature_y)
        ax.set_title(g, fontsize=10)
    for j in range(n, len(axes_flat)):
        axes_flat[j].axis("off")
    return save_return_show_fig_utils(save_show_or_return, show_legend, None, "glm_fit", save_kwargs, n, fig, list(axes_flat[:n]))


def glm_heatmap(
    adata,
    genes: Union[str, list, None] = None,
    feature_x: str = None,
    feature_y: str = "expression",
    glm_key: str = "glm_degs",
    lowess_smooth: bool = True,
    frac: float = 0.2,
    robust: bool = True,
    colormap: str = "vlag",
    figsize=(6, 6),
    show_legend: bool = True,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    **kwargs,
):
    """Gene-by-covariate heatmap of (optionally loess-smoothed, row-scaled)
    expression trends (parity: reference glm.py:143)."""
    plt = _pyplot()

    assert feature_x is not None, "`feature_x` cannot be None."
    corr = adata.uns[glm_key]["correlation"]
    genes = list(adata.uns[glm_key]["glm_result"].index) if genes is None else np.atleast_1d(genes).tolist()
    genes = [g for g in genes if g in corr]

    n_bins = 100
    rows = []
    for g in genes:
        df = pd.DataFrame(corr[g]).sort_values(feature_x)
        xs = np.asarray(df[feature_x], float)
        ys = np.asarray(df[feature_y], float)
        if lowess_smooth and len(xs) > 3:
            _, ys, _ = loess_1d(xs, ys, frac=frac)
        # bin to a common x grid
        grid = np.linspace(xs.min(), xs.max(), n_bins + 1)
        idx = np.clip(np.digitize(xs, grid) - 1, 0, n_bins - 1)
        binned = np.full(n_bins, np.nan)
        for b in range(n_bins):
            m = idx == b
            if m.any():
                binned[b] = ys[m].mean()
        # forward-fill gaps
        mask = np.isnan(binned)
        if mask.all():
            binned[:] = 0
        else:
            binned[mask] = np.interp(np.flatnonzero(mask), np.flatnonzero(~mask), binned[~mask])
        mu, sd = binned.mean(), binned.std() + 1e-12
        rows.append((binned - mu) / sd)
    M = np.stack(rows) if rows else np.zeros((0, n_bins))

    fig, ax = plt.subplots(figsize=figsize)
    if robust and M.size:
        vmin, vmax = np.percentile(M, 2), np.percentile(M, 98)
    else:
        vmin = vmax = None
    im = ax.imshow(M, aspect="auto", cmap=resolve_cmap(colormap if colormap != "vlag" else "coolwarm"), vmin=vmin, vmax=vmax)
    ax.set_yticks(range(len(genes)))
    ax.set_yticklabels(genes, fontsize=7)
    ax.set_xlabel(feature_x)
    if show_legend:
        plt.colorbar(im, ax=ax, shrink=0.6)
    return save_return_show_fig_utils(save_show_or_return, show_legend, None, "glm_heatmap", save_kwargs, 1, fig, ax)
