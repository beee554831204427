"""Alignment visualizations (counterpart of `spateo_tpu.plotting.align`;
reference spateo/plotting/static/align.py:24 `slices_2d`, :445
`overlay_slices_2d`, :817 `optimization_animation`, :901
`plot_deformation_grid`, :1261 `multi_slices`).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import pandas as pd

from .utils import (
    DEFAULT_PALETTE,
    _pyplot,
    despline_all,
    get_categorical_colors,
    resolve_cmap,
    save_return_show_fig_utils,
)


def _slices_list(slices, slices_key):
    """Normalize (AnnData|list, slices_key) -> list of (name, adata)."""
    if isinstance(slices, (list, tuple)):
        return [(str(s.obs[slices_key].iloc[0]) if slices_key and slices_key in s.obs else str(i), s) for i, s in enumerate(slices)]
    if slices_key is None or slices_key is False:
        return [("0", slices)]
    names = pd.unique(np.asarray(slices.obs[slices_key]).astype(str))
    return [(n, slices[np.asarray(slices.obs[slices_key]).astype(str) == n]) for n in names]


def _label_values(adata, label_key):
    from scipy.sparse import issparse

    if label_key is None:
        return np.zeros(adata.n_obs)
    if label_key in adata.obs.columns:
        return np.asarray(adata.obs[label_key])
    j = list(map(str, adata.var_names)).index(str(label_key))
    col = adata.X[:, j]
    return np.asarray(col.toarray()).ravel() if issparse(adata.X) else np.asarray(col).ravel()


def slices_2d(
    slices,
    slices_key: Optional[str] = None,
    label_key: Optional[str] = None,
    label_type: Optional[str] = None,
    spatial_key: str = "spatial",
    point_size: Optional[float] = None,
    n_sampling: int = -1,
    palette: Optional[dict] = None,
    ncols: int = 4,
    title: str = "",
    show_legend: bool = True,
    axis_off: bool = False,
    ticks_off: bool = True,
    height: float = 2,
    alpha: float = 1.0,
    cmap="tab20",
    center_coordinate: bool = False,
    return_palette: bool = False,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    x_min=None,
    x_max=None,
    y_min=None,
    y_max=None,
    sort_values: bool = True,
    sort_ascending: bool = True,
    title_kwargs: Optional[dict] = None,
    legend_kwargs: Optional[dict] = None,
    gridspec_kws: Optional[dict] = None,
    **kwargs,
):
    """One panel per slice, colored by a categorical cluster or scalar value
    (parity: reference align.py:24 — including the shared x/y limits,
    scalar draw-order sorting, and the title/legend/gridspec kwargs)."""
    plt = _pyplot()

    items = _slices_list(slices, slices_key)
    n = len(items)
    ncols = min(ncols, n)
    nrows = int(np.ceil(n / ncols))
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(height * 1.2 * ncols, height * nrows), squeeze=False,
        gridspec_kw=gridspec_kws,
    )
    axes_flat = axes.ravel()

    # shared palette / value range across panels
    all_vals = np.concatenate([_label_values(a, label_key) for _, a in items])
    numeric = np.issubdtype(all_vals.dtype, np.number) if label_type is None else (label_type == "scalar")
    if not numeric and palette is None:
        cats = list(pd.unique(pd.Series(all_vals).astype(str)))
        palette = {c: DEFAULT_PALETTE[i % len(DEFAULT_PALETTE)] for i, c in enumerate(cats)}
    vmin, vmax = (float(np.nanmin(all_vals)), float(np.nanmax(all_vals))) if numeric else (None, None)

    rng = np.random.default_rng(0)
    for i, (name, a) in enumerate(items):
        ax = axes_flat[i]
        pts = np.asarray(a.obsm[spatial_key])[:, :2].astype(float)
        vals = _label_values(a, label_key)
        if 0 < n_sampling < len(pts):
            idx = rng.choice(len(pts), n_sampling, replace=False)
            pts, vals = pts[idx], np.asarray(vals)[idx]
        if center_coordinate:
            pts = pts - pts.mean(0)
        ps = point_size if point_size is not None else max(0.5, 8000.0 / max(len(pts), 1))
        if numeric:
            fvals = np.asarray(vals, float)
            if sort_values:
                # draw order: high (or low) values plotted last, i.e. on top
                # (reference align.py sort_values/sort_ascending)
                order = np.argsort(fvals)
                if not sort_ascending:
                    order = order[::-1]
                pts, fvals = pts[order], fvals[order]
            sc = ax.scatter(pts[:, 0], pts[:, 1], c=fvals, s=ps, alpha=alpha, cmap=resolve_cmap(cmap if isinstance(cmap, str) else None, "viridis"), vmin=vmin, vmax=vmax, linewidths=0)
            if show_legend and i == n - 1:
                plt.colorbar(sc, ax=ax, shrink=0.7)
        else:
            svals = pd.Series(vals).astype(str).values
            for c in pd.unique(svals):
                m = svals == c
                ax.scatter(pts[m, 0], pts[m, 1], color=palette[c], s=ps, alpha=alpha, label=c, linewidths=0)
            if show_legend and i == n - 1:
                ax.legend(**{**dict(loc="center left", bbox_to_anchor=(1, 0.5), fontsize=6, markerscale=3, frameon=False), **(legend_kwargs or {})})
        ax.set_title(name, **{**dict(fontsize=9), **(title_kwargs or {})})
        ax.set_aspect("equal")
        if x_min is not None or x_max is not None:
            ax.set_xlim(x_min, x_max)
        if y_min is not None or y_max is not None:
            ax.set_ylim(y_min, y_max)
        if axis_off:
            ax.axis("off")
        elif ticks_off:
            ax.set_xticks([])
            ax.set_yticks([])
    for j in range(n, len(axes_flat)):
        axes_flat[j].axis("off")
    if title:
        fig.suptitle(title)

    out = save_return_show_fig_utils(save_show_or_return, show_legend, None, "slices_2d", save_kwargs, n, fig, list(axes_flat[:n]))
    if return_palette:
        return out, palette
    return out


def overlay_slices_2d(
    slices,
    slices_key: Optional[str] = None,
    label_key: Optional[str] = None,
    overlay_type: str = "both",
    spatial_key: str = "spatial",
    point_size: Optional[float] = None,
    n_sampling: int = -1,
    palette: Optional[dict] = None,
    ncols: int = 4,
    title: str = "",
    title_kwargs: Optional[dict] = None,
    show_legend: bool = True,
    legend_kwargs: Optional[dict] = None,
    axis_off: bool = False,
    axis_kwargs: Optional[dict] = None,
    ticks_off: bool = True,
    x_min=None,
    x_max=None,
    y_min=None,
    y_max=None,
    height: float = 2,
    alpha: float = 1.0,
    cmap="tab20",
    center_coordinate: bool = False,
    gridspec_kws: Optional[dict] = None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    **kwargs,
):
    """Overlay each slice with its neighbors to inspect alignment quality
    (parity: reference align.py:445). One panel PER SLICE: the current
    slice plus — per `overlay_type` — the previous slice ('forward',
    green), the next slice ('backward', blue), or 'both'; the current
    slice draws red. With `label_key` the overlay instead colors every
    point by the shared cluster palette / scalar range, so label
    continuity across the aligned neighbors is visible directly."""
    plt = _pyplot()

    items = _slices_list(slices, slices_key)
    n = len(items)
    ncols = min(ncols, n)
    nrows = int(np.ceil(n / ncols))
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(height * 1.2 * ncols, height * nrows), squeeze=False,
        gridspec_kw={**{"wspace": 0.1, "hspace": 0.2}, **(gridspec_kws or {})},
    )
    axes_flat = axes.ravel()

    rng = np.random.default_rng(0)
    coords, vals_list = [], []
    for _, a in items:
        pts = np.asarray(a.obsm[spatial_key])[:, :2].astype(float)
        vals = _label_values(a, label_key)
        if 0 < n_sampling < len(pts):
            idx = rng.choice(len(pts), n_sampling, replace=False)
            pts, vals = pts[idx], np.asarray(vals)[idx]
        if center_coordinate:
            pts = pts - pts.mean(0)
        coords.append(pts)
        vals_list.append(np.asarray(vals))

    # shared palette / scalar range across all panels
    numeric = label_key is not None and np.issubdtype(np.concatenate(vals_list).dtype, np.number)
    if label_key is not None and not numeric and palette is None:
        cats = list(pd.unique(pd.Series(np.concatenate(vals_list)).astype(str)))
        palette = {c: DEFAULT_PALETTE[i % len(DEFAULT_PALETTE)] for i, c in enumerate(cats)}
    vmin = vmax = None
    if numeric:
        allv = np.concatenate(vals_list).astype(float)
        vmin, vmax = float(np.nanmin(allv)), float(np.nanmax(allv))
    # overlay palette used when no label_key (reference align.py:655-676)
    overlay_palette = {"current": "red", "forward": "green", "backward": "blue"}

    total_pts = sum(len(p) for p in coords)
    ps = point_size if point_size is not None else max(0.5, 8000.0 / max(total_pts // max(n, 1), 1))

    def _draw(ax, pts, vals, overlay_id, with_label):
        if label_key is None:
            ax.scatter(pts[:, 0], pts[:, 1], s=ps, color=overlay_palette[overlay_id],
                       alpha=alpha, label=overlay_id if with_label else None, linewidths=0)
        elif numeric:
            ax.scatter(pts[:, 0], pts[:, 1], c=np.asarray(vals, float), s=ps, alpha=alpha,
                       cmap=resolve_cmap(cmap if isinstance(cmap, str) else None, "viridis"),
                       vmin=vmin, vmax=vmax, linewidths=0)
        else:
            svals = pd.Series(vals).astype(str).values
            for c in pd.unique(svals):
                m = svals == c
                ax.scatter(pts[m, 0], pts[m, 1], color=palette[c], s=ps, alpha=alpha,
                           label=c if with_label else None, linewidths=0)

    for i, (name, _) in enumerate(items):
        ax = axes_flat[i]
        shown = []
        if (overlay_type in ("forward", "both")) and i > 0:
            _draw(ax, coords[i - 1], vals_list[i - 1], "forward", True)
            shown.append("forward")
        if (overlay_type in ("backward", "both")) and i < n - 1:
            _draw(ax, coords[i + 1], vals_list[i + 1], "backward", True)
            shown.append("backward")
        _draw(ax, coords[i], vals_list[i], "current", True)
        ax.set_title(name, **{**dict(fontsize=9), **(title_kwargs or {})})
        ax.set_aspect("equal")
        if x_min is not None or x_max is not None:
            ax.set_xlim(x_min, x_max)
        if y_min is not None or y_max is not None:
            ax.set_ylim(y_min, y_max)
        if axis_off:
            ax.axis("off", **(axis_kwargs or {}))
        elif ticks_off:
            ax.set_xticks([])
            ax.set_yticks([])
        if show_legend and i == n - 1:
            handles, labels_ = ax.get_legend_handles_labels()
            seen = {}
            for h, l in zip(handles, labels_):
                seen.setdefault(l, h)
            ax.legend(seen.values(), seen.keys(),
                      **{**dict(loc="center left", bbox_to_anchor=(1, 0.5), fontsize=6,
                                markerscale=3, frameon=False), **(legend_kwargs or {})})
    for j in range(n, len(axes_flat)):
        axes_flat[j].axis("off")
    if title:
        fig.suptitle(title)
    return save_return_show_fig_utils(save_show_or_return, show_legend, None, "overlay_slices_2d", save_kwargs, n, fig, list(axes_flat[:n]))


def multi_slices(
    slices,
    slices_key: Optional[str] = None,
    label: Optional[str] = None,
    spatial_key: str = "align_spatial",
    layer: str = "X",
    point_size: Optional[float] = None,
    font_size: int = 20,
    color: Optional[str] = "skyblue",
    palette=None,
    alpha: float = 1.0,
    ncols: int = 4,
    ax_height: float = 1,
    dpi: int = 100,
    show_legend: bool = True,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    label_key: Optional[str] = None,
    **kwargs,
):
    """One panel per slice, wrapped at `ncols` (parity: reference
    align.py:1261 — the seaborn FacetGrid becomes a subplot grid). `label`
    may be an obs column or a gene name; numeric labels share one colorbar
    beside the last top-row panel, categorical labels share one legend;
    with no label every cell draws in `color`."""
    plt = _pyplot()

    label = label if label is not None else label_key
    items = _slices_list(slices, slices_key)
    n = len(items)
    ncols_eff = min(ncols, n)
    nrows = int(np.ceil(n / ncols_eff))

    # shared value range / palette across panels
    def _vals(a):
        if label is None:
            return None
        if label in a.obs.columns:
            return np.asarray(a.obs[label])
        if label in list(map(str, a.var_names)):
            X = a.layers[layer] if layer != "X" else a.X
            X = X.toarray() if hasattr(X, "toarray") else np.asarray(X)
            return np.asarray(X)[:, list(map(str, a.var_names)).index(label)].astype(float)
        raise ValueError("`label` is not a valid column names or gene name.")

    all_vals = None if label is None else np.concatenate([_vals(a) for _, a in items])
    numeric = all_vals is not None and np.issubdtype(np.asarray(all_vals).dtype, np.number)
    if all_vals is not None and not numeric and palette is None:
        cats = list(pd.unique(pd.Series(all_vals).astype(str)))
        palette = {c: DEFAULT_PALETTE[i % len(DEFAULT_PALETTE)] for i, c in enumerate(cats)}

    # aspect from the pooled physical extent (reference :1315-1321)
    all_pts = np.concatenate([np.asarray(a.obsm[spatial_key])[:, :2] for _, a in items])
    ptp = np.ptp(all_pts, axis=0)
    aspect = float(ptp[0] / max(ptp[1], 1e-9))
    ax_height = 2 if nrows == 1 and ax_height == 1 else ax_height
    fig, axes = plt.subplots(
        nrows, ncols_eff, figsize=(ax_height * 2 * aspect * ncols_eff, ax_height * 2 * nrows),
        dpi=dpi, squeeze=False, sharex=True, sharey=True,
    )
    flat = axes.ravel()
    vmin = float(np.nanmin(all_vals)) if numeric else None
    vmax = float(np.nanmax(all_vals)) if numeric else None
    last_top = axes[0, ncols_eff - 1]
    sc_num = None
    for i, (name, a) in enumerate(items):
        axp = flat[i]
        pts = np.asarray(a.obsm[spatial_key])[:, :2].astype(float)
        ps = point_size if point_size is not None else max(0.5, 8000.0 / max(len(pts), 1))
        vals = _vals(a)
        if vals is None:
            axp.scatter(pts[:, 0], pts[:, 1], color=color, s=ps, alpha=alpha, linewidths=0)
        elif numeric:
            sc_num = axp.scatter(pts[:, 0], pts[:, 1], c=np.asarray(vals, float), s=ps, alpha=alpha,
                                 cmap=palette if isinstance(palette, str) else "viridis",
                                 vmin=vmin, vmax=vmax, linewidths=0)
        else:
            svals = pd.Series(vals).astype(str).values
            for c in pd.unique(svals):
                m = svals == c
                axp.scatter(pts[m, 0], pts[m, 1], color=palette[c], s=ps, alpha=alpha, linewidths=0, label=c)
        axp.set_title(str(name), fontsize=font_size)
        axp.set_aspect("equal")
        axp.set_xticks([])
        axp.set_yticks([])
    for j in range(n, len(flat)):
        flat[j].axis("off")
    if numeric and sc_num is not None and show_legend:
        # shared colorbar beside the last top-row panel (reference :1362-1381)
        from mpl_toolkits.axes_grid1.inset_locator import inset_axes

        cax = inset_axes(last_top, width="12%", height="100%", loc="center left",
                         bbox_to_anchor=(1.02, 0.0, 0.5, 1.0), bbox_transform=last_top.transAxes, borderpad=1.85)
        fig.colorbar(sc_num, cax=cax, orientation="vertical", alpha=alpha, label=label)
    elif all_vals is not None and not numeric and show_legend:
        handles = [plt.Line2D([], [], marker="o", ls="", color=v, label=k) for k, v in palette.items()]
        fig.legend(handles=handles, loc="center left", bbox_to_anchor=(0.92, 0.5), fontsize=7,
                   markerscale=1.5, frameon=False)
    return save_return_show_fig_utils(
        save_show_or_return, show_legend, "white", "multi_slices", save_kwargs, n, fig, list(flat[:n]),
    )


def plot_deformation_grid(
    adata,
    spatial_key: str,
    origin_spatial_key: str,
    label_key: str,
    predict_func,
    ax=None,
    point_size: float = 2,
    grid_num: int = 10,
    line_width: float = 0.5,
    grid_color: str = "black",
    expand_scale: float = 0.1,
    palette=None,
    title: str = "",
    legend: bool = True,
    fontsize: int = 8,
    **kwargs,
):
    """Draw the nonrigid deformation as a warped lattice over the aligned
    points (parity: reference align.py:901). `predict_func` maps original
    coordinates -> deformed coordinates (e.g. a BA_transform closure)."""
    plt = _pyplot()

    if ax is None:
        _, ax = plt.subplots(figsize=(5, 5))
    pts = np.asarray(adata.obsm[spatial_key])[:, :2]
    origin = np.asarray(adata.obsm[origin_spatial_key])[:, :2]
    labels = np.asarray(adata.obs[label_key]).astype(str)
    if palette is None:
        cats = list(pd.unique(labels))
        palette = {c: DEFAULT_PALETTE[i % len(DEFAULT_PALETTE)] for i, c in enumerate(cats)}
    for c in pd.unique(labels):
        m = labels == c
        ax.scatter(pts[m, 0], pts[m, 1], s=point_size, color=palette[c], label=c, linewidths=0)

    x_min, x_max = origin[:, 0].min(), origin[:, 0].max()
    y_min, y_max = origin[:, 1].min(), origin[:, 1].max()
    x_min, x_max = x_min - (x_max - x_min) * expand_scale, x_max + (x_max - x_min) * expand_scale
    y_min, y_max = y_min - (y_max - y_min) * expand_scale, y_max + (y_max - y_min) * expand_scale
    t = np.linspace(0, 1, 200)
    for xv in np.linspace(x_min, x_max, grid_num):
        line = np.stack([np.full_like(t, xv), y_min + t * (y_max - y_min)], 1)
        d = np.asarray(predict_func(line))
        ax.plot(d[:, 0], d[:, 1], color=grid_color, lw=line_width)
    for yv in np.linspace(y_min, y_max, grid_num):
        line = np.stack([x_min + t * (x_max - x_min), np.full_like(t, yv)], 1)
        d = np.asarray(predict_func(line))
        ax.plot(d[:, 0], d[:, 1], color=grid_color, lw=line_width)
    if legend:
        ax.legend(fontsize=fontsize, markerscale=3, frameon=False, loc="center left", bbox_to_anchor=(1, 0.5))
    ax.set_title(title)
    ax.set_aspect("equal")
    despline_all(ax)
    return ax


def optimization_animation(
    aligned_slices: List[np.ndarray],
    fixed_slice: np.ndarray,
    filename: str = "alignment.gif",
    fps: int = 10,
    point_size: float = 2,
    **kwargs,
):
    """Animate the alignment iterations (parity: reference align.py:817).
    `aligned_slices` is a sequence of [N, 2] coordinate snapshots of the
    moving slice; writes a GIF via matplotlib's PillowWriter."""
    from matplotlib import animation

    plt = _pyplot()

    fig, ax = plt.subplots(figsize=(5, 5))
    fixed = np.asarray(fixed_slice)[:, :2]
    frames = [np.asarray(f)[:, :2] for f in aligned_slices]
    allpts = np.concatenate([fixed] + frames)
    ax.set_xlim(allpts[:, 0].min(), allpts[:, 0].max())
    ax.set_ylim(allpts[:, 1].min(), allpts[:, 1].max())
    ax.set_aspect("equal")
    ax.scatter(fixed[:, 0], fixed[:, 1], s=point_size, color="tab:blue", linewidths=0)
    moving = ax.scatter(frames[0][:, 0], frames[0][:, 1], s=point_size, color="tab:red", linewidths=0)

    def update(i):
        moving.set_offsets(frames[i])
        ax.set_title(f"iteration {i}")
        return (moving,)

    anim = animation.FuncAnimation(fig, update, frames=len(frames), blit=True)
    anim.save(filename, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return filename


# -- homography helpers (parity: reference static/align.py:1608-1631) -------


def get_min_max(x):
    """(min, max) of an array (parity: align.py:1616)."""
    x = np.asarray(x, float)
    return float(x.min()), float(x.max())


def transform_by_min_max(x, _min, _max, interval: float = 0.1):
    """Scale values into [interval, 1-interval] given min/max
    (parity: align.py:1608)."""
    x = np.asarray(x, float)
    return (x - _min) / max(_max - _min, 1e-12) * (1 - 2 * interval) + interval


def get_H(h: float = 0.5, w: float = 0.2) -> np.ndarray:
    """Shear homography used for pseudo-3D stacked-slice plots
    (parity: align.py:1631)."""
    return np.array([[1.0, w, 0.0], [0.0, h, 0.0], [0.0, 0.0, 1.0]])


def transform_H(x, H, z_shift: float = 0.0) -> np.ndarray:
    """Apply a homography to 2D points, with an optional vertical shift
    (parity: align.py:1623)."""
    x = np.asarray(x, float)[:, :2]
    ones = np.ones((len(x), 1))
    xh = np.concatenate([x, ones], axis=1) @ np.asarray(H, float).T
    out = xh[:, :2] / np.maximum(xh[:, [2]], 1e-12)
    out[:, 1] += z_shift
    return out
