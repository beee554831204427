"""Core embedding/space scatter machinery (counterpart of
`spateo_tpu.plotting.scatters`; reference
spateo/plotting/static/scatters.py:51 — multi-panel scatter with categorical
/ continuous coloring, stacked-gene rendering, optional vector overlays).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import pandas as pd

from .utils import (
    _get_adata_color_vec,
    _pyplot,
    check_colornorm,
    deaxis_all,
    despline_all,
    get_categorical_colors,
    is_cell_anno_column,
    is_gene_name,
    quiver_autoscaler,
    resolve_cmap,
    save_return_show_fig_utils,
)


def _axis_vector(adata, key, layer: str) -> np.ndarray:
    """Per-cell vector for a string x/y axis: a gene (from `layer`) or an
    obs column (reference scatters.py:643-698 phase-plot axes)."""
    if is_gene_name(adata, key):
        names = list(map(str, adata.var_names))
        X = adata.layers[layer] if layer not in (None, "X") else adata.X
        X = X.toarray() if hasattr(X, "toarray") else np.asarray(X)
        return np.asarray(X)[:, names.index(str(key))].astype(float)
    if is_cell_anno_column(adata, key):
        return np.asarray(adata.obs[key], dtype=float)
    raise ValueError(f"`{key}` is neither a gene name nor an obs column.")


def _aggregate_points(adata, aggregate: str, pts: np.ndarray, vals: np.ndarray):
    """Collapse cells to per-group medians; numeric colors take the group
    median, categorical the group's most frequent label; point sizes become
    the group sizes (reference scatters.py:718-752)."""
    groups = np.asarray(adata.obs[aggregate]).astype(str)
    uniq = list(pd.unique(groups))
    med = np.zeros((len(uniq), pts.shape[1]))
    sizes = np.zeros(len(uniq))
    numeric = np.issubdtype(np.asarray(vals).dtype, np.number)
    out_vals = np.zeros(len(uniq)) if numeric else np.empty(len(uniq), dtype=object)
    for k, g in enumerate(uniq):
        m = groups == g
        med[k] = np.nanmedian(pts[m], axis=0)
        sizes[k] = m.sum()
        if numeric:
            out_vals[k] = np.nanmedian(np.asarray(vals, float)[m])
        else:
            out_vals[k] = pd.Series(np.asarray(vals)[m]).value_counts().index[0]
    return med, out_vals, sizes


def _resolve_basis(adata, basis: str) -> np.ndarray:
    for key in (f"X_{basis}", basis):
        if key in adata.obsm:
            return np.asarray(adata.obsm[key])
    raise KeyError(f"basis `{basis}` not found in .obsm (looked for X_{basis} and {basis})")


def _panel_scatter(
    ax: Axes,
    pts: np.ndarray,
    vals: np.ndarray,
    cmap,
    pointsize: float,
    alpha: float,
    marker: str,
    show_legend,
    sym_c: bool,
    sort: str,
    adata=None,
    color_key=None,
    title: str = "",
    vmin=None,
    vmax=None,
):
    plt = _pyplot()

    numeric = np.issubdtype(np.asarray(vals).dtype, np.number)
    if numeric:
        v = np.asarray(vals, dtype=float)
        if sort == "abs":
            order = np.argsort(np.abs(v))
        elif sort == "neg":
            order = np.argsort(-v)
        else:
            order = np.argsort(v)
        if sym_c and np.nanmin(v) < 0 < np.nanmax(v):
            bound = np.nanmax(np.abs(v))
            vmin, vmax = -bound, bound
        norm = check_colornorm(vmin, vmax)
        sc = ax.scatter(pts[order, 0], pts[order, 1], c=v[order], cmap=cmap, norm=norm, s=pointsize, alpha=alpha, marker=marker, linewidths=0)
        if show_legend not in (False, None, "none"):
            plt.colorbar(sc, ax=ax, shrink=0.6, pad=0.01)
    else:
        cats, mapping = (color_key if isinstance(color_key, tuple) else get_categorical_colors(adata, None, values=vals))
        svals = pd.Series(vals).astype(str).values
        for c in cats:
            m = svals == c
            ax.scatter(pts[m, 0], pts[m, 1], color=mapping[c], s=pointsize, alpha=alpha, marker=marker, label=c, linewidths=0)
        if show_legend == "on data":
            for c in cats:
                m = svals == c
                if m.any():
                    ax.text(*pts[m].mean(0)[:2], c, fontsize=8, ha="center", weight="bold")
        elif show_legend not in (False, None, "none"):
            ax.legend(loc="center left", bbox_to_anchor=(1, 0.5), fontsize=7, markerscale=3, frameon=False)
        ax.set_title(title, fontsize=10)
        return dict(zip(cats, (mapping[c] for c in cats)))
    ax.set_title(title, fontsize=10)
    return None


def _neighbor_smooth(pts: np.ndarray, v: np.ndarray, iterations: int) -> np.ndarray:
    """KNN mean smoothing of a per-cell value over the embedding
    (reference scatters.py `smooth` option)."""
    from scipy.spatial import cKDTree

    k = min(8, len(pts))
    _, idx = cKDTree(pts).query(pts, k=k)
    out = np.asarray(v, dtype=float)
    for _ in range(max(int(iterations), 1)):
        out = out[idx].mean(axis=1)
    return out


def scatters(
    adata,
    basis: Union[str, list] = "umap",
    x: int = 0,
    y: int = 1,
    z: int = 2,
    color: Union[str, list] = "ntr",
    layer: Union[str, list] = "X",
    labels: Optional[list] = None,
    values: Optional[list] = None,
    highlights: Optional[list] = None,
    cmap: Optional[str] = None,
    color_key: Union[dict, list, None] = None,
    color_key_cmap: Optional[str] = None,
    theme: Optional[str] = None,
    background: Optional[str] = None,
    ncols: int = 4,
    pointsize: Optional[float] = None,
    figsize: tuple = (6, 4),
    show_legend="on data",
    ax: Optional[Axes] = None,
    sort: str = "raw",
    save_show_or_return: str = "return",
    save_kwargs: Optional[Dict] = None,
    sym_c: bool = False,
    dpi: int = 100,
    marker: Optional[str] = None,
    aspect: str = "auto",
    despline: bool = True,
    despline_sides: Optional[List[str]] = None,
    deaxis: bool = True,
    show_arrowed_spines: bool = False,
    alpha: float = 0.1,
    stack_colors: bool = False,
    stack_colors_threshold: float = 0.001,
    stack_colors_title: str = "stacked colors",
    stack_colors_legend_size: int = 2,
    stack_colors_cmaps: Optional[List[str]] = None,
    smooth: Union[bool, int] = False,
    frontier: bool = False,
    contour: bool = False,
    ccmap: Optional[str] = None,
    calpha: float = 0.4,
    projection: str = "2d",
    aggregate: Optional[str] = None,
    geo: bool = False,
    boundary_width: float = 0.2,
    boundary_color: str = "black",
    slices: Optional[int] = None,
    img_layers: Optional[int] = None,
    affine_transform_degree: Optional[float] = None,
    affine_transform_A: Optional[np.ndarray] = None,
    affine_transform_b: Optional[np.ndarray] = None,
    V: Optional[np.ndarray] = None,
    X_grid: Optional[np.ndarray] = None,
    vf_plot_method: str = "cell",
    vf_kwargs: Optional[Dict] = None,
    return_all: bool = False,
    vmin=None,
    vmax=None,
    **kwargs,
) -> Union[None, Axes, List[Axes]]:
    """Multi-panel scatter over an embedding (parity surface:
    reference scatters.py:51). One panel per (color, basis) combination;
    categorical obs columns get a discrete palette + optional on-data
    labels; genes/numeric columns get a colormap + colorbar.

    Reference options honored beyond the basics: explicit `labels`/`values`
    overriding the adata lookup, `highlights` (grey-out all but the chosen
    categories), `theme`/`color_key_cmap` palettes, `smooth` (KNN value
    smoothing), `frontier`/`contour` outlining (scatters.py:1512-1550),
    `projection='3d'`, pre-plot affine transforms (rotation degree or
    explicit A/b), and an inline vector-field overlay (`V`/`X_grid` with
    `vf_plot_method` in cell/grid/stream — the scatters-level integration
    of plot_vectors)."""
    plt = _pyplot()

    bases = [basis] if isinstance(basis, str) else list(basis)
    colors = [color] if isinstance(color, str) else list(color)
    layers = [layer] if isinstance(layer, str) else list(layer)
    marker = marker or "."

    # theme -> (cmap, categorical palette) defaults, reference
    # scatters.py:286-322 / dynamo themes
    themes = {
        "blue": ("Blues", "tab20"),
        "red": ("Reds", "tab20"),
        "green": ("Greens", "tab20"),
        "fire": ("fire", "tab20"),
        "viridis": ("viridis", "tab20"),
        "inferno": ("inferno", "tab20"),
        "div_blue_red": ("div_blue_red", "tab20"),
        "div_blue_black_red": ("div_blue_black_red", "tab20"),
        "glasbey_dark": ("viridis", "glasbey_dark"),
        "glasbey_white": ("viridis", "glasbey_white"),
    }
    # the named maps ("fire", "glasbey_dark", ...) registered with matplotlib
    from ..colormaps import register_colormaps

    register_colormaps()
    if theme is not None and cmap is None:
        cmap = themes.get(theme, (None, None))[0]

    if stack_colors:
        return _stacked_scatter(
            adata, bases[0], colors, layers[0], pointsize, figsize, dpi, alpha, marker,
            stack_colors_threshold, stack_colors_title, stack_colors_legend_size,
            stack_colors_cmaps, save_show_or_return, save_kwargs, ax=ax,
        )

    panels = [(b, c, l) for b in bases for c in colors for l in layers[:1]]
    n = len(panels)
    ncols = min(ncols, n)
    nrows = int(np.ceil(n / ncols))
    subplot_kw = {"projection": "3d"} if projection == "3d" else {}
    if ax is None:
        fig, axes = plt.subplots(
            nrows, ncols, figsize=(figsize[0] * ncols, figsize[1] * nrows), dpi=dpi, squeeze=False,
            subplot_kw=subplot_kw,
        )
        axes_flat = axes.ravel()
    else:
        fig = ax.figure
        axes_flat = np.asarray([ax])

    for i, (b, c, l) in enumerate(panels[: len(axes_flat)]):
        phase_title = None
        if isinstance(x, str) or isinstance(y, str):
            # phase-plot axes: gene/obs-column values instead of basis
            # coordinates (reference scatters.py:643-698)
            vx = _axis_vector(adata, x, l) if isinstance(x, str) else _resolve_basis(adata, b)[:, x]
            vy = _axis_vector(adata, y, l) if isinstance(y, str) else _resolve_basis(adata, b)[:, y]
            pts = np.c_[vx, vy]
            if isinstance(x, str) and isinstance(y, str):
                if is_gene_name(adata, x) != is_gene_name(adata, y):
                    phase_title = x if is_gene_name(adata, x) else y
                else:
                    phase_title = f"{x} VS {y}"
        else:
            coords = _resolve_basis(adata, b)
            pts = coords[:, [x, y, z][: 3 if projection == "3d" and coords.shape[1] > 2 else 2]]
        # pre-plot affine transform (reference scatters.py affine_transform_*)
        if affine_transform_A is not None or affine_transform_degree is not None:
            A = np.asarray(affine_transform_A, float) if affine_transform_A is not None else None
            if A is None:
                th = np.deg2rad(float(affine_transform_degree))
                A = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
            bvec = np.asarray(affine_transform_b, float) if affine_transform_b is not None else np.zeros(A.shape[0])
            pts2 = pts[:, : A.shape[1]] @ A.T + bvec
            pts = np.concatenate([pts2, pts[:, A.shape[1]:]], axis=1) if pts.shape[1] > A.shape[1] else pts2
        if values is not None:
            vals = np.asarray(values if not isinstance(values, dict) else values[c])
        elif labels is not None:
            vals = np.asarray(labels, dtype=object)
        else:
            vals = _get_adata_color_vec(adata, l, c)
        numeric_vals = np.issubdtype(np.asarray(vals).dtype, np.number)
        if smooth and numeric_vals:
            vals = _neighbor_smooth(pts[:, :2], vals, 2 if smooth is True else int(smooth))
        if highlights and not numeric_vals:
            svals = pd.Series(vals).astype(str).values
            keep = np.isin(svals, np.asarray(highlights, dtype=str))
            vals = np.where(keep, svals, "other")
        ps = pointsize if pointsize is not None else max(0.2, 30000.0 / max(len(pts), 1))
        if aggregate is not None:
            pts, vals, ps = _aggregate_points(adata, aggregate, pts, vals)
            numeric_vals = np.issubdtype(np.asarray(vals).dtype, np.number)
        ck = None
        if isinstance(color_key, dict):
            cats = list(color_key)
            ck = (cats, color_key)
        elif color_key_cmap is not None and not numeric_vals:
            cats = sorted(pd.Series(vals).astype(str).unique())
            cm = resolve_cmap(color_key_cmap)
            ck = (cats, {cat: cm(j / max(len(cats) - 1, 1)) for j, cat in enumerate(cats)})
        if projection == "3d" and pts.shape[1] > 2:
            v = np.asarray(vals, float) if numeric_vals else None
            sc = axes_flat[i].scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=v, cmap=resolve_cmap(cmap, "viridis"), s=ps, alpha=alpha, linewidths=0)
            if numeric_vals and show_legend not in (False, None, "none"):
                plt.colorbar(sc, ax=axes_flat[i], shrink=0.6, pad=0.01)
            axes_flat[i].set_title(str(c), fontsize=10)
        else:
            # frontier/contour outlining: a grey halo pass under the data
            # (reference scatters.py:1512 frontier; :1546 contour via
            # tricontourf on the value field)
            if frontier:
                axes_flat[i].scatter(pts[:, 0], pts[:, 1], s=ps * 4, c="0.8", linewidths=0, zorder=0)
                axes_flat[i].scatter(pts[:, 0], pts[:, 1], s=ps * 2, c="white", linewidths=0, zorder=1)
            if contour and numeric_vals:
                try:
                    axes_flat[i].tricontourf(
                        pts[:, 0], pts[:, 1], np.asarray(vals, float),
                        levels=10, cmap=resolve_cmap(ccmap or cmap, "viridis"), alpha=calpha, zorder=0,
                    )
                except Exception:
                    pass
            if geo:
                # cell-polygon rendering (reference scatters.py geo=True:
                # shapely geometries -> here the geo module's polygon store)
                from matplotlib.collections import PolyCollection

                from .geo import _get_polygons

                polys = _get_polygons(adata, "contour")
                if numeric_vals:
                    v = np.asarray(vals, float)
                    norm = check_colornorm(vmin, vmax)
                    fc = resolve_cmap(cmap, "viridis")(norm(v))
                else:
                    cats, mapping = ck if ck is not None else get_categorical_colors(adata, None, values=vals)
                    svals = pd.Series(vals).astype(str).values
                    fc = [mapping[s] for s in svals]
                axes_flat[i].add_collection(PolyCollection(
                    polys[: len(vals)], facecolors=fc, edgecolors=boundary_color,
                    linewidths=boundary_width, alpha=alpha,
                ))
                axes_flat[i].autoscale_view()
                axes_flat[i].set_title(phase_title or str(c), fontsize=10)
                color_mapping = None
            else:
                color_mapping = _panel_scatter(
                    axes_flat[i], pts[:, :2], vals, resolve_cmap(cmap, "viridis" if sort != "abs" else "inferno"),
                    ps, alpha, marker, show_legend, sym_c, sort, adata=adata, color_key=ck,
                    title=phase_title or str(c), vmin=vmin, vmax=vmax,
                )
            if color_mapping is not None:
                # persist the categorical palette the way the reference does
                # (scatters.py:892-898 adata.uns[f"{title}_colors"])
                from matplotlib.colors import to_hex

                adata.uns[f"{phase_title or str(c)}_colors"] = {
                    k: to_hex(v) for k, v in color_mapping.items()
                }
            if img_layers is not None and slices is not None and "spatial" in getattr(adata, "uns", {}):
                # staining image underlay (reference scatters.py:979-991)
                entry = adata.uns["spatial"][slices]
                img = np.asarray(entry["images"][img_layers])
                scale = entry.get("scalefactors", {})
                sf = scale[img_layers] if not np.isscalar(scale) and img_layers in scale else scale
                try:
                    sf = float(sf)
                except (TypeError, ValueError):
                    sf = 1.0
                extent = [0, img.shape[1] / sf, 0, img.shape[0] / sf]
                axes_flat[i].imshow(np.flipud(np.rot90(img)) if img.ndim == 2 else img,
                                    extent=extent, cmap="gray" if img.ndim == 2 else None, zorder=-1)
            if V is not None:
                Xq = X_grid if X_grid is not None else pts[:, :2]
                plot_vectors(axes_flat[i], Xq, np.asarray(V), method=vf_plot_method, **(vf_kwargs or {}))
            axes_flat[i].set_aspect("equal" if aspect == "equal" else "auto")
        if show_arrowed_spines and projection != "3d":
            for spine in ("left", "bottom"):
                axes_flat[i].spines[spine].set_visible(True)
            axes_flat[i].annotate(
                "", xy=(0.12, 0.0), xytext=(0.0, 0.0), xycoords="axes fraction",
                arrowprops=dict(arrowstyle="->", lw=1.0),
            )
            axes_flat[i].annotate(
                "", xy=(0.0, 0.12), xytext=(0.0, 0.0), xycoords="axes fraction",
                arrowprops=dict(arrowstyle="->", lw=1.0),
            )
        if projection != "3d":
            if despline_sides:
                for side in despline_sides:
                    axes_flat[i].spines[side].set_visible(False)
            elif despline:
                despline_all(axes_flat[i])
            if deaxis:
                deaxis_all(axes_flat[i])
    for j in range(n, len(axes_flat)):
        axes_flat[j].axis("off")

    out_axes = axes_flat[0] if n == 1 else list(axes_flat[:n])
    if return_all:
        return fig, out_axes
    return save_return_show_fig_utils(
        save_show_or_return, show_legend not in (False, None, "none"), background,
        "scatters", save_kwargs, n, fig, out_axes,
    )


def _stacked_scatter(
    adata, basis, colors, layer, pointsize, figsize, dpi, alpha, marker,
    threshold, title, legend_size, cmaps, save_show_or_return, save_kwargs, ax=None,
):
    """Overlay several genes on one panel, each with its own colormap,
    drawing only cells above `threshold` (reference scatters.py stack_colors
    path)."""
    plt = _pyplot()

    pts = _resolve_basis(adata, basis)[:, :2]
    cmaps = cmaps or ["Reds", "Blues", "Greens", "Purples", "Oranges", "Greys"]
    if ax is None:
        fig, ax = plt.subplots(figsize=figsize, dpi=dpi)
    else:
        fig = ax.figure
    ps = pointsize if pointsize is not None else max(0.2, 30000.0 / max(len(pts), 1))
    ax.scatter(pts[:, 0], pts[:, 1], color="#eeeeee", s=ps, marker=marker, linewidths=0)
    handles = []
    for i, g in enumerate(colors):
        v = np.asarray(_get_adata_color_vec(adata, layer, g), dtype=float)
        m = v > threshold
        if not m.any():
            continue
        cm = resolve_cmap(cmaps[i % len(cmaps)])
        vn = (v[m] - v[m].min()) / (np.ptp(v[m]) + 1e-12)
        ax.scatter(pts[m, 0], pts[m, 1], color=cm(0.3 + 0.7 * vn), s=ps, alpha=alpha, marker=marker, linewidths=0)
        handles.append(plt.Line2D([], [], marker="o", ls="", color=cm(0.8), label=g, markersize=legend_size))
    ax.legend(handles=handles, loc="center left", bbox_to_anchor=(1, 0.5), frameon=False, fontsize=7)
    ax.set_title(title)
    deaxis_all(ax)
    despline_all(ax)
    return save_return_show_fig_utils(save_show_or_return, True, None, "scatters", save_kwargs, 1, fig, ax)


def plot_vectors(
    ax: Axes,
    X: np.ndarray,
    V: np.ndarray,
    method: str = "cell",
    color: str = "black",
    **kwargs,
):
    """Vector overlay: per-cell quiver, grid quiver, or streamlines
    (reference utils.py:246 plot_vectors)."""
    X, V = np.asarray(X), np.asarray(V)
    if method == "stream":
        # streamplot needs a regular grid; rasterize the field first
        n = 50
        xi = np.linspace(X[:, 0].min(), X[:, 0].max(), n)
        yi = np.linspace(X[:, 1].min(), X[:, 1].max(), n)
        XX, YY = np.meshgrid(xi, yi)
        from scipy.interpolate import griddata

        U = griddata(X[:, :2], V[:, 0], (XX, YY), method="linear", fill_value=0)
        W = griddata(X[:, :2], V[:, 1], (XX, YY), method="linear", fill_value=0)
        ax.streamplot(XX, YY, U, W, color=color, density=kwargs.pop("density", 1.2), linewidth=kwargs.pop("linewidth", 0.7))
    else:
        scale = kwargs.pop("scale", quiver_autoscaler(X, V))
        ax.quiver(X[:, 0], X[:, 1], V[:, 0], V[:, 1], color=color, scale=scale, angles="xy", **kwargs)
    return ax


def position(adata, color: str = "cluster", basis: str = "position", **kwargs):
    """Scatter on the 'position' basis (parity: reference
    static/position.py:10)."""
    return scatters(adata, basis=basis, color=color, **kwargs)
