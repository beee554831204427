"""Top-level 3D plot entry points (counterpart of
`spateo_tpu.plotting.three_d_plot.three_dims_plots`; reference
spateo/plotting/static/three_d_plot/three_dims_plots.py:1-1318 —
`three_d_plot`, `three_d_multi_plot`, `three_d_animate`,
`merge_animations`).

Host code, copied; matplotlib and PIL are imported inside the functions that
draw, since the GPU machine has no matplotlib.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from .three_dims_plotter import (
    _equalize_3d,
    add_legend,
    add_model,
    add_model_outline,
    create_plotter,
    output_plotter,
)
from ..utils import _pyplot


def _as_model_list(model):
    return list(model) if isinstance(model, (list, tuple)) else [model]


def three_d_plot(
    model,
    key: Union[str, List[str], None] = None,
    filename: Optional[str] = None,
    jupyter: bool = False,
    off_screen: bool = False,
    window_size: Sequence[int] = (512, 512),
    background: str = "white",
    cpo: Union[str, list, None] = None,
    colormap: Union[str, List[str], None] = "rainbow",
    ambient: float = 0.2,
    opacity: Union[float, Sequence[float]] = 1.0,
    model_style: Union[str, Sequence[str]] = "surface",
    model_size: Union[float, Sequence[float]] = 3.0,
    show_legend: bool = True,
    show_outline: bool = False,
    view_up: Sequence[float] = (0.5, 0.5, 1),
    text: Optional[str] = None,
    **kwargs,
):
    """Render one (or a stack of) tdr model(s) into a single 3D panel
    (parity: reference three_dims_plots.py `three_d_plot`)."""
    models = _as_model_list(model)
    keys = key if isinstance(key, (list, tuple)) else [key] * len(models)
    cmaps = colormap if isinstance(colormap, (list, tuple)) else [colormap] * len(models)
    opac = list(opacity) if isinstance(opacity, (list, tuple)) else [opacity] * len(models)
    styles = list(model_style) if isinstance(model_style, (list, tuple)) else [model_style] * len(models)
    sizes = list(model_size) if isinstance(model_size, (list, tuple)) else [model_size] * len(models)

    fig, axes = create_plotter(1, 1, window_size=window_size, background=background)
    ax = axes[0, 0]
    for m, k, cm, op, st, sz in zip(models, keys, cmaps, opac, styles, sizes):
        add_model(ax, m, key=k, colormap=cm, ambient=ambient, opacity=op, model_style=st, model_size=sz)
        if show_outline:
            add_model_outline(ax, m)
    if show_legend:
        add_legend(ax)
    if text:
        ax.set_title(text)
    if cpo == "xy":
        ax.view_init(elev=90, azim=-90)
    elif cpo == "xz":
        ax.view_init(elev=0, azim=-90)
    elif cpo == "yz":
        ax.view_init(elev=0, azim=0)
    return output_plotter(fig, filename=filename, jupyter=jupyter)


def three_d_multi_plot(
    model,
    key: Union[str, List[str], None] = None,
    filename: Optional[str] = None,
    jupyter: bool = False,
    off_screen: bool = False,
    shape: Optional[Sequence[int]] = None,
    window_size: Sequence[int] = (512, 512),
    background: str = "white",
    colormap: Union[str, List[str], None] = "rainbow",
    ambient: float = 0.2,
    opacity: Union[float, Sequence[float]] = 1.0,
    model_style: Union[str, Sequence[str]] = "surface",
    model_size: Union[float, Sequence[float]] = 3.0,
    show_legend: bool = True,
    text: Union[str, List[str], None] = None,
    **kwargs,
):
    """One 3D panel per model (parity: reference `three_d_multi_plot`)."""
    plt = _pyplot()

    models = _as_model_list(model)
    n = len(models)
    keys = key if isinstance(key, (list, tuple)) else [key] * n
    cmaps = colormap if isinstance(colormap, (list, tuple)) else [colormap] * n
    styles = list(model_style) if isinstance(model_style, (list, tuple)) else [model_style] * n
    sizes = list(model_size) if isinstance(model_size, (list, tuple)) else [model_size] * n
    texts = text if isinstance(text, (list, tuple)) else [text] * n

    if isinstance(shape, str):
        # reference string descriptors (three_dims_plots.py:391-397):
        # "a|b" = a panels in the left column, b in the right;
        # "a/b" = a panels on top, b at the bottom
        import re

        a, b = map(int, re.split(r"[/|]", shape))
        fig = plt.figure(figsize=(window_size[0] / 100 * 2, window_size[1] / 100 * 2))
        fig.patch.set_facecolor(background)
        flat = []
        if "|" in shape:
            import matplotlib.gridspec as gridspec

            gs = gridspec.GridSpec(max(a, b) or 1, 2)
            for i in range(a):
                flat.append(fig.add_subplot(gs[i, 0], projection="3d"))
            for i in range(b):
                flat.append(fig.add_subplot(gs[i, 1], projection="3d"))
        else:
            import matplotlib.gridspec as gridspec

            gs = gridspec.GridSpec(2, max(a, b) or 1)
            for i in range(a):
                flat.append(fig.add_subplot(gs[0, i], projection="3d"))
            for i in range(b):
                flat.append(fig.add_subplot(gs[1, i], projection="3d"))
        for axp in flat:
            axp.set_facecolor(background)
            axp.set_axis_off()
        flat = np.asarray(flat, dtype=object)
    else:
        if shape is None:
            ncols = min(4, n)
            nrows = int(np.ceil(n / ncols))
        else:
            nrows, ncols = shape
        fig, axes = create_plotter(nrows, ncols, window_size=window_size, background=background)
        flat = axes.ravel()
    for i, m in enumerate(models):
        add_model(flat[i], m, key=keys[i], colormap=cmaps[i], ambient=ambient,
                  opacity=opacity if np.isscalar(opacity) else opacity[i],
                  model_style=styles[i], model_size=sizes[i])
        if texts[i]:
            flat[i].set_title(texts[i], fontsize=9)
        if show_legend:
            add_legend(flat[i])
    for j in range(n, len(flat)):
        flat[j].set_visible(False)
    return output_plotter(fig, filename=filename, jupyter=jupyter)


def three_d_animate(
    models,
    stable_model=None,
    stable_kwargs: Optional[dict] = None,
    key: Optional[str] = None,
    filename: str = "animate.gif",
    jupyter: bool = False,
    off_screen: bool = False,
    window_size: Sequence[int] = (512, 512),
    background: str = "white",
    colormap: Union[str, None] = "rainbow",
    ambient: float = 0.2,
    opacity: float = 1.0,
    model_style: str = "points",
    model_size: float = 3.0,
    framerate: int = 24,
    **kwargs,
):
    """Animate a sequence of models (e.g. morphopath snapshots) into a GIF
    (parity: reference three_dims_plots.py:573 `three_d_animate` —
    `stable_model` draws a time-invariant model under every frame with its
    own `stable_kwargs` style; pyvista movie -> matplotlib FuncAnimation +
    PillowWriter)."""
    from matplotlib import animation

    plt = _pyplot()

    models = _as_model_list(models)
    fig, axes = create_plotter(1, 1, window_size=window_size, background=background)
    ax = axes[0, 0]
    sk = dict(key=key, colormap=colormap, ambient=ambient, opacity=opacity,
              model_style=model_style, model_size=model_size)
    if stable_kwargs:
        sk.update({k: v for k, v in stable_kwargs.items() if k in sk})

    def update(i):
        ax.clear()
        ax.set_axis_off()
        if stable_model is not None:
            add_model(ax, stable_model, **sk)
        add_model(ax, models[i], key=key, colormap=colormap, ambient=ambient,
                  opacity=opacity, model_style=model_style, model_size=model_size)
        ax.set_title(f"frame {i}")
        return []

    anim = animation.FuncAnimation(fig, update, frames=len(models), blit=False)
    anim.save(filename, writer=animation.PillowWriter(fps=framerate))
    plt.close(fig)
    return filename


def merge_animations(
    mp4_files: Optional[List[str]] = None,
    gif_files: Optional[List[str]] = None,
    mp4_folder: Optional[str] = None,
    filename: str = "merged.gif",
    **kwargs,
):
    """Concatenate animation files into one GIF (parity: reference
    `merge_animations`; ffmpeg/moviepy replaced by PIL frame stitching)."""
    from PIL import Image, ImageSequence

    files = list(gif_files or []) + list(mp4_files or [])
    if mp4_folder:
        import glob
        import os

        files += sorted(glob.glob(os.path.join(mp4_folder, "*.gif")))
    frames = []
    duration = 100
    for f in files:
        with Image.open(f) as im:
            duration = im.info.get("duration", duration)
            for frame in ImageSequence.Iterator(im):
                frames.append(frame.convert("RGB"))
    if not frames:
        raise ValueError("no frames found to merge")
    frames[0].save(filename, save_all=True, append_images=frames[1:], duration=duration, loop=0)
    return filename


def wrap_to_plotter(ax, model, key=None, **kwargs):
    """Draw a model onto an existing 3D axes (parity surface: reference
    three_dims_plots.py wrap_to_plotter)."""
    from .three_dims_plotter import add_model

    return add_model(ax, model, key=key, **kwargs)


def _adata_pointcloud(adata, spatial_key: str = "spatial", values=None, key: str = "val"):
    from ...tdr.models.mesh_core import PointCloud

    pts = np.asarray(adata.obsm[spatial_key], float)
    if pts.shape[1] == 2:
        pts = np.concatenate([pts, np.zeros((len(pts), 1))], 1)
    pd_data = {key: np.asarray(values)} if values is not None else {}
    return PointCloud(pts[:, :3], pd_data)


def _write_scatter3d(save_path, fig):
    """Write a rendered 3D scatter to `save_path`.

    The reference emits a plotly HTML document (three_dims_plots.py:937
    fig.write_html); plotly is absent from this environment, so `.html`
    targets get a standalone HTML page embedding the rendered PNG, and
    image extensions are written directly."""
    import base64
    import io

    plt = _pyplot()

    if str(save_path).endswith(".html"):
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=150, bbox_inches="tight")
        payload = base64.b64encode(buf.getvalue()).decode("ascii")
        with open(save_path, "w") as f:
            f.write(
                "<!DOCTYPE html><html><body style='margin:0'>"
                f"<img style='width:100%' src='data:image/png;base64,{payload}'/>"
                "</body></html>"
            )
    else:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def _celltype_color_mapping(adata, group_key, colors, ct_subset):
    """Reference quick_plot_3D_celltypes grouping: when `ct_subset` covers
    fewer types than present, cells outside it are relabeled 'Other'
    (ref three_dims_plots.py:850-859); colors are assigned in descending
    frequency order, with 'Other' pinned to light grey."""
    all_cts = adata.obs[group_key].unique()
    labels = adata.obs[group_key].astype(str)
    used_temp = False
    if ct_subset is not None and len(ct_subset) < len(all_cts):
        labels = labels.apply(lambda v: v if v in ct_subset else "Other")
        used_temp = True
    mapping = dict(zip(labels.value_counts().index, colors))
    if used_temp:
        mapping["Other"] = "#D3D3D3"
    return labels, mapping


def quick_plot_3D_celltypes(
    adata,
    save_path: str,
    colors: Optional[list] = None,
    coords_key: str = "spatial",
    group_key: str = "celltype",
    opacity: float = 1.0,
    title: Optional[str] = None,
    ct_subset: Optional[list] = None,
    size: float = 2.0,
):
    """3D cell scatter colored by cell type, written to `save_path`
    (parity: reference three_dims_plots.py:807 — same signature, 'Other'
    relabeling, frequency-ordered godsnot palette; plotly HTML replaced
    by an embedded-PNG HTML page)."""
    from ..colorlabel import godsnot_102

    plt = _pyplot()

    if colors is None:
        colors = godsnot_102
    if coords_key not in adata.obsm.keys():
        raise ValueError(f"adata.obsm does not contain {coords_key}- spatial coordinates could not be found.")
    if group_key not in adata.obs.keys():
        raise ValueError(f"adata.obs does not contain {group_key}- cell type labels could not be found.")
    if adata.obsm[coords_key].shape[1] != 3:
        raise ValueError(f"{coords_key} must be 3-dimensional.")

    coords = np.asarray(adata.obsm[coords_key], float)
    labels, mapping = _celltype_color_mapping(adata, group_key, colors, ct_subset)

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for ct, color in mapping.items():
        m = (labels == ct).values
        ax.scatter(
            coords[m, 0], coords[m, 1], coords[m, 2],
            color=color, s=size, alpha=opacity if ct == "Other" else 1.0,
            label=ct, linewidths=0,
        )
    ax.legend(loc="center left", bbox_to_anchor=(1.02, 0.5), fontsize=9, markerscale=4)
    if title is None:
        title = "Cell Types of Interest" if ct_subset is not None else "Cells, Colored by Type"
    ax.set_title(title, fontsize=14)
    ax.set_axis_off()
    _equalize_3d(ax, coords)
    _write_scatter3d(save_path, fig)
    return mapping


def _expression_percentile_clip(expr: np.ndarray, pcutoff: float) -> np.ndarray:
    """Clip expression at the `pcutoff` percentile (ref
    three_dims_plots.py:975-976)."""
    expr = np.asarray(expr, float).copy()
    cutoff = np.percentile(expr, pcutoff)
    expr[expr > cutoff] = cutoff
    return expr


def plot_expression_3D(
    adata,
    save_path: str,
    gene: str,
    coords_key: str = "spatial",
    group_key: Optional[str] = None,
    ct_subset: Optional[list] = None,
    pcutoff: Optional[float] = 99.7,
    zero_opacity: float = 1.0,
    size: int = 2,
):
    """3D scatter of one gene's expression (parity: reference
    three_dims_plots.py:940 — same signature; percentile clipping, the
    zero/non-zero split with separate zero opacity, and the 'Hot'
    colorscale are preserved)."""
    from scipy.sparse import issparse

    plt = _pyplot()

    if group_key is not None:
        if group_key not in adata.obs.keys():
            raise ValueError(f"adata.obs does not contain {group_key}- cell type labels could not be found.")
        adata = adata[adata.obs[group_key].isin(ct_subset), :].copy()

    coords = np.asarray(adata.obsm[coords_key], float)
    X = adata[:, gene].X
    expr = np.asarray(X.toarray() if issparse(X) else X).flatten()
    expr = _expression_percentile_clip(expr, pcutoff)

    zeros = expr == 0
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    sc = ax.scatter(
        coords[~zeros, 0], coords[~zeros, 1], coords[~zeros, 2],
        c=expr[~zeros], cmap="hot", s=size, linewidths=0,
        vmin=0.0, vmax=max(expr.max(), 1e-12),
    )
    if zeros.any():
        ax.scatter(
            coords[zeros, 0], coords[zeros, 1], coords[zeros, 2],
            color="#000000", s=size, alpha=zero_opacity, linewidths=0,
        )
    fig.colorbar(sc, ax=ax, shrink=0.6, pad=0.08, label=str(gene))
    ax.set_title(str(gene), fontsize=16)
    ax.set_axis_off()
    _equalize_3d(ax, coords)
    _write_scatter3d(save_path, fig)
    return expr


def _gene_expression_categories(adata, genes) -> "pd.Series":
    """Assign each cell an exclusivity category (ref
    three_dims_plots.py:1109-1121): 'Multiple genes' when >1 of `genes`
    are detected, the gene name when exactly one is, else 'None'. The
    per-gene boolean columns, 'gene_expressed', and 'gene_expr_category'
    are written into adata.obs exactly as the reference does."""
    import pandas as pd
    from scipy.sparse import issparse

    for gene in genes:
        X = adata[:, gene].X
        expr = np.asarray(X.toarray() if issparse(X) else X).flatten()
        adata.obs.loc[expr > 0, gene] = True
    adata.obs["gene_expressed"] = adata.obs[genes].sum(axis=1)
    adata.obs["gene_expr_category"] = "None"
    adata.obs.loc[adata.obs["gene_expressed"] > 1, "gene_expr_category"] = "Multiple genes"
    for gene in genes:
        adata.obs.loc[
            (adata.obs[gene] == True) & (adata.obs["gene_expr_category"] == "None"), "gene_expr_category"
        ] = gene
    return adata.obs["gene_expr_category"]


def plot_multiple_genes_3D(
    adata,
    genes: list,
    save_path: str,
    colors: Optional[list] = None,
    coords_key: str = "spatial",
    group_key: Optional[str] = None,
    ct_subset: Optional[list] = None,
    size: int = 2,
):
    """Exclusivity/overlap view of several genes in 3D (parity: reference
    three_dims_plots.py:1075 — same signature; single-gene cells keep
    their gene color, multi-gene cells are grey, silent cells are
    omitted)."""
    plt = _pyplot()

    if colors is None:
        from ..colorlabel import vega_10

        colors = vega_10
    if group_key is not None:
        if group_key not in adata.obs.keys():
            raise ValueError(f"adata.obs does not contain {group_key} - cell type labels could not be found.")
        adata = adata[adata.obs[group_key].isin(ct_subset), :].copy()

    coords = np.asarray(adata.obsm[coords_key], float)
    categories = _gene_expression_categories(adata, list(genes))

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for gene, color in zip(list(genes) + ["Multiple genes"], colors):
        if gene == "Multiple genes":
            color = "#D3D3D3"
        m = (categories == gene).values
        ax.scatter(coords[m, 0], coords[m, 1], coords[m, 2], color=color, s=size, label=gene, linewidths=0)
    ax.legend(loc="center left", bbox_to_anchor=(1.02, 0.5), fontsize=10, markerscale=4)
    ax.set_title("Expression Patterns", fontsize=16)
    ax.set_axis_off()
    _equalize_3d(ax, coords)
    _write_scatter3d(save_path, fig)
    return categories


def _center_shift_norm(coords: np.ndarray, center: float) -> np.ndarray:
    """Normalize to [0,1] then re-center the colormap midpoint (ref
    three_dims_plots.py:1244-1252): values below 0.5 are scaled onto
    [0, center], values above onto [center, 1]."""
    coords = np.asarray(coords, float)
    norm = (coords - np.min(coords)) / (np.max(coords) - np.min(coords))
    if center != 0.5:
        norm = np.where(
            norm <= 0.5,
            norm * center / 0.5,
            1 - (1 - norm) * (1 - center) / 0.5,
        )
    return norm


def visualize_3D_increasing_direction_gradient(
    adata,
    save_path: str,
    color_key: str = "spatial",
    coord_key: str = "spatial",
    coord_column: int = 0,
    cmap: str = "viridis",
    center: float = 0.5,
    opacity: float = 1.0,
    title: Optional[str] = None,
):
    """Color a 3D scatter by increasing value of one coordinate/obs column
    (parity: reference three_dims_plots.py:1201 — same signature and
    center-shifted normalization)."""
    import matplotlib as mpl
    import pandas as pd

    plt = _pyplot()

    if color_key not in adata.obsm.keys() and color_key not in adata.obs.keys():
        raise ValueError(f"Key {color_key} not found in adata.obsm or adata.obs.")
    if coord_key not in adata.obsm.keys():
        raise ValueError(f"Key {coord_key} pointing to array containing 3D coordinates not found in adata.obsm.")

    if color_key in adata.obsm.keys():
        vals = adata.obsm[color_key]
        vals = vals.values[:, coord_column] if isinstance(vals, pd.DataFrame) else np.asarray(vals)[:, coord_column]
    else:
        vals = adata.obs[color_key].values
    norm = _center_shift_norm(vals, center)
    point_colors = mpl.colormaps[cmap](norm)

    coords = np.asarray(adata.obsm[coord_key], float)
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(coords[:, 0], coords[:, 1], coords[:, 2], color=point_colors, s=2, alpha=opacity, linewidths=0)
    if title is not None:
        ax.set_title(title, fontsize=14)
    ax.set_axis_off()
    _equalize_3d(ax, coords)
    _write_scatter3d(save_path, fig)
    return norm
