"""Alignment 3D plots (counterpart of
`spateo_tpu.plotting.three_d_plot.align_plots`; reference
spateo/plotting/static/three_d_plot/align_plots.py:46 `multi_models`, :304
`deformation`).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from ...tdr.models.mesh_core import PointCloud
from .three_dims_plots import three_d_multi_plot, three_d_plot
from ..utils import _pyplot


def _slice_points_labels(a, spatial_key, group_key, id_key, layer, center_zero, index):
    """Extract (points, labels, id) for one slice the way the reference's
    construct_pc call does (align_plots.py:105-130): 2D coords get z=0,
    labels come from obs[group_key], a gene column, or the model id."""
    pts = np.asarray(a.obsm[spatial_key], dtype=float)
    if pts.shape[1] == 2:
        pts = np.concatenate([pts, np.zeros((len(pts), 1))], axis=1)
    if center_zero:
        pts = pts - pts.mean(0)
    model_id = str(a.obs[id_key].unique().tolist()[0]) if id_key in a.obs.columns else str(index)
    if group_key is not None and group_key in a.obs.columns:
        labels = np.asarray(a.obs[group_key]).astype(str)
    elif group_key is not None and group_key in list(map(str, a.var_names)):
        X = a.layers[layer] if layer != "X" else a.X
        X = X.toarray() if hasattr(X, "toarray") else np.asarray(X)
        labels = np.asarray(X)[:, list(map(str, a.var_names)).index(group_key)].astype(float)
    else:
        labels = np.full(len(pts), model_id)
    return pts, labels, model_id


def multi_models(
    *adata,
    layer: str = "X",
    group_key: Optional[str] = None,
    spatial_key: str = "align_spatial",
    id_key: str = "slices",
    mode: str = "single",
    center_zero: bool = False,
    filename: Optional[str] = None,
    jupyter: Union[bool, str] = False,
    off_screen: bool = False,
    cpo: Union[str, list] = "xy",
    shape=None,
    window_size=None,
    background: str = "white",
    colormap: Union[str, list, dict] = "red",
    overlap_cmap: Union[str, list, dict] = "dodgerblue",
    alphamap: float = 1.0,
    overlap_amap: float = 0.5,
    ambient: float = 0.2,
    opacity: float = 1.0,
    model_size: Union[float, list] = 3.0,
    show_legend: bool = True,
    text: Union[bool, str] = True,
    **kwargs,
):
    """Visualize aligned slices (parity: reference align_plots.py:46 —
    same signature and modes). ``mode='single'`` renders one panel per
    slice; ``'overlap'`` renders each consecutive pair front-to-back in
    one panel (first slice in `overlap_cmap` at `overlap_amap`, second in
    `colormap`); ``'both'`` interleaves the two singles and their overlap
    per pair. Slice ids come from ``.obs[id_key]`` and title each panel."""
    import matplotlib.colors as mcolors
    plt = _pyplot()

    from .three_dims_plotter import add_legend, add_model, create_plotter, output_plotter

    adata_list = adata[0] if len(adata) == 1 and isinstance(adata[0], (list, tuple)) else list(adata)
    slices = [
        _slice_points_labels(a, spatial_key, group_key, id_key, layer, center_zero, i)
        for i, a in enumerate(adata_list)
    ]

    def _pc(pts, labels):
        return PointCloud(pts, {"label": labels})

    # panels: list of (models, colors, alphas, title)
    panels = []
    if mode in ("single", "both"):
        for pts, labels, mid in slices:
            panels.append(([_pc(pts, labels)], [colormap], [alphamap], f"Model id: {mid}"))
    if mode in ("overlap", "both"):
        overlap_panels = []
        for i in range(len(slices) - 1):
            (p1, l1, id1), (p2, l2, id2) = slices[i], slices[i + 1]
            overlap_panels.append(
                ([_pc(p1, l1), _pc(p2, l2)], [overlap_cmap, colormap], [overlap_amap, alphamap],
                 f"Model id: {id1} & {id2}")
            )
        if mode == "both":
            # reference order per pair: slice i, slice i+1, overlap
            merged = []
            for i in range(len(overlap_panels)):
                merged.extend([panels[i], panels[i + 1], overlap_panels[i]])
            panels = merged
        else:
            panels = overlap_panels

    n = len(panels)
    if shape is None:
        ncols = min(3, n)
        nrows = int(np.ceil(n / 3))
    else:
        nrows, ncols = shape
    fig, axes = create_plotter(nrows, ncols, window_size=window_size or (512, 512), background=background)
    flat = axes.ravel()
    for i, (models, colors, alphas, title) in enumerate(panels):
        for m, c, al in zip(models, colors, alphas):
            is_color = isinstance(c, str) and mcolors.is_color_like(c)
            add_model(flat[i], m, key="label", colormap=None if is_color else c,
                      color=c if is_color else None, opacity=al, ambient=ambient,
                      model_style="points", model_size=model_size if np.isscalar(model_size) else model_size[0])
        if text:
            flat[i].set_title(title if text is True else text, fontsize=9)
        if cpo == "xy":
            flat[i].view_init(elev=90, azim=-90)
        elif cpo == "xz":
            flat[i].view_init(elev=0, azim=-90)
        elif cpo == "yz":
            flat[i].view_init(elev=0, azim=0)
        if show_legend:
            add_legend(flat[i])
    for j in range(n, len(flat)):
        flat[j].set_visible(False)
    return output_plotter(fig, filename=filename, jupyter=bool(jupyter))


def deformation(
    *adata,
    deformed_grid=None,
    layer: str = "X",
    group_key: Optional[str] = None,
    spatial_key: str = "align_spatial",
    id_key: str = "slices",
    deformation_key: Optional[str] = "deformation",
    center_zero: bool = False,
    show_model: bool = True,
    filename: Optional[str] = None,
    jupyter: Union[bool, str] = False,
    off_screen: bool = False,
    cpo: Union[str, list] = "xy",
    shape=None,
    window_size=None,
    background: str = "white",
    model_color: Union[str, list] = "red",
    model_alpha: float = 1.0,
    colormap: Union[str, list, dict] = "black",
    alphamap: float = 1.0,
    ambient: float = 0.2,
    opacity: float = 1.0,
    grid_size: float = 2.0,
    model_size: float = 3.0,
    show_legend: bool = False,
    text: Union[bool, str] = True,
    **kwargs,
):
    """One panel per slice: the deformed grid wireframe (colored by the
    |velocity| scalar in ``point_data[deformation_key]``) with the cell
    model's points overlaid (parity: reference align_plots.py:304 — same
    signature; `deformed_grid` comes from st.align.grid_deformation)."""
    import matplotlib.colors as mcolors

    from .three_dims_plotter import add_model, create_plotter, output_plotter

    adata_list = adata[0] if len(adata) == 1 and isinstance(adata[0], (list, tuple)) else list(adata)
    grid_list = deformed_grid if isinstance(deformed_grid, (list, tuple)) else [deformed_grid]
    assert len(adata_list) == len(grid_list), (
        "The number of Anndata objects is not equal to the number of deformed grids."
    )

    n = len(adata_list)
    if shape is None:
        ncols = min(3, n)
        nrows = int(np.ceil(n / 3))
    else:
        nrows, ncols = shape
    fig, axes = create_plotter(nrows, ncols, window_size=window_size or (1024, 756), background=background)
    flat = axes.ravel()
    for i, (a, grid) in enumerate(zip(adata_list, grid_list)):
        model_id = str(a.obs[id_key].unique().tolist()[0]) if id_key in a.obs.columns else str(i)
        grid_is_color = isinstance(colormap, str) and mcolors.is_color_like(colormap)
        add_model(flat[i], grid, key=None if deformation_key is None or grid_is_color else deformation_key,
                  colormap=None if grid_is_color else colormap,
                  color=colormap if grid_is_color else None,
                  opacity=alphamap, model_style="wireframe", model_size=grid_size)
        if show_model:
            pts, labels, _ = _slice_points_labels(a, spatial_key, group_key, id_key, layer, center_zero, i)
            is_color = isinstance(model_color, str) and mcolors.is_color_like(model_color)
            add_model(flat[i], PointCloud(pts, {"label": labels}), key="label",
                      colormap=None if is_color else model_color,
                      color=model_color if is_color else None,
                      opacity=model_alpha, model_style="points", model_size=model_size)
        if text:
            flat[i].set_title(f"Model id: {model_id}" if text is True else text, fontsize=9)
        if cpo == "xy":
            flat[i].view_init(elev=90, azim=-90)
    for j in range(n, len(flat)):
        flat[j].set_visible(False)
    return output_plotter(fig, filename=filename, jupyter=bool(jupyter))
