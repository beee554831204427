"""The core 3D renderer (counterpart of
`spateo_tpu.plotting.three_d_plot.three_dims_plotter`; reference
spateo/plotting/static/three_d_plot/three_dims_plotter.py:1-665): mplot3d
Poly3DCollection / scatter3D over the tdr `PointCloud` / `Mesh` /
`LineModel` classes. Host code, copied; matplotlib and mpl_toolkits are
imported inside the functions that draw, since the GPU machine has no
matplotlib."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import pandas as pd

from ..utils import DEFAULT_PALETTE, _pyplot, check_colornorm, resolve_cmap


def _resolve_scalars(model, key):
    if key is None:
        return None
    if isinstance(key, str):
        return np.asarray(model.point_data[key]) if key in getattr(model, "point_data", {}) else None
    return np.asarray(key)


def add_model(
    ax,
    model,
    key: Optional[str] = None,
    colormap: Union[str, None] = "rainbow",
    ambient: float = 0.2,
    opacity: float = 1.0,
    model_style: str = "surface",
    model_size: float = 3.0,
    color: Optional[str] = None,
):
    """Draw one tdr model onto a 3D axes (parity surface: the reference
    plotter's `add_model`, three_dims_plotter.py:120). Dispatches on model
    type: Mesh -> shaded Poly3DCollection, LineModel -> Line3DCollection,
    PointCloud -> scatter."""
    from mpl_toolkits.mplot3d.art3d import Line3DCollection, Poly3DCollection

    pts = np.asarray(model.points, dtype=float)
    scalars = _resolve_scalars(model, key)
    cm = resolve_cmap(colormap if isinstance(colormap, str) else None, "rainbow")

    if hasattr(model, "faces") and model_style in ("surface", "wireframe"):
        tris = pts[np.asarray(model.faces)]
        if scalars is not None and np.issubdtype(np.asarray(scalars).dtype, np.number):
            fvals = np.asarray(scalars, float)[np.asarray(model.faces)].mean(1)
            norm = check_colornorm(float(fvals.min()), float(fvals.max()))
            face_colors = cm(norm(fvals))
        else:
            face_colors = color or "#cccccc"
        # Lambert-ish shading from the +z light to keep depth readable
        if model_style == "surface":
            n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
            n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-12
            shade = ambient + (1 - ambient) * np.abs(n[:, 2])
            if not isinstance(face_colors, str):
                face_colors = np.asarray(face_colors)
                face_colors[:, :3] *= shade[:, None]
        pc = Poly3DCollection(tris, facecolors=face_colors, alpha=opacity,
                              edgecolors="k" if model_style == "wireframe" else "none", linewidths=0.1)
        ax.add_collection3d(pc)
    elif hasattr(model, "lines") or hasattr(model, "edges"):
        edge_idx = np.asarray(model.lines if hasattr(model, "lines") else model.edges)
        segs = pts[edge_idx]
        if scalars is not None and np.issubdtype(np.asarray(scalars).dtype, np.number):
            svals = np.asarray(scalars, float)[edge_idx].mean(1)
            norm = check_colornorm(float(svals.min()), float(svals.max()))
            lc = Line3DCollection(segs, colors=cm(norm(svals)), alpha=opacity, linewidths=model_size / 2)
        else:
            lc = Line3DCollection(segs, colors=color or "black", alpha=opacity, linewidths=model_size / 2)
        ax.add_collection3d(lc)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=model_size, color=color or "black", alpha=opacity)
    else:
        if scalars is not None:
            arr = np.asarray(scalars)
            if np.issubdtype(arr.dtype, np.number):
                ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=arr.astype(float), cmap=cm, s=model_size, alpha=opacity, linewidths=0)
            else:
                svals = pd.Series(arr).astype(str).values
                cats = list(pd.unique(svals))
                for i, c in enumerate(cats):
                    m = svals == c
                    ax.scatter(pts[m, 0], pts[m, 1], pts[m, 2],
                               color=color or DEFAULT_PALETTE[i % len(DEFAULT_PALETTE)],
                               s=model_size, alpha=opacity, label=c, linewidths=0)
        else:
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], color=color or "tab:blue", s=model_size, alpha=opacity, linewidths=0)
    _equalize_3d(ax, pts)
    return ax


def add_model_outline(ax, model, color: str = "black", linewidth: float = 1.0):
    """Bounding-box outline (parity: three_dims_plotter.py outline)."""
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    pts = np.asarray(model.points)
    mins, maxs = pts.min(0), pts.max(0)
    corners = np.array([[x, y, z] for x in (mins[0], maxs[0]) for y in (mins[1], maxs[1]) for z in (mins[2], maxs[2])])
    edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    ax.add_collection3d(Line3DCollection(corners[np.asarray(edges)], colors=color, linewidths=linewidth))
    return ax


def add_legend(ax, title: Optional[str] = None, **kwargs):
    handles, labels = ax.get_legend_handles_labels()
    if handles:
        ax.legend(handles, labels, title=title, fontsize=7, markerscale=2, frameon=False, loc="center left", bbox_to_anchor=(1.05, 0.5))
    return ax


def _equalize_3d(ax, pts: np.ndarray):
    """Force an equal aspect box so geometry isn't distorted."""
    lims = np.asarray([ax.get_xlim(), ax.get_ylim(), ax.get_zlim()])
    mins = np.minimum(lims[:, 0], pts.min(0))
    maxs = np.maximum(lims[:, 1], pts.max(0))
    center = (mins + maxs) / 2
    half = (maxs - mins).max() / 2
    ax.set_xlim(center[0] - half, center[0] + half)
    ax.set_ylim(center[1] - half, center[1] + half)
    ax.set_zlim(center[2] - half, center[2] + half)


def create_plotter(
    nrows: int = 1,
    ncols: int = 1,
    window_size: Sequence[int] = (512, 512),
    background: str = "white",
    **kwargs,
):
    """Create a figure + 3D axes grid (parity surface: the reference's
    `create_plotter`, three_dims_plotter.py:18)."""
    plt = _pyplot()
    dpi = 100
    fig, axes = plt.subplots(
        nrows, ncols,
        figsize=(window_size[0] / dpi * ncols, window_size[1] / dpi * nrows),
        subplot_kw={"projection": "3d"}, squeeze=False,
    )
    for a in axes.ravel():
        a.set_facecolor(background)
        a.set_axis_off()
    fig.patch.set_facecolor(background)
    return fig, axes


def output_plotter(
    plotter,
    filename: Optional[str] = None,
    view_up: tuple = (0.5, 0.5, 1),
    framerate: int = 15,
    jupyter: bool = False,
    dpi: int = 150,
):
    """Save or return the rendered figure (parity: reference
    three_dims_plotter.py:533-600): image extensions save a still; a
    ``.gif``/``.mp4`` filename writes a camera ORBIT of the scene at
    `framerate` fps (the reference's orbit-on-path movie; `view_up` tips the
    starting elevation of the mpl orbit)."""
    plt = _pyplot()
    fig = plotter
    if filename:
        if str(filename).lower().endswith((".gif", ".mp4")):
            from matplotlib import animation

            axes3d = [a for a in fig.axes if hasattr(a, "view_init")]
            elev = float(np.degrees(np.arctan2(view_up[2], np.hypot(view_up[0], view_up[1]))))

            def orbit(frame):
                for a in axes3d:
                    a.view_init(elev=elev, azim=frame * (360 / 36))
                return []

            anim = animation.FuncAnimation(fig, orbit, frames=36, blit=False)
            writer = animation.PillowWriter(fps=framerate) if str(filename).lower().endswith(".gif") else animation.FFMpegWriter(fps=framerate)
            anim.save(filename, writer=writer, dpi=min(dpi, 100))
            plt.close(fig)
            return filename
        fig.savefig(filename, dpi=dpi, bbox_inches="tight")
        plt.close(fig)
        return filename
    return fig


# -- reference-named plotter helpers (three_dims_plotter.py) -----------------


def add_outline(plotter_or_ax, model, outline_width: float = 5.0, outline_color: str = "black", **kwargs):
    """Reference-named front end of add_model_outline."""
    return add_model_outline(plotter_or_ax, model, color=outline_color, linewidth=outline_width / 5)


def add_text(ax, text: str, font_size: int = 12, font_color: str = "black", text_loc: str = "upper_left", **kwargs):
    """Overlay text on a 3D axes (parity: three_dims_plotter.py add_text)."""
    locs = {"upper_left": (0.02, 0.95), "upper_right": (0.75, 0.95), "lower_left": (0.02, 0.02), "lower_right": (0.75, 0.02)}
    x, y = locs.get(text_loc, (0.02, 0.95))
    ax.text2D(x, y, text, transform=ax.transAxes, fontsize=font_size, color=font_color)
    return ax


def add_str_legend(ax, labels, colors=None, title: str = "", **kwargs):
    """Categorical legend from explicit label/color lists
    (parity: three_dims_plotter.py add_str_legend)."""
    plt = _pyplot()

    colors = colors or [DEFAULT_PALETTE[i % len(DEFAULT_PALETTE)] for i in range(len(labels))]
    handles = [plt.Line2D([], [], marker="o", ls="", color=c, label=str(l)) for l, c in zip(labels, colors)]
    ax.legend(handles=handles, title=title or None, fontsize=7, markerscale=1.5, frameon=False,
              loc="center left", bbox_to_anchor=(1.05, 0.5))
    return ax


def add_num_legend(ax, mappable=None, title: str = "", **kwargs):
    """Colorbar legend (parity: three_dims_plotter.py add_num_legend)."""
    plt = _pyplot()

    if mappable is None:
        for c in ax.collections:
            if getattr(c, "get_array", lambda: None)() is not None:
                mappable = c
                break
    if mappable is not None:
        cb = plt.colorbar(mappable, ax=ax, shrink=0.6)
        if title:
            cb.set_label(title)
    return ax


def save_plotter(fig, filename: str, dpi: int = 150):
    """Persist a rendered figure (parity: three_dims_plotter.py
    save_plotter)."""
    fig.savefig(filename, dpi=dpi, bbox_inches="tight")
    return filename
