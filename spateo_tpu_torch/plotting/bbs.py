"""Boundary/polygon plots (counterpart of `spateo_tpu.plotting.bbs`;
reference spateo/plotting/static/bbs.py:18 `polygon`, :95 `delaunay`).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .utils import _pyplot, save_return_show_fig_utils


def polygon(
    concave_hull,
    figsize=(10, 10),
    margin: float = 0.3,
    fc: str = "#999999",
    ec: str = "#000000",
    fill: bool = True,
    ax=None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    **kwargs,
):
    """Plot an alpha-shape polygon (parity: reference bbs.py:18). Accepts the
    (vertices, edges) output of `spateo_tpu.io.bbs.alpha_shape` or a plain
    [N, 2] vertex loop."""
    plt = _pyplot()

    if ax is None:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.figure
    if isinstance(concave_hull, tuple) and len(concave_hull) == 2:
        verts, edges = concave_hull
        verts = np.asarray(verts)
        for i, j in np.asarray(edges):
            ax.plot(verts[[i, j], 0], verts[[i, j], 1], color=ec, **kwargs)
        if fill:
            ax.scatter(verts[:, 0], verts[:, 1], s=2, color=fc)
        pts = verts
    else:
        pts = np.asarray(concave_hull)
        ax.fill(pts[:, 0], pts[:, 1], fc=fc if fill else "none", ec=ec, **kwargs)
    span = np.ptp(pts, 0)
    ax.set_xlim(pts[:, 0].min() - margin * span[0], pts[:, 0].max() + margin * span[0])
    ax.set_ylim(pts[:, 1].min() - margin * span[1], pts[:, 1].max() + margin * span[1])
    ax.set_aspect("equal")
    return save_return_show_fig_utils(save_show_or_return, False, None, "polygon", save_kwargs, 1, fig, ax)


def delaunay(
    edge_points,
    figsize=(10, 10),
    pc: str = "#f16824",
    title: Optional[str] = None,
    fig=None,
    ax=None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    **kwargs,
):
    """Plot a Delaunay triangulation's edges (parity: reference bbs.py:95).
    `edge_points` is a sequence of 2x2 segments (as produced by
    `io.bbs.alpha_shape(..., return_edges=True)`) or an [E, 2, 2] array."""
    plt = _pyplot()

    if ax is None:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = fig or ax.figure
    segs = np.asarray(edge_points, dtype=float)
    for seg in segs:
        seg = np.asarray(seg).reshape(-1, 2)
        ax.plot(seg[:, 0], seg[:, 1], color=pc, lw=0.8, **kwargs)
    ax.set_title(title)
    ax.set_aspect("equal")
    return save_return_show_fig_utils(save_show_or_return, False, None, "delaunay", save_kwargs, 1, fig, ax)
