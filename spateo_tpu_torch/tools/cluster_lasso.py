"""Lasso ROI selection on spatial scatter
(capability parity: reference spateo/tools/cluster_lasso.py:18 `Lasso` —
plotly FigureWidget replaced by matplotlib's LassoSelector, plus a
headless `select(polygon)` API so pipelines can use the same point-in-
polygon machinery without a GUI).

Counterpart of `spateo_tpu.tools.cluster_lasso`: host code, copied;
matplotlib is imported inside `Lasso.vi_plot` only.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _points_in_polygon(points: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Vectorized ray-casting point-in-polygon test."""
    x, y = points[:, 0], points[:, 1]
    px, py = np.asarray(polygon, float).T
    n = len(px)
    inside = np.zeros(len(points), bool)
    j = n - 1
    for i in range(n):
        cond = ((py[i] > y) != (py[j] > y)) & (
            x < (px[j] - px[i]) * (y - py[i]) / (py[j] - py[i] + 1e-300) + px[i]
        )
        inside ^= cond
        j = i
    return inside


class Lasso:
    """Lasso a region of interest based on spatial coordinates
    (parity surface: reference cluster_lasso.py:18).

    Examples:
        L = st.tl.Lasso(adata)
        sub = L.select(polygon)          # headless
        L.vi_plot(group="leiden")         # interactive
    """

    sub_adata = None

    def __init__(self, adata):
        self.adata = adata
        self._sub_index: Optional[np.ndarray] = None

    def select(self, polygon: np.ndarray, key: str = "spatial"):
        """Subset cells inside `polygon` ([K, 2] vertices); returns the
        sub-AnnData and caches it on the instance."""
        pts = np.asarray(self.adata.obsm[key], float)[:, :2]
        mask = _points_in_polygon(pts, np.asarray(polygon, float))
        self._sub_index = np.flatnonzero(mask)
        Lasso.sub_adata = self.adata[self._sub_index]
        return Lasso.sub_adata

    def vi_plot(self, key: str = "spatial", group: Optional[str] = None, group_color: Optional[str] = None):
        """Interactive lasso on a matplotlib scatter (parity:
        cluster_lasso.py:35). Drag to select; the selection subsets
        `Lasso.sub_adata`."""
        import matplotlib.pyplot as plt
        from matplotlib.path import Path as MplPath
        from matplotlib.widgets import LassoSelector


        # the JAX package's plotting.utils.DEFAULT_PALETTE
        DEFAULT_PALETTE = [c for name in ("tab20", "tab20b", "tab20c") for c in plt.get_cmap(name).colors]
        pts = np.asarray(self.adata.obsm[key], float)[:, :2]
        fig, ax = plt.subplots(figsize=(7, 7))
        if group is not None:
            import pandas as pd

            labels = pd.Series(np.asarray(self.adata.obs[group])).astype(str)
            color_map = self.adata.uns.get(group_color) if group_color else None
            cats = list(pd.unique(labels))
            if color_map is None:
                color_map = {c: DEFAULT_PALETTE[i % len(DEFAULT_PALETTE)] for i, c in enumerate(cats)}
            colors = [color_map[l] for l in labels]
        else:
            colors = "tab:blue"
        sc = ax.scatter(pts[:, 0], pts[:, 1], s=4, c=colors, alpha=0.5, linewidths=0)
        ax.set_aspect("equal")

        def on_select(verts):
            path = MplPath(verts)
            mask = path.contains_points(pts)
            self._sub_index = np.flatnonzero(mask)
            Lasso.sub_adata = self.adata[self._sub_index]
            fc = sc.get_facecolors()
            if len(fc) == 1:
                fc = np.tile(fc, (len(pts), 1))
            fc[:, 3] = np.where(mask, 1.0, 0.15)
            sc.set_facecolors(fc)
            fig.canvas.draw_idle()

        selector = LassoSelector(ax, on_select)
        ax._spateo_lasso = selector  # keep a reference alive
        plt.show()
        return Lasso.sub_adata
