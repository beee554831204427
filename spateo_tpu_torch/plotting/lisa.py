"""LISA hot/cold-spot plots (counterpart of `spateo_tpu.plotting.lisa`;
reference spateo/plotting/static/lisa.py:7 `lisa_quantiles`, :33 `lisa` —
geopandas `df.plot` replaced by plain matplotlib scatters of the x/y columns
that `st.tl.lisa_geo_df` emits).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
from .utils import _pyplot


def lisa_quantiles(df: pd.DataFrame, ax=None):
    """Expression vs. spatial-lag scatter with the HH/HL/LH/LL quadrants
    (parity: reference lisa.py:7)."""
    plt = _pyplot()

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    x = np.asarray(df["exp_zscore"], float)
    y = np.asarray(df["w_exp_zscore"], float)
    ax.scatter(x, y, s=6, color="red", alpha=0.6, linewidths=0)
    # least-squares trend (sns.regplot equivalent)
    if len(x) > 1:
        b, a = np.polyfit(x, y, 1)
        xs = np.linspace(x.min(), x.max(), 50)
        ax.plot(xs, a + b * xs, color="red")
    ax.axvline(0, c="k", alpha=0.5)
    ax.axhline(0, c="k", alpha=0.5)
    ax.text(1, 1.5, "HH", fontsize=25)
    ax.text(1, -1.5, "HL", fontsize=25)
    ax.text(-1.5, 1.5, "LH", fontsize=25)
    ax.text(-1.5, -1.5, "LL", fontsize=25)
    ax.set_xlabel("exp_zscore")
    ax.set_ylabel("w_exp_zscore")
    return ax


def _cat_scatter(ax, df, column, cmap_colors, order=None):
    from matplotlib import colors

    vals = df[column].astype(str)
    cats = order or sorted(pd.unique(vals))
    hmap = colors.ListedColormap(cmap_colors)
    for i, c in enumerate(cats):
        m = (vals == c).values
        ax.scatter(df.loc[m, "x"], df.loc[m, "y"], s=4, color=hmap(i % hmap.N), label=c, linewidths=0)
    ax.legend(fontsize=6, markerscale=2, frameon=False)
    ax.set_aspect("equal")
    ax.set_axis_off()


def lisa(df: pd.DataFrame):
    """Four-panel LISA summary: raw score, quadrant, significance, category
    (parity: reference lisa.py:33)."""
    plt = _pyplot()

    f, axs = plt.subplots(nrows=2, ncols=2, figsize=(12, 12))
    axs = axs.flatten()

    sc = axs[0].scatter(df["x"], df["y"], c=df["Is"], cmap="viridis", s=4, alpha=0.75, linewidths=0)
    plt.colorbar(sc, ax=axs[0], shrink=0.6)
    axs[0].set_aspect("equal")
    axs[0].set_axis_off()
    axs[0].set_title("LISA score")

    _cat_scatter(axs[1], df, "labels", ["red", "lightblue", "blue", "pink"])
    axs[1].set_title("quadrant")
    _cat_scatter(axs[2], df, "sig", ["grey", "black"])
    axs[2].set_title("significance")
    _cat_scatter(axs[3], df, "group", ["grey", "red", "lightblue", "blue", "pink"])
    axs[3].set_title("category")
    return axs
