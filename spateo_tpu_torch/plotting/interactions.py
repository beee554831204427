"""CCI interaction visualizations (counterpart of
`spateo_tpu.plotting.interactions`; reference
spateo/plotting/static/interactions.py:37 `ligrec`, :319
`plot_connections`).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import pandas as pd

from .dotplot import CCDotplot
from .utils import _pyplot, resolve_cmap, save_return_show_fig_utils


def ligrec(
    adata,
    dict_key: str,
    source_groups: Union[None, str, List[str]] = None,
    target_groups: Union[None, str, List[str]] = None,
    means_range: Tuple[float, float] = (-np.inf, np.inf),
    pvalue_threshold: float = 1.0,
    remove_empty_interactions: bool = True,
    remove_nonsig_interactions: bool = False,
    dendrogram: Union[None, str] = None,
    alpha: float = 0.001,
    swap_axes: bool = False,
    title: Optional[str] = None,
    figsize: Optional[Tuple[float, float]] = None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    **kwargs,
):
    """Ligand-receptor interaction dotplot (parity: reference
    interactions.py:37). `adata.uns[dict_key]` must hold 'means' and
    'pvalues' DataFrames indexed by interaction pair with cluster-pair
    columns (MultiIndex or 'source|target' strings)."""
    d = adata.uns[dict_key]
    means = pd.DataFrame(d["means"]).copy()
    pvals = pd.DataFrame(d["pvalues"]).copy()

    def _sel(df):
        cols = df.columns
        if isinstance(cols, pd.MultiIndex):
            src = cols.get_level_values(0).astype(str)
            tgt = cols.get_level_values(1).astype(str)
        else:
            parts = [str(c).split("|") for c in cols]
            src = np.asarray([p[0] for p in parts])
            tgt = np.asarray([p[-1] for p in parts])
        keep = np.ones(len(cols), dtype=bool)
        if source_groups is not None:
            sset = {source_groups} if isinstance(source_groups, str) else set(map(str, source_groups))
            keep &= np.isin(src, list(sset))
        if target_groups is not None:
            tset = {target_groups} if isinstance(target_groups, str) else set(map(str, target_groups))
            keep &= np.isin(tgt, list(tset))
        return df.loc[:, cols[keep]]

    means, pvals = _sel(means), _sel(pvals)
    row_keep = ((means >= means_range[0]) & (means <= means_range[1])).any(axis=1) & (pvals <= pvalue_threshold).any(axis=1)
    means, pvals = means.loc[row_keep], pvals.loc[row_keep]
    if remove_empty_interactions:
        m = ~(means.isna().all(axis=1) | pvals.isna().all(axis=1))
        means, pvals = means.loc[m], pvals.loc[m]
    if remove_nonsig_interactions:
        m = (pvals <= alpha).any(axis=1)
        means, pvals = means.loc[m], pvals.loc[m]
    if means.empty:
        raise ValueError("no interactions survive the ligrec filters")

    # dot size: capped -log10(p); dot color: log-transformed mean
    minus_log = -np.log10(np.clip(pvals.values.astype(float), 1e-10, 1.0))
    delta = max(minus_log.max(), 1e-12)
    size_df = pd.DataFrame(minus_log / delta, index=pvals.index, columns=pvals.columns)
    color_df = pd.DataFrame(np.log1p(means.values.astype(float)), index=means.index, columns=means.columns)
    sig_df = pd.DataFrame(pvals.values.astype(float) <= alpha, index=pvals.index, columns=pvals.columns)
    if isinstance(color_df.columns, pd.MultiIndex):
        flat = [" | ".join(map(str, c)) for c in color_df.columns]
        color_df.columns = flat
        size_df.columns = flat
        sig_df.columns = flat
    color_df.index = [str(i) for i in color_df.index]
    size_df.index = list(color_df.index)
    sig_df.index = list(color_df.index)

    if dendrogram in ("interacting_molecules", "both"):
        from scipy.cluster import hierarchy as sch
        from scipy.spatial.distance import pdist

        order = sch.dendrogram(sch.linkage(pdist(size_df.values), method="ward"), no_plot=True)["leaves"]
        color_df, size_df, sig_df = color_df.iloc[order], size_df.iloc[order], sig_df.iloc[order]
    if dendrogram in ("interacting_clusters", "both") and color_df.shape[1] > 2:
        from scipy.cluster import hierarchy as sch
        from scipy.spatial.distance import pdist

        order = sch.dendrogram(sch.linkage(pdist(size_df.values.T), method="ward"), no_plot=True)["leaves"]
        color_df, size_df, sig_df = color_df.iloc[:, order], size_df.iloc[:, order], sig_df.iloc[:, order]

    dp = CCDotplot(delta=delta, minn=0.0, alpha=alpha, sig_df=sig_df, dot_color_df=color_df, dot_size_df=size_df,
                   title=title or "Ligand-Receptor Inference", figsize=figsize)
    if swap_axes:
        dp.swap_axes()
    dp.style(cmap=kwargs.pop("cmap", "magma_r"), largest_dot=kwargs.pop("largest_dot", 120.0))
    dp.make_figure()
    return save_return_show_fig_utils(save_show_or_return, True, None, "ligrec", save_kwargs, 1, dp.fig, dp.ax)


def _connection_matrix(adata, cat_key, spatial_key, n_neighbors, W=None):
    """Label-pair adjacency counts from a spatial KNN graph."""
    from scipy.sparse import issparse

    cats = pd.Series(np.asarray(adata.obs[cat_key])).astype(str)
    uniq = list(pd.unique(cats))
    code = np.asarray([uniq.index(c) for c in cats])
    if W is None:
        pts = np.asarray(adata.obsm[spatial_key])[:, :2]
        d2 = ((pts[:, None] - pts[None, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        nbr = np.argsort(d2, axis=1)[:, :n_neighbors]
        rows = np.repeat(np.arange(len(pts)), n_neighbors)
        cols = nbr.ravel()
        vals = np.ones(len(rows))
    else:
        Wd = W.tocoo() if issparse(W) else None
        if Wd is not None:
            rows, cols, vals = Wd.row, Wd.col, Wd.data
        else:
            rows, cols = np.nonzero(np.asarray(W))
            vals = np.asarray(W)[rows, cols]
    K = len(uniq)
    M = np.zeros((K, K))
    np.add.at(M, (code[rows], code[cols]), vals)
    M = (M + M.T) / 2
    return M, uniq


def plot_connections(
    adata,
    cat_key: str,
    spatial_key: str = "spatial",
    n_spatial_neighbors: Optional[int] = 6,
    spatial_weights_matrix=None,
    expr_weights_matrix=None,
    reverse_expr_plot_orientation: bool = True,
    ax=None,
    figsize: tuple = (3, 3),
    zero_self_connections: bool = True,
    normalize_by_self_connections: bool = False,
    shapes_style: bool = True,
    max_scale: float = 0.46,
    colormap="Spectral",
    title_str: Optional[str] = None,
    title_fontsize: Optional[float] = None,
    label_fontsize: Optional[float] = None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
):
    """Pairwise label colocalization strength, as a scaled-square (or
    heatmap) upper-triangle matrix (parity: reference interactions.py:319).
    With `expr_weights_matrix`, a second panel shows expression-space
    connections."""
    from matplotlib.patches import Rectangle

    plt = _pyplot()

    M, names = _connection_matrix(adata, cat_key, spatial_key, n_spatial_neighbors or 6, spatial_weights_matrix)
    mats = [("spatial", M)]
    if expr_weights_matrix is not None:
        Me, _ = _connection_matrix(adata, cat_key, spatial_key, n_spatial_neighbors or 6, expr_weights_matrix)
        mats.append(("expression", Me))

    if ax is None:
        fig, axes = plt.subplots(1, len(mats), figsize=(figsize[0] * 1.2 * len(mats), figsize[1]), squeeze=False)
        axes = axes.ravel()
    else:
        fig = ax.figure
        axes = np.asarray([ax])

    cm = resolve_cmap(colormap if isinstance(colormap, str) else None, "Spectral")
    K = len(names)
    for pi, (pname, Mi) in enumerate(mats[: len(axes)]):
        a = axes[pi]
        Mi = Mi.copy()
        if zero_self_connections:
            np.fill_diagonal(Mi, 0)
        elif normalize_by_self_connections:
            Mi /= np.maximum(np.diag(Mi)[:, None], 1e-12)
        vmax = Mi.max() + 1e-12
        if shapes_style:
            for i in range(K):
                for j in range(K):
                    if pname == "expression" and reverse_expr_plot_orientation:
                        draw = j <= i
                    else:
                        draw = j >= i
                    if not draw:
                        continue
                    s = max_scale * np.sqrt(Mi[i, j] / vmax)
                    if s <= 0:
                        continue
                    a.add_patch(Rectangle((j - s, K - 1 - i - s), 2 * s, 2 * s, facecolor=cm(i / max(K - 1, 1)), edgecolor="none"))
            a.set_xlim(-0.6, K - 0.4)
            a.set_ylim(-0.6, K - 0.4)
        else:
            a.imshow(Mi, cmap=cm)
        a.set_xticks(range(K))
        a.set_xticklabels(names, rotation=90, fontsize=label_fontsize or 7)
        a.set_yticks(range(K))
        a.set_yticklabels(names[::-1] if shapes_style else names, fontsize=label_fontsize or 7)
        a.set_title(pname if title_str is None else title_str, fontsize=title_fontsize or 10)
        a.set_aspect("equal")
    return save_return_show_fig_utils(save_show_or_return, False, None, "plot_connections", save_kwargs, len(mats), fig, (fig, list(axes[: len(mats)])))
