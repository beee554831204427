"""Shared plotting helpers (counterpart of `spateo_tpu.plotting.utils`;
reference spateo/plotting/static/utils.py:37-1878): colour-vector
resolution, hex conversion, the save/show/return protocol, colour
normalisation, dendrograms. Host code, copied; matplotlib is imported inside
the functions that use it (`_pyplot` picks the Agg backend where no display
is set), since the GPU machine has none, and `DEFAULT_PALETTE` is written
out as data.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd

from ..logging import logger_manager as lm

# ---------------------------------------------------------------------------
# default palettes
# ---------------------------------------------------------------------------

#: categorical palette used when a grouping has no registered colors:
#: matplotlib's tab20, tab20b and tab20c, as RGB
DEFAULT_PALETTE: List[Tuple[float, float, float]] = [
    (0.12156862745098039, 0.4666666666666667, 0.7058823529411765),
    (0.6823529411764706, 0.7803921568627451, 0.9098039215686274),
    (1.0, 0.4980392156862745, 0.054901960784313725),
    (1.0, 0.7333333333333333, 0.47058823529411764),
    (0.17254901960784313, 0.6274509803921569, 0.17254901960784313),
    (0.596078431372549, 0.8745098039215686, 0.5411764705882353),
    (0.8392156862745098, 0.15294117647058825, 0.1568627450980392),
    (1.0, 0.596078431372549, 0.5882352941176471),
    (0.5803921568627451, 0.403921568627451, 0.7411764705882353),
    (0.7725490196078432, 0.6901960784313725, 0.8352941176470589),
    (0.5490196078431373, 0.33725490196078434, 0.29411764705882354),
    (0.7686274509803922, 0.611764705882353, 0.5803921568627451),
    (0.8901960784313725, 0.4666666666666667, 0.7607843137254902),
    (0.9686274509803922, 0.7137254901960784, 0.8235294117647058),
    (0.4980392156862745, 0.4980392156862745, 0.4980392156862745),
    (0.7803921568627451, 0.7803921568627451, 0.7803921568627451),
    (0.7372549019607844, 0.7411764705882353, 0.13333333333333333),
    (0.8588235294117647, 0.8588235294117647, 0.5529411764705883),
    (0.09019607843137255, 0.7450980392156863, 0.8117647058823529),
    (0.6196078431372549, 0.8549019607843137, 0.8980392156862745),
    (0.2235294117647059, 0.23137254901960785, 0.4745098039215686),
    (0.3215686274509804, 0.32941176470588235, 0.6392156862745098),
    (0.4196078431372549, 0.43137254901960786, 0.8117647058823529),
    (0.611764705882353, 0.6196078431372549, 0.8705882352941177),
    (0.38823529411764707, 0.4745098039215686, 0.2235294117647059),
    (0.5490196078431373, 0.6352941176470588, 0.3215686274509804),
    (0.7098039215686275, 0.8117647058823529, 0.4196078431372549),
    (0.807843137254902, 0.8588235294117647, 0.611764705882353),
    (0.5490196078431373, 0.42745098039215684, 0.19215686274509805),
    (0.7411764705882353, 0.6196078431372549, 0.2235294117647059),
    (0.9058823529411765, 0.7294117647058823, 0.3215686274509804),
    (0.9058823529411765, 0.796078431372549, 0.5803921568627451),
    (0.5176470588235295, 0.23529411764705882, 0.2235294117647059),
    (0.6784313725490196, 0.28627450980392155, 0.2901960784313726),
    (0.8392156862745098, 0.3803921568627451, 0.4196078431372549),
    (0.9058823529411765, 0.5882352941176471, 0.611764705882353),
    (0.4823529411764706, 0.2549019607843137, 0.45098039215686275),
    (0.6470588235294118, 0.3176470588235294, 0.5803921568627451),
    (0.807843137254902, 0.42745098039215684, 0.7411764705882353),
    (0.8705882352941177, 0.6196078431372549, 0.8392156862745098),
    (0.19215686274509805, 0.5098039215686274, 0.7411764705882353),
    (0.4196078431372549, 0.6823529411764706, 0.8392156862745098),
    (0.6196078431372549, 0.792156862745098, 0.8823529411764706),
    (0.7764705882352941, 0.8588235294117647, 0.9372549019607843),
    (0.9019607843137255, 0.3333333333333333, 0.050980392156862744),
    (0.9921568627450981, 0.5529411764705883, 0.23529411764705882),
    (0.9921568627450981, 0.6823529411764706, 0.4196078431372549),
    (0.9921568627450981, 0.8156862745098039, 0.6352941176470588),
    (0.19215686274509805, 0.6392156862745098, 0.32941176470588235),
    (0.4549019607843137, 0.7686274509803922, 0.4627450980392157),
    (0.6313725490196078, 0.8509803921568627, 0.6078431372549019),
    (0.7803921568627451, 0.9137254901960784, 0.7529411764705882),
    (0.4588235294117647, 0.4196078431372549, 0.6941176470588235),
    (0.6196078431372549, 0.6039215686274509, 0.7843137254901961),
    (0.7372549019607844, 0.7411764705882353, 0.8627450980392157),
    (0.8549019607843137, 0.8549019607843137, 0.9215686274509803),
    (0.38823529411764707, 0.38823529411764707, 0.38823529411764707),
    (0.5882352941176471, 0.5882352941176471, 0.5882352941176471),
    (0.7411764705882353, 0.7411764705882353, 0.7411764705882353),
    (0.8509803921568627, 0.8509803921568627, 0.8509803921568627),
]


def _pyplot():
    """matplotlib's pyplot, on the Agg backend where no display is set."""
    import matplotlib

    if os.environ.get("DISPLAY") is None and matplotlib.get_backend().lower() not in ("agg", "pdf", "svg"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def is_gene_name(adata, var: str) -> bool:
    """True if `var` names a gene (reference utils.py:37)."""
    return isinstance(var, str) and var in set(map(str, adata.var_names))


def is_cell_anno_column(adata, var: str) -> bool:
    """True if `var` names an obs column (reference utils.py:44)."""
    return isinstance(var, str) and var in adata.obs.columns


def is_layer_keys(adata, var: str) -> bool:
    """True if `var` names a layer (reference utils.py:51)."""
    return isinstance(var, str) and var in adata.layers


def _get_adata_color_vec(adata, layer: str, col: str) -> np.ndarray:
    """Resolve a color vector from obs / gene expression / layer
    (reference utils.py:62)."""
    from scipy.sparse import issparse

    if is_cell_anno_column(adata, col):
        return np.asarray(adata.obs[col])
    if is_gene_name(adata, col):
        j = list(map(str, adata.var_names)).index(col)
        M = adata.X if layer in (None, "X") else adata.layers[layer]
        v = M[:, j]
        return np.asarray(v.toarray()).ravel() if issparse(M) else np.asarray(v).ravel()
    raise ValueError(f"color key `{col}` is neither an obs column nor a gene name")


def map2color(val, min=None, max=None, cmap: str = "viridis"):
    """Map scalars to RGBA via a colormap (reference utils.py:77)."""
    from matplotlib import colormaps
    from matplotlib.colors import Normalize

    val = np.asarray(val, dtype=float)
    lo = np.nanmin(val) if min is None else min
    hi = np.nanmax(val) if max is None else max
    norm = Normalize(vmin=lo, vmax=hi)
    return colormaps[cmap](norm(val))


def _to_hex(arr) -> List[str]:
    """RGBA array -> hex strings (reference utils.py:91)."""
    from matplotlib.colors import to_hex

    return [to_hex(c) for c in np.asarray(arr)]


def _select_font_color(background: str) -> str:
    """Pick a readable font color for the background (reference utils.py:141)."""
    from matplotlib.colors import to_rgba

    r, g, b, _ = to_rgba(background)
    return "black" if (0.299 * r + 0.587 * g + 0.114 * b) > 0.5 else "white"


def check_colornorm(
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    vcenter: Optional[float] = None,
    norm: Optional[Normalize] = None,
) -> Normalize:
    """Build a matplotlib Normalize honoring vmin/vmax/vcenter
    (reference utils.py:1578)."""
    from matplotlib.colors import Normalize, TwoSlopeNorm

    if norm is not None:
        return norm
    if vcenter is not None:
        return TwoSlopeNorm(vcenter=vcenter, vmin=vmin, vmax=vmax)
    return Normalize(vmin=vmin, vmax=vmax)


def resolve_cmap(cmap: Union[str, Colormap, None], default: str = "viridis") -> Colormap:
    from matplotlib import colormaps

    if cmap is None:
        return colormaps[default]
    if isinstance(cmap, str):
        return colormaps[cmap]
    return cmap


def get_color_map_matplotlib(*args, **kwargs):  # pragma: no cover - thin alias
    return resolve_cmap(*args, **kwargs)


def despline(ax: Optional[Axes] = None) -> None:
    """Remove the top/right spines (reference utils.py:870)."""
    ax = ax or _pyplot().gca()
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)


def despline_all(ax: Optional[Axes] = None, sides: Optional[Sequence[str]] = None) -> None:
    """Remove all (or selected) spines (reference utils.py:882)."""
    ax = ax or _pyplot().gca()
    for side in sides or ("top", "right", "bottom", "left"):
        ax.spines[side].set_visible(False)


def deaxis_all(ax: Optional[Axes] = None) -> None:
    """Hide both axes (reference utils.py:894)."""
    ax = ax or _pyplot().gca()
    ax.get_xaxis().set_visible(False)
    ax.get_yaxis().set_visible(False)


def quiver_autoscaler(X_emb: np.ndarray, V_emb: np.ndarray) -> float:
    """Estimate a quiver scale so arrows are visible but non-overlapping
    (reference utils.py:1098)."""
    X_emb, V_emb = np.asarray(X_emb), np.asarray(V_emb)
    span = np.abs(np.ptp(X_emb[:, 0])) + np.abs(np.ptp(X_emb[:, 1]))
    mean_len = np.mean(np.sqrt((V_emb[:, :2] ** 2).sum(1))) + 1e-12
    return float(mean_len / (0.01 * span + 1e-12))


def save_fig(
    path: Optional[str] = None,
    prefix: Optional[str] = None,
    dpi: Optional[int] = None,
    ext: str = "pdf",
    transparent: bool = True,
    close: bool = True,
    verbose: bool = True,
) -> None:
    """Save the current figure (reference utils.py:1200)."""
    plt = _pyplot()
    path = path or os.getcwd()
    prefix = prefix or "figure"
    if os.path.splitext(path)[1]:
        savepath = path
    else:
        os.makedirs(path, exist_ok=True)
        savepath = os.path.join(path, f"{prefix}.{ext}")
    if verbose:
        lm.main_info(f"Saving figure to {savepath}...")
    plt.savefig(savepath, dpi=dpi, transparent=transparent, bbox_inches="tight")
    if close:
        plt.close()


def save_return_show_fig_utils(
    save_show_or_return: str,
    show_legend: bool,
    background: Optional[str],
    prefix: str,
    save_kwargs: Optional[dict],
    total_panels: int,
    fig: Figure,
    axes,
    return_all: bool = False,
    return_all_list=None,
):
    """The reference's unified figure exit protocol (utils.py:1476):
    'save' writes to disk, 'show' calls plt.show, 'return' hands back the
    axes; 'both'/'all' combine."""
    plt = _pyplot()
    save_kwargs = save_kwargs or {}
    if save_show_or_return in ("save", "both", "all"):
        s_kwargs = {"path": None, "prefix": prefix, "dpi": None, "ext": "pdf", "close": save_show_or_return == "save"}
        s_kwargs.update(save_kwargs)
        save_fig(**s_kwargs)
    if save_show_or_return in ("show", "both", "all"):
        if show_legend:
            plt.subplots_adjust(right=0.85)
        plt.show()
    if save_show_or_return in ("return", "all"):
        if return_all and return_all_list is not None:
            return return_all_list
        return axes
    return None


def deduplicate_kwargs(kwargs_dict: dict, **kwargs) -> dict:
    """Fill defaults without clobbering user kwargs (reference utils.py:1627)."""
    out = dict(kwargs)
    out.update(kwargs_dict)
    return out


def _get_array_values(X, dim_names, keys, axis, backed=False) -> np.ndarray:
    """Column extraction helper (reference utils.py:1530)."""
    from scipy.sparse import issparse

    idx = [list(map(str, dim_names)).index(str(k)) for k in keys]
    sub = X[:, idx] if axis == 1 else X[idx, :]
    return np.asarray(sub.toarray() if issparse(sub) else sub)


# ---------------------------------------------------------------------------
# categorical color handling
# ---------------------------------------------------------------------------


def get_categorical_colors(
    adata, key: str, values: Optional[np.ndarray] = None
) -> Tuple[List[str], dict]:
    """Categories + a name->hex mapping, honoring `adata.uns[f'{key}_colors']`
    if present (scanpy/reference convention)."""
    from matplotlib.colors import to_hex

    vals = np.asarray(adata.obs[key]) if values is None else np.asarray(values)
    cats = list(pd.unique(pd.Series(vals).astype(str)))
    try:
        cats = sorted(cats, key=lambda c: (len(c), c))
    except Exception:  # pragma: no cover
        pass
    stored = adata.uns.get(f"{key}_colors") if adata is not None else None
    if stored is not None and len(stored) >= len(cats):
        colors = [to_hex(c) for c in stored[: len(cats)]]
    else:
        colors = [to_hex(DEFAULT_PALETTE[i % len(DEFAULT_PALETTE)]) for i in range(len(cats))]
    return cats, dict(zip(cats, colors))


# ---------------------------------------------------------------------------
# dendrogram (host scipy; reference utils.py:1648-1878)
# ---------------------------------------------------------------------------


def _dendrogram_sig(data: np.ndarray, method: str = "ward", **kwargs):
    """Hierarchical ordering of rows/cols (reference utils.py:1648)."""
    from scipy.cluster import hierarchy as sch
    from scipy.spatial.distance import pdist

    link = sch.linkage(pdist(data), method=method)
    dend = sch.dendrogram(link, no_plot=True)
    leaves = dend["leaves"]
    return leaves, dend["icoord"], dend["dcoord"], link


def dendrogram(
    adata,
    cat_key,
    n_pcs: int = 30,
    use_rep: Optional[str] = None,
    var_names: Optional[Sequence[str]] = None,
    cor_method: str = "pearson",
    linkage_method: str = "complete",
    optimal_ordering: bool = False,
    key_added: Optional[str] = None,
    inplace: bool = True,
    device="cuda",
):
    """Hierarchical clustering of the categories in `cat_key` (reference
    utils.py:1669-1818): per-category means of the chosen representation
    (PCA by default), a `cor_method` correlation matrix between category
    means, and `linkage_method` linkage on 1 - correlation. `cat_key` may be
    a list — categories are merged by string concatenation. Stores (or
    returns, with `inplace=False`) the reference's dict: linkage, cat_key,
    use_rep, cor_method, linkage_method, categories_ordered,
    categories_idx_ordered, dendrogram_info, correlation_matrix. The PCA it
    computes on demand is the port's ARPACK `PCA` on `device`."""
    from scipy.cluster import hierarchy as sch
    from scipy.sparse import issparse
    from scipy.spatial import distance

    cat_keys = cat_key if isinstance(cat_key, list) else [cat_key]
    for cat in cat_keys:
        if cat not in adata.obs.columns:
            raise KeyError(f"'cat_key' has to be a valid observation; got {cat!r}")

    groups = np.asarray(adata.obs[cat_keys[0]]).astype(str)
    for cat in cat_keys[1:]:
        groups = np.char.add(np.char.add(groups, "_"), np.asarray(adata.obs[cat]).astype(str))

    if var_names is not None:
        idx = [list(map(str, adata.var_names)).index(str(g)) for g in var_names]
        M = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X)
        M = M[:, idx]
    elif use_rep is not None:
        if use_rep == "X":
            M = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X)
        elif use_rep in adata.obsm:
            M = np.asarray(adata.obsm[use_rep])
            if n_pcs is not None and n_pcs <= M.shape[1]:
                M = M[:, :n_pcs]
        else:
            raise KeyError(f"Did not find {use_rep} in `.obsm.keys()`.")
    elif n_pcs == 0 or adata.n_vars <= n_pcs:
        M = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X)
    else:
        # PCA representation (computed on demand, as the reference does)
        if "X_pca" in adata.obsm and adata.obsm["X_pca"].shape[1] >= n_pcs:
            M = np.asarray(adata.obsm["X_pca"])[:, :n_pcs]
        else:
            from ..tools.dimensionality_reduction import PCA

            Xd = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X)
            pca = PCA(n_components=min(n_pcs, Xd.shape[1] - 1), svd_solver="arpack", random_state=0, device=device)
            M = pca.fit(Xd).transform(Xd)
            adata.obsm["X_pca"] = M

    cats = list(pd.unique(groups))
    mean_df = pd.DataFrame(np.asarray(M, float)).groupby(pd.Series(groups, name="_cat").values).mean()
    cats = list(mean_df.index)
    corr_matrix = mean_df.T.corr(method=cor_method)
    corr_condensed = distance.squareform(1 - corr_matrix)
    z_var = sch.linkage(corr_condensed, method=linkage_method, optimal_ordering=optimal_ordering)
    dendro_info = sch.dendrogram(z_var, labels=list(cats), no_plot=True)

    dat = dict(
        linkage=z_var,
        cat_key=cat_keys,
        use_rep=use_rep,
        cor_method=cor_method,
        linkage_method=linkage_method,
        categories_ordered=dendro_info["ivl"],
        categories_idx_ordered=dendro_info["leaves"],
        dendrogram_info=dendro_info,
        correlation_matrix=corr_matrix.values,
    )
    if inplace:
        if key_added is None:
            key_added = f'dendrogram_{"_".join(cat_keys)}'
        adata.uns[key_added] = dat
        return None
    return dat


def _translate_pos(pos_list, new_ticks, old_ticks):
    """Dendrogram leaf coordinates -> custom tick positions (reference
    utils.py:1867-1901); interior joins interpolate between neighbors."""
    if not isinstance(old_ticks, list):
        old_ticks = list(old_ticks)
    new_xs = []
    for x_val in pos_list:
        if x_val in old_ticks:
            new_x_val = new_ticks[old_ticks.index(x_val)]
        else:
            idx_next = int(np.searchsorted(old_ticks, x_val, side="left"))
            idx_prev = idx_next - 1
            old_min, old_max = old_ticks[idx_prev], old_ticks[idx_next]
            new_min, new_max = new_ticks[idx_prev], new_ticks[idx_next]
            new_x_val = ((x_val - old_min) / (old_max - old_min)) * (new_max - new_min) + new_min
        new_xs.append(new_x_val)
    return new_xs


def plot_dendrogram(
    dendro_ax: Axes,
    adata,
    cat_key,
    dendrogram_key: Optional[str] = None,
    orientation: str = "right",
    remove_labels: bool = True,
    ticks: Optional[Sequence[float]] = None,
):
    """Draw a stored dendrogram onto `dendro_ax` (reference
    utils.py:1820-1948): supports all four orientations with leaf tick
    labels, optional custom tick positions (heatmap row alignment), and the
    reference's axis/spine cleanup."""
    if not isinstance(dendrogram_key, str):
        dendrogram_key = f"dendrogram_{cat_key}" if isinstance(cat_key, str) else f'dendrogram_{"_".join(cat_key)}'
    if dendrogram_key not in adata.uns:
        dendrogram(adata, cat_key, key_added=dendrogram_key)
    if "dendrogram_info" not in adata.uns[dendrogram_key]:
        raise ValueError(f"The given dendrogram key ({dendrogram_key!r}) does not contain valid dendrogram information.")

    info = adata.uns[dendrogram_key]["dendrogram_info"]
    leaves = info.get("ivl", info.get("leaves"))
    icoord = np.asarray(info["icoord"])
    dcoord = np.asarray(info["dcoord"])
    orig_ticks = np.arange(5, len(leaves) * 10 + 5, 10).astype(float)
    if ticks is not None and len(orig_ticks) != len(ticks):
        ticks = None

    for xs, ys in zip(icoord, dcoord):
        if ticks is not None:
            xs = _translate_pos(list(xs), list(ticks), orig_ticks)
        if orientation in ("right", "left"):
            xs, ys = ys, xs
        dendro_ax.plot(xs, ys, color="#555555")

    dendro_ax.tick_params(bottom=False, top=False, left=False, right=False)
    ticks = ticks if ticks is not None else orig_ticks
    if orientation in ("right", "left"):
        dendro_ax.set_yticks(ticks)
        dendro_ax.set_yticklabels(leaves, fontsize="small", rotation=0)
        dendro_ax.tick_params(labelbottom=False, labeltop=False)
        if orientation == "left":
            xmin, xmax = dendro_ax.get_xlim()
            dendro_ax.set_xlim(xmax, xmin)
            dendro_ax.tick_params(labelleft=False, labelright=True)
    else:
        dendro_ax.set_xticks(ticks)
        dendro_ax.set_xticklabels(leaves, fontsize="small", rotation=90)
        dendro_ax.tick_params(labelleft=False, labelright=False)
        if orientation == "bottom":
            ymin, ymax = dendro_ax.get_ylim()
            dendro_ax.set_ylim(ymax, ymin)
            dendro_ax.tick_params(labeltop=True, labelbottom=False)
    if remove_labels:
        dendro_ax.tick_params(labelbottom=False, labeltop=False, labelleft=False, labelright=False)
    dendro_ax.grid(False)
    despline_all(dendro_ax)
    return dendro_ax


def arrowed_spines(ax: Axes, basis: str = "", background: str = "white"):
    """Replace box spines with small arrowed axes (reference utils.py:1002)."""
    despline_all(ax)
    fc = _select_font_color(background)
    xmin, xmax = ax.get_xlim()
    ymin, ymax = ax.get_ylim()
    dx, dy = (xmax - xmin) * 0.25, (ymax - ymin) * 0.25
    ax.annotate("", xy=(xmin + dx, ymin), xytext=(xmin, ymin), arrowprops=dict(arrowstyle="->", color=fc))
    ax.annotate("", xy=(xmin, ymin + dy), xytext=(xmin, ymin), arrowprops=dict(arrowstyle="->", color=fc))
    if basis:
        ax.text(xmin, ymin - dy * 0.15, f"{basis}_1", fontsize=8, color=fc)
        ax.text(xmin - dx * 0.12, ymin, f"{basis}_2", fontsize=8, color=fc, rotation=90)
    return ax


# -- small reference-named helpers (reference plotting/static/utils.py) -----


def is_list_of_lists(list_of_lists) -> bool:
    """(parity: utils.py:58)"""
    return isinstance(list_of_lists, (list, tuple)) and all(isinstance(x, (list, tuple)) for x in list_of_lists)


def default_quiver_args(arrow_size, arrow_len=None):
    """Quiver kwargs from an arrow-size scalar (parity: utils.py:1146)."""
    if isinstance(arrow_size, (list, tuple)) and len(arrow_size) == 3:
        head_w, head_l, ax_l = arrow_size
    elif isinstance(arrow_size, (int, float)):
        head_w, head_l, ax_l = 10 * arrow_size, 12 * arrow_size, 8 * arrow_size
    else:
        head_w, head_l, ax_l = 10, 12, 8
    scale = 1 / arrow_len if arrow_len is not None else 1 / head_w
    return head_w, head_l, ax_l, scale


def minimal_xticks(start, end):
    """Two-tick x axis (parity: utils.py:904)."""
    plt = _pyplot()
    end_ = np.around(end, -int(np.log10(max(abs(end), 1e-12))) + 1)
    xlims = np.array([start, end_ if end_ > end else end])
    plt.xticks(xlims)


def minimal_yticks(start, end):
    """Two-tick y axis (parity: utils.py:914)."""
    plt = _pyplot()
    end_ = np.around(end, -int(np.log10(max(abs(end), 1e-12))) + 1)
    ylims = np.array([start, end_ if end_ > end else end])
    plt.yticks(ylims)


def scatter_with_colorbar(fig, ax, x, y, c, cmap, **kwargs):
    """Scatter + attached colorbar (parity: utils.py:935)."""
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    g = ax.scatter(x, y, c=c, cmap=cmap, **kwargs)
    divider = make_axes_locatable(ax)
    cax = divider.append_axes("right", size="5%", pad=0.05)
    fig.colorbar(g, cax=cax, orientation="vertical")
    return fig, ax


def scatter_with_legend(fig, ax, df, font_color, x, y, c, cmap, legend, **kwargs):
    """Categorical scatter with on-data or side legend (parity:
    utils.py:947)."""
    import pandas as pd

    cats = pd.unique(np.asarray(c).astype(str))
    colors = resolve_cmap(cmap if isinstance(cmap, str) else None, "tab20")
    for i, cat in enumerate(cats):
        m = np.asarray(c).astype(str) == cat
        ax.scatter(np.asarray(x)[m], np.asarray(y)[m], color=colors(i / max(len(cats) - 1, 1)), label=cat, **kwargs)
    if legend == "on data":
        for cat in cats:
            m = np.asarray(c).astype(str) == cat
            ax.text(np.asarray(x)[m].mean(), np.asarray(y)[m].mean(), cat, color=font_color, ha="center", weight="bold")
    elif legend:
        ax.legend(loc="center left", bbox_to_anchor=(1, 0.5), frameon=False, fontsize=7)
    return fig, ax


def set_spine_linewidth(ax, lw):
    """Set all four spine linewidths (parity: utils.py:924)."""
    for side in ("top", "bottom", "left", "right"):
        ax.spines[side].set_linewidth(lw)
    return ax


def set_colorbar(ax, inset_dict={}):
    """Inset colorbar axes in the upper-right of `ax`
    (parity: utils.py:981 — same mpl_toolkits inset construction)."""
    from mpl_toolkits.axes_grid1.inset_locator import inset_axes

    if len(inset_dict) == 0:
        axins = inset_axes(
            ax,
            width="12%",
            height="100%",
            loc="upper right",
            bbox_to_anchor=(0.85, 0.97, 0.145, 0.17),
            bbox_transform=ax.transAxes,
            borderpad=1.85,
        )
    else:
        axins = inset_axes(ax, bbox_transform=ax.transAxes, **inset_dict)
    return axins


def tricubic(x):
    """Tricubic weight kernel (1-|x|^3)^3 on [-1, 1] (parity: utils.py:1379,
    the pyloess Loess weight; the framework's native loess lives at
    svg/utils.py `loess_1d`)."""
    x = np.asarray(x, float)
    y = np.zeros_like(x)
    idx = (x >= -1) & (x <= 1)
    y[idx] = np.power(1.0 - np.power(np.abs(x[idx]), 3), 3)
    return y


def set_arrow_alpha(ax=None, alpha: float = 1.0):
    """Set quiver alpha (parity: utils.py:1177)."""
    from matplotlib.quiver import Quiver

    ax = ax or _pyplot().gca()
    for child in ax.get_children():
        if isinstance(child, Quiver):
            child.set_alpha(alpha)
    return ax


def set_stream_line_alpha(s=None, alpha: float = 1.0):
    """Set streamline alpha (parity: utils.py:1190)."""
    if s is not None:
        s.lines.set_alpha(alpha)
        if hasattr(s, "arrows"):
            try:
                s.arrows.set_alpha(alpha)
            except Exception:
                pass
    return s


def alpha_shape(x, y, alpha):
    """Concave hull (parity: utils.py:1280 — delegates to io.bbs)."""
    from ..io.bbs import alpha_shape as _alpha

    return _alpha(x, y, alpha=alpha)


class Loess:
    """Loess smoother class (parity: utils.py:1386; wraps the svg layer's
    tricube local regression)."""

    def __init__(self, xx, yy, degree: int = 1):
        self.xx = np.asarray(xx, float)
        self.yy = np.asarray(yy, float)
        self.degree = degree

    def estimate(self, x, window: int = 10, use_matrix: bool = False, degree: int = 1):
        from ..svg.utils import loess_1d

        frac = min(max(window / max(len(self.xx), 1), 0.05), 1.0)
        _, smooth, _ = loess_1d(self.xx, self.yy, frac=frac, degree=degree)
        idx = int(np.argmin(np.abs(self.xx - x)))
        return smooth[idx]


def plot_polygon(polygon, margin: float = 1, fc: str = "#999999", ec: str = "#000000", fill: bool = True, ax=None, **kwargs):
    """Draw a polygon (parity: utils.py:1351 — delegates to pl.polygon)."""
    from .bbs import polygon as _poly

    return _poly(polygon, margin=margin, fc=fc, ec=ec, fill=fill, ax=ax, save_show_or_return="return", **kwargs)
