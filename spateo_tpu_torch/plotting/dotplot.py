"""Dotplot machinery (counterpart of `spateo_tpu.plotting.dotplot`;
reference spateo/plotting/static/dotplot.py:46 `adata_to_frame`, :258
`Dotplot`, :1513 `CCDotplot`, :1628 `dotplot`).

Lean re-design: one class computing (fraction, mean) matrices host-side and
rendering the scanpy-style dot grid + size legend + colorbar; the cell-cell
variant marks significant entries with open rings.

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd

from .utils import _pyplot, check_colornorm, plot_dendrogram, resolve_cmap, save_return_show_fig_utils


def adata_to_frame(
    adata,
    var_names: Sequence[str],
    cat_key: str,
    num_categories: int = 7,
    layer: Optional[str] = None,
    gene_symbols_key: Optional[str] = None,
) -> pd.DataFrame:
    """Long-form (cell, gene) expression frame with a category column
    (parity: reference dotplot.py:46)."""
    from scipy.sparse import issparse

    names = list(map(str, adata.var_names))
    if gene_symbols_key is not None:
        symbols = list(map(str, adata.var[gene_symbols_key]))
        idx = [symbols.index(str(g)) for g in var_names]
    else:
        idx = [names.index(str(g)) for g in var_names]
    M = adata.X if layer is None else adata.layers[layer]
    sub = M[:, idx]
    sub = np.asarray(sub.toarray() if issparse(sub) else sub)
    cats = np.asarray(adata.obs[cat_key])
    if np.issubdtype(cats.dtype, np.number) and len(np.unique(cats)) > num_categories:
        cats = pd.cut(cats, num_categories).astype(str)
    df = pd.DataFrame(sub, columns=[str(g) for g in var_names])
    df["_cat"] = pd.Series(cats).astype(str).values
    return df


class Dotplot:
    """Fraction-size / mean-color dot grid (parity surface: reference
    dotplot.py:258)."""

    default_dot_max = None
    default_dot_min = None
    default_smallest_dot = 0.0
    default_largest_dot = 200.0
    default_color_legend_title = "Mean expression\nin group"
    default_size_legend_title = "Fraction of cells\nin group (%)"

    def __init__(
        self,
        adata=None,
        var_names: Sequence[str] = (),
        cat_key: str = None,
        num_categories: int = 7,
        expression_cutoff: float = 0.0,
        mean_only_expressed: bool = False,
        standard_scale: Optional[str] = None,
        dot_color_df: Optional[pd.DataFrame] = None,
        dot_size_df: Optional[pd.DataFrame] = None,
        layer: Optional[str] = None,
        gene_symbols_key: Optional[str] = None,
        title: Optional[str] = None,
        figsize: Optional[Tuple[float, float]] = None,
        **kwargs,
    ):
        if dot_color_df is not None and dot_size_df is not None:
            self.dot_color_df, self.dot_size_df = dot_color_df, dot_size_df
        else:
            df = adata_to_frame(adata, var_names, cat_key, num_categories, layer, gene_symbols_key)
            grouped = df.groupby("_cat")
            frac = grouped.agg(lambda v: (np.asarray(v) > expression_cutoff).mean())
            if mean_only_expressed:
                mean = grouped.agg(lambda v: np.asarray(v)[np.asarray(v) > expression_cutoff].mean() if (np.asarray(v) > expression_cutoff).any() else 0.0)
            else:
                mean = grouped.mean()
            self.dot_size_df, self.dot_color_df = frac, mean
        if standard_scale == "var":
            c = self.dot_color_df
            self.dot_color_df = (c - c.min(0)) / (c.max(0) - c.min(0) + 1e-12)
        elif standard_scale == "group":
            c = self.dot_color_df
            self.dot_color_df = c.sub(c.min(1), axis=0).div(c.max(1) - c.min(1) + 1e-12, axis=0)
        self.title = title
        self.figsize = figsize
        self._style = dict(
            cmap="Reds", color_on="dot", dot_max=None, dot_min=None, smallest_dot=0.0,
            largest_dot=200.0, dot_edge_color="black", dot_edge_lw=0.2,
            size_exponent=1.5, grid=False, x_padding=0.8, y_padding=1.0,
        )
        self._legend = dict(
            show=True, show_size_legend=True, show_colorbar=True,
            colorbar_title=self.default_color_legend_title, size_title=self.default_size_legend_title,
            num_size_legend_dots=4,
        )
        self.are_axes_swapped = False
        self.ax_dict = None
        self.vmin = self.vmax = self.vcenter = self.norm = None
        self._adata = adata
        self._cat_key = cat_key
        self._dendrogram = None  # {"key": ..., "size": ...} set by add_dendrogram
        self.var_group_positions = kwargs.get("var_group_positions")
        self.var_group_labels = kwargs.get("var_group_labels")
        self.var_group_rotation = kwargs.get("var_group_rotation")

    def style(self, **kwargs):
        self._style.update({k: v for k, v in kwargs.items() if v is not None or k in ("dot_max", "dot_min")})
        return self

    def legend(self, show: bool = True, colorbar_title=None, size_title=None,
               show_size_legend: bool = True, show_colorbar: bool = True, **kwargs):
        self._legend["show"] = show
        self._legend["show_size_legend"] = show_size_legend
        self._legend["show_colorbar"] = show_colorbar
        if colorbar_title is not None:
            self._legend["colorbar_title"] = colorbar_title
        if size_title is not None:
            self._legend["size_title"] = size_title
        if "num_size_legend_dots" in kwargs and kwargs["num_size_legend_dots"]:
            self._legend["num_size_legend_dots"] = int(kwargs["num_size_legend_dots"])
        return self

    def swap_axes(self):
        """Flip the dot grid: x becomes the categories, y the var names
        (parity: reference dotplot.py:507 — a chainable method, not a flag)."""
        self.are_axes_swapped = True
        return self

    def get_axes(self):
        """Dict of the figure's axes, building the figure first if needed
        (parity: reference dotplot.py:703)."""
        if self.ax_dict is None:
            self.make_figure()
        return self.ax_dict

    def reorder_categories_after_dendrogram(self, dendrogram_key=None):
        """Reorder the category axis (and any var-group brackets) to the
        hierarchical-clustering order stored in `.uns[dendrogram_key]`,
        computing the dendrogram with default parameters if absent (parity:
        reference dotplot.py:1126)."""
        if self._adata is None or len(self.dot_color_df.index) <= 2:
            return None
        from .utils import dendrogram as _dend

        key = dendrogram_key or f"dendrogram_{self._cat_key}"
        if key not in self._adata.uns:
            _dend(self._adata, self._cat_key, var_names=list(self.dot_color_df.columns), key_added=key)
        order = [c for c in self._adata.uns[key]["categories_ordered"] if c in self.dot_color_df.index]
        self.dot_color_df = self.dot_color_df.loc[order]
        self.dot_size_df = self.dot_size_df.loc[order]
        if self.var_group_positions and self.var_group_labels:
            # var groups track gene columns; the category reorder leaves them
            # valid, but the reference also re-sorts category-keyed brackets —
            # only applicable when brackets label categories (swapped axes)
            if self.are_axes_swapped:
                idx = {c: i for i, c in enumerate(order)}
                pairs = sorted(
                    zip(self.var_group_positions, self.var_group_labels),
                    key=lambda pl: idx.get(str(pl[1]), len(order)),
                )
                self.var_group_positions = [p for p, _ in pairs]
                self.var_group_labels = [l for _, l in pairs]
        return key

    def add_dendrogram(self, show: bool = True, dendrogram_key: Optional[str] = None, size: float = 0.8):
        """Reorder categories by hierarchical clustering and render the
        dendrogram in a side panel sharing the category axis (parity:
        reference dotplot.py:522 `add_dendrogram` + the group_extra_ax in
        make_figure:1459-1483). A freshly computed dendrogram clusters the
        category means over the PLOTTED genes (matching the previous
        dotplot() behavior and the reference's var-subset clustering)."""
        if not show or self._adata is None or len(self.dot_color_df.index) <= 2:
            self._dendrogram = None
            return self
        key = self.reorder_categories_after_dendrogram(dendrogram_key)
        self._dendrogram = {"key": key, "size": size}
        return self

    def _size_norm(self, frac: np.ndarray) -> np.ndarray:
        dot_max = self._style["dot_max"] if self._style["dot_max"] is not None else max(float(np.nanmax(frac)), 1e-12)
        dot_min = self._style["dot_min"] or 0.0
        fr = np.clip(frac, dot_min, dot_max)
        fr = (fr - dot_min) / max(dot_max - dot_min, 1e-12)
        # relative dot areas follow fraction ** size_exponent (reference
        # style(size_exponent), dotplot.py:568)
        fr = fr ** float(self._style.get("size_exponent", 1.0))
        return self._style["smallest_dot"] + fr * (self._style["largest_dot"] - self._style["smallest_dot"])

    def make_figure(self, ax=None, dendrogram_adata=None, dendrogram_key=None):
        plt = _pyplot()

        color = self.dot_color_df
        size = self.dot_size_df.loc[color.index, color.columns]
        if self.are_axes_swapped:
            color, size = color.T, size.T
        ny, nx = color.shape
        if ax is None:
            figsize = self.figsize or (max(3.0, 0.35 * nx + 2.5), max(2.5, 0.3 * ny + 1.5))
            self.fig, ax = plt.subplots(figsize=figsize)
        else:
            self.fig = ax.figure
        self.ax = ax
        self.ax_dict = {"mainplot_ax": ax}
        yy, xx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        cvals = color.values.astype(float)
        svals = self._size_norm(size.values.astype(float))
        norm = check_colornorm(self.vmin, self.vmax, self.vcenter, self.norm)
        cmap = resolve_cmap(self._style["cmap"])
        if self._style.get("color_on") == "square":
            # colormap on a square region behind each dot; the dot itself is
            # transparent with only its edge drawn (reference color_on='square',
            # dotplot.py:568 style + _mainplot square path)
            _plt = _pyplot()

            mesh = ax.pcolormesh(
                np.arange(nx + 1) - 0.5, np.arange(ny + 1) - 0.5, cvals, cmap=cmap, norm=norm,
                edgecolors="white", linewidth=0.2,
            )
            sc = ax.scatter(
                xx.ravel(), yy.ravel(), s=svals.ravel(), facecolors="none",
                edgecolors=self._style["dot_edge_color"], linewidths=max(self._style["dot_edge_lw"], 0.4),
            )
            self._color_mappable = mesh
        else:
            sc = ax.scatter(
                xx.ravel(), yy.ravel(), s=svals.ravel(), c=cvals.ravel(),
                cmap=cmap, norm=norm,
                edgecolors=self._style["dot_edge_color"], linewidths=self._style["dot_edge_lw"],
            )
            self._color_mappable = sc
        ax.set_xticks(range(nx))
        ax.set_xticklabels(color.columns, rotation=90, fontsize=8)
        ax.set_yticks(range(ny))
        ax.set_yticklabels(color.index, fontsize=8)
        xpad = 0.6 * float(self._style.get("x_padding", 0.8)) / 0.8
        ypad = 0.6 * float(self._style.get("y_padding", 1.0)) / 1.0 if not self._style.get("color_on") == "square" else 0.5
        ax.set_xlim(-xpad, nx - 1 + xpad)
        ax.set_ylim(ny - 1 + ypad, -ypad)
        if self._style.get("grid"):
            ax.grid(True, color="lightgray", linewidth=0.5)
            ax.set_axisbelow(True)
        if self.title:
            ax.set_title(self.title)
        if self._legend["show"]:
            if self._legend["show_colorbar"]:
                cb = self.fig.colorbar(self._color_mappable, ax=ax, shrink=0.5, pad=0.02)
                cb.set_label(self._legend["colorbar_title"], fontsize=8)
            if self._legend["show_size_legend"]:
                handles = []
                n_dots = max(self._legend.get("num_size_legend_dots", 4), 2)
                for f in np.linspace(1.0 / n_dots, 1.0, n_dots):
                    s = self._style["smallest_dot"] + (f ** float(self._style.get("size_exponent", 1.0))) * (
                        self._style["largest_dot"] - self._style["smallest_dot"]
                    )
                    handles.append(plt.scatter([], [], s=s, c="grey", edgecolors="black", linewidths=0.2, label=f"{int(f*100)}"))
                ax.legend(handles=handles, title=self._legend["size_title"], loc="center left",
                          bbox_to_anchor=(1.25, 0.5), frameon=False, fontsize=7, title_fontsize=7)
        if self._dendrogram is not None and self._adata is not None:
            from mpl_toolkits.axes_grid1 import make_axes_locatable

            from .utils import plot_dendrogram

            divider = make_axes_locatable(ax)
            # dendrogram sits on the category axis: right of the plot
            # normally, on top when the axes are swapped (reference
            # dotplot.py:530 "or on top if the axes are swapped")
            if self.are_axes_swapped:
                dax = divider.append_axes("top", size=f"{int(self._dendrogram['size'] * 12)}%", pad=0.05)
                plot_dendrogram(dax, self._adata, self._cat_key, orientation="top", remove_labels=True)
            else:
                dax = divider.append_axes("right", size=f"{int(self._dendrogram['size'] * 12)}%", pad=0.05)
                plot_dendrogram(dax, self._adata, self._cat_key, orientation="right", remove_labels=True)
            self.ax_dict["group_extra_ax"] = dax
        if self.var_group_positions and not self.are_axes_swapped:
            self._plot_var_groups_brackets(ax)
        return self

    def _plot_var_groups_brackets(self, main_ax, left_adjustment: float = 0.2, right_adjustment: float = 0.7):
        """Brackets labeling groups of features above the main plot (parity:
        reference dotplot.py:1224 `_plot_var_groups_brackets` + the
        gene_groups_ax wiring in make_figure:1488). `var_group_positions`
        is a list of inclusive (start, end) column spans."""
        from mpl_toolkits.axes_grid1 import make_axes_locatable

        divider = make_axes_locatable(main_ax)
        gax = divider.append_axes("top", size="12%", pad=0.02, sharex=main_ax)
        labels = self.var_group_labels or ["" for _ in self.var_group_positions]
        for (start, end), label in zip(self.var_group_positions, labels):
            left = start - 0.5 + left_adjustment
            right = end - 0.5 + right_adjustment
            gax.plot([left, left, right, right], [0.0, 0.8, 0.8, 0.0], color="black", lw=1.0)
            rot = self.var_group_rotation if self.var_group_rotation is not None else (0 if len(str(label)) < 4 else 90)
            gax.text((left + right) / 2, 0.95, str(label), ha="center",
                     va="bottom", fontsize=7, rotation=rot)
        gax.set_ylim(0, 2.2)
        gax.set_axis_off()
        self.ax_dict["gene_group_ax"] = gax
        return gax


class CCDotplot(Dotplot):
    """Cell-cell communication dotplot: p-value-sized dots, significant
    entries ringed (parity: reference dotplot.py:1513)."""

    def __init__(self, delta=None, minn=None, alpha=None, sig_df=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.delta, self.minn, self.alpha = delta, minn, alpha
        self.sig_df = sig_df  # boolean mask of entries to ring (p <= alpha)
        self._legend["colorbar_title"] = "Log fold change"
        self._legend["size_title"] = r"Significance ($-\log_{10}(pval)$)"

    def make_figure(self, ax=None, **kwargs):
        super().make_figure(ax=ax, **kwargs)
        if self.sig_df is not None:
            sig = self.sig_df.loc[self.dot_color_df.index, self.dot_color_df.columns].values.astype(bool)
            if self.are_axes_swapped:
                sig = sig.T
            yy, xx = np.nonzero(sig)
            self.ax.scatter(xx, yy, s=self._style["largest_dot"] * 1.4, facecolors="none",
                            edgecolors="black", linewidths=1.0)
        return self


def dotplot(
    adata,
    var_names: Sequence[str],
    cat_key: Union[str, Sequence[str]],
    num_categories: int = 7,
    cell_cell_dp: bool = False,
    delta: Optional[float] = None,
    minn: Optional[float] = None,
    alpha: Optional[float] = None,
    prescale_adata: bool = False,
    expression_cutoff: float = 0.0,
    mean_only_expressed: bool = False,
    cmap: str = "Reds",
    color_on: str = "dot",
    size_exponent: float = 1.5,
    grid: bool = False,
    show_size_legend: bool = True,
    show_colorbar: bool = True,
    dot_max=None,
    dot_min=None,
    standard_scale: Optional[str] = None,
    smallest_dot: float = 0.0,
    largest_dot: float = 200.0,
    title: Optional[str] = None,
    colorbar_title: Optional[str] = None,
    size_title: Optional[str] = None,
    figsize: Optional[Tuple[float, float]] = None,
    dendrogram: Union[bool, str] = False,
    gene_symbols_key: Optional[str] = None,
    layer: Optional[str] = None,
    swap_axes: bool = False,
    dot_color_df: Optional[pd.DataFrame] = None,
    dot_size_df: Optional[pd.DataFrame] = None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    ax=None,
    vmin=None,
    vmax=None,
    vcenter=None,
    norm=None,
    **kwargs,
):
    """Dot plot of expression values: color = mean expression per group, size
    = fraction expressing (parity: reference dotplot.py:1628)."""
    cat_key = cat_key if isinstance(cat_key, str) else list(cat_key)[0]
    cls = CCDotplot if cell_cell_dp else Dotplot
    init_kwargs = dict(
        adata=adata, var_names=var_names, cat_key=cat_key, num_categories=num_categories,
        expression_cutoff=expression_cutoff, mean_only_expressed=mean_only_expressed,
        standard_scale=standard_scale, dot_color_df=dot_color_df, dot_size_df=dot_size_df,
        layer=layer, gene_symbols_key=gene_symbols_key, title=title, figsize=figsize,
        var_group_positions=kwargs.pop("var_group_positions", None),
        var_group_labels=kwargs.pop("var_group_labels", None),
        var_group_rotation=kwargs.pop("var_group_rotation", None),
    )
    if cell_cell_dp:
        init_kwargs.update(delta=delta, minn=minn, alpha=alpha)
    dp = cls(**init_kwargs)
    if swap_axes:
        dp.swap_axes()
    dp.vmin, dp.vmax, dp.vcenter, dp.norm = vmin, vmax, vcenter, norm
    dp.style(cmap=cmap, color_on=color_on, dot_max=dot_max, dot_min=dot_min,
             smallest_dot=smallest_dot, largest_dot=largest_dot,
             size_exponent=size_exponent, grid=grid)
    dp.legend(colorbar_title=colorbar_title, size_title=size_title,
              show_size_legend=show_size_legend, show_colorbar=show_colorbar)

    if dendrogram and adata is not None:
        dp.add_dendrogram(dendrogram_key=dendrogram if isinstance(dendrogram, str) else None)

    dp.make_figure(ax=ax)
    return save_return_show_fig_utils(save_show_or_return, True, None, "dotplot", save_kwargs, 1, dp.fig, dp.ax)


def make_grid_spec(ax_or_figsize, nrows: int, ncols: int, wspace=None, hspace=None, width_ratios=None, height_ratios=None):
    """Figure/axes -> GridSpec helper (parity: reference dotplot.py:209)."""
    from matplotlib import gridspec

    plt = _pyplot()

    kw = dict(wspace=wspace, hspace=hspace, width_ratios=width_ratios, height_ratios=height_ratios)
    if isinstance(ax_or_figsize, tuple):
        fig = plt.figure(figsize=ax_or_figsize)
        return fig, gridspec.GridSpec(nrows, ncols, **kw)
    ax = ax_or_figsize
    ax.axis("off")
    ax.set_frame_on(False)
    return ax.figure, ax.get_subplotspec().subgridspec(nrows, ncols, **kw)
