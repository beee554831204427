"""The port's 2-D plots (`spateo_tpu_torch.plotting`: agg, align, bbs,
contour, dotplot, geo, glm, interactions, interactive, lisa, networks,
polarity, scatters, space, `utils.plot_polygon`) against the JAX package's
on the CPU, under Agg: each case builds the same numpy inputs from a seed,
draws them through both packages' function with
``save_show_or_return="return"`` (where the function has it), and holds the
two figures equal in two ways: the rendered RGBA buffers, and the artists
(axes, the collections' offsets and colours, the lines' data, the images'
arrays, the texts and patches) to rtol 1e-6 (`tests/_figure_parity.py`).
What a function returns besides its figure (arrays, masks, frames, files
it writes) is held equal too. Every plot here is host code, so equal pixels
are expected; `glm_fit`/`glm_heatmap` smooth through `loess_1d`, which the
port computes bit for bit as the JAX package does.

`space_plot_axes` (and so `plot_cell_signaling(color=...)`) calls its own
string parameter `space` in both packages and raises `TypeError` there; the
case pins that the port raises as the JAX package does.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from _figure_parity import assert_close, assert_same_figure, figure_of  # noqa: E402

import spateo_tpu as st  # noqa: E402
import spateo_tpu.plotting as JP  # noqa: E402
import spateo_tpu_torch as stt  # noqa: E402
import spateo_tpu_torch.plotting as TP  # noqa: E402

SIDES = ((JP, st), (TP, stt))


def M(P, name):
    """A plotting module by name (the packages bind functions over some
    module names: `dotplot`, `geo`, `scatters`, `space`)."""
    import importlib

    return importlib.import_module(f"{P.__name__}.{name}")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch, and for numpy's BLAS and OpenMP: the
    tier-1 run shares the CPU among its workers, where those pools only
    contend."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _close():
    yield
    plt.close("all")


# -- inputs, the same numpy arrays in each package's AnnData ------------------------------------------------


def umi(S, n=120, g=5, seed=0):
    rng = np.random.default_rng(seed)
    a = S.AnnData(
        X=rng.poisson(2.0, (n, g)).astype(np.float32),
        obs=pd.DataFrame({"leiden": rng.choice(["a", "b", "c"], n), "score": rng.normal(size=n)},
                         index=[f"c{i}" for i in range(n)]),
        var=pd.DataFrame(index=[f"g{j}" for j in range(g)]),
    )
    a.obsm["spatial"] = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    a.obsm["spatial3d"] = rng.uniform(0, 10, (n, 3))
    S.SKM.init_adata_type(a, "UMI")
    return a


def agg(S, h=40, w=50, seed=0, spatial=False):
    rng = np.random.default_rng(seed)
    a = S.AnnData(X=rng.poisson(1.0, (h, w)).astype(np.float32),
                  obs=pd.DataFrame(index=[str(i + 10) for i in range(h)]),
                  var=pd.DataFrame(index=[str(j + 20) for j in range(w)]))
    S.SKM.init_adata_type(a, "AGG")
    bins = np.zeros((h, w), np.float32)
    bins[5:15, 5:20] = 1
    bins[20:35, 25:45] = 2
    a.layers["X_bins"] = bins
    a.uns["spatial"] = {"qc": np.array([[5, 15, 5, 20], [20, 35, 25, 45], [0, 10, 30, 40]])}
    if spatial:
        a.uns["spatial"].update({"binsize": 2, "scale": 0.5, "scale_unit": "um"})
    return a


def slices(S, k=3, n=80):
    out = []
    for i in range(k):
        a = umi(S, n=n, seed=i)
        a.obs["slices"] = f"s{i}"
        a.obsm["align_spatial"] = np.asarray(a.obsm["spatial"]) + i
        out.append(a)
    return out


def lisa_df():
    rng = np.random.default_rng(0)
    return pd.DataFrame({
        "x": rng.uniform(0, 10, 100), "y": rng.uniform(0, 10, 100),
        "exp_zscore": rng.normal(size=100), "w_exp_zscore": rng.normal(size=100),
        "Is": rng.normal(size=100),
        "labels": rng.choice(["Q1", "Q2", "Q3", "Q4"], 100),
        "sig": rng.choice([0, 1], 100),
        "group": rng.choice(["0 ns", "1 hot spot", "2 cold spot"], 100),
    })


def glm_adata(S):
    a = umi(S)
    rng = np.random.default_rng(3)
    xs = rng.uniform(0, 1, 60)
    corr = {g: pd.DataFrame({"torsion": xs, "expression": (j + 1) * xs ** 2 + rng.normal(0, 0.1, 60),
                             "curv": rng.normal(size=60)}) for j, g in enumerate(["g0", "g1", "g2"])}
    a.uns["glm_degs"] = {"glm_result": pd.DataFrame(index=["g0", "g1", "g2"]), "correlation": corr}
    return a


def cci_adata(S, k=6, seed=1):
    a = umi(S)
    rng = np.random.default_rng(seed)
    pairs = [f"L{i}-R{i}" for i in range(k)]
    cols = ["a|b", "b|c", "c|a"]
    a.uns["cci"] = {"means": pd.DataFrame(rng.uniform(0.1, 2.0, (k, 3)), index=pairs, columns=cols),
                    "pvalues": pd.DataFrame(rng.uniform(0, 0.3, (k, 3)), index=pairs, columns=cols)}
    return a


def polys(S):
    a = umi(S, n=40)
    rng = np.random.default_rng(5)
    base = np.array([[0, 0], [1.5, 0], [2, 1.2], [0.5, 2]], float)
    a.uns["cells"] = {n: base * rng.uniform(0.5, 1.5) + rng.uniform(0, 50, 2) for n in a.obs_names}
    return a


def graph(directed=False):
    import networkx as nx

    G = nx.DiGraph() if directed else nx.Graph()
    G.add_node("A", score=3.0)
    G.add_node("B", score=1.0)
    G.add_node("C", score=2.0)
    G.add_node("D", score=0.5)
    G.add_edge("A", "B", kind="act", weight=2.0)
    G.add_edge("B", "C", kind="inh", weight=1.0)
    G.add_edge("C", "D", kind="act", weight=0.5)
    G.add_edge("A", "C", kind="inh", weight=1.5)
    return G


def signaling(S, n=150):
    a = umi(S, n=n)
    V = np.random.default_rng(4).normal(size=(n, 2))
    V[::7] = 0
    a.obsm["vf"] = V
    return a


def frame_bytes(path):
    with open(path, "rb") as f:
        return f.read()


# -- the cases: each draws through one package (P its plotting package, S the package) -----------------------
# and returns (figure, what else to hold equal)


def _ret(out, extra=None):
    return figure_of(out), extra


CASES = {
    # agg
    "imshow": lambda P, S, d: _ret(P.imshow(agg(S), save_show_or_return="return")),
    "imshow_labels_scale_absolute": lambda P, S, d: _ret(P.imshow(
        agg(S, spatial=True), "X_bins", labels=True, absolute=True, show_cbar=True, save_show_or_return="return")),
    "imshow_downscale_cbar": lambda P, S, d: _ret(P.imshow(
        agg(S), downscale=0.5, show_cbar=True, use_scale=False, save_show_or_return="return")),
    "box_qc_regions": lambda P, S, d: _ret(P.box_qc_regions(agg(S, spatial=True), save_show_or_return="return")),
    "qc_regions": lambda P, S, d: _ret(P.qc_regions(agg(S), save_show_or_return="return")),
    # align
    "slices_2d_categories": lambda P, S, d: _ret(P.slices_2d(
        slices(S, 2), slices_key="slices", label_key="leiden", title="t", save_show_or_return="return")),
    "slices_2d_scalar_limits": lambda P, S, d: _ret(P.slices_2d(
        slices(S, 3), label_key="g0", sort_ascending=False, x_min=0, x_max=50, y_min=10, y_max=60,
        ticks_off=False, n_sampling=50, center_coordinate=True, ncols=2, save_show_or_return="return")),
    "slices_2d_palette": lambda P, S, d: _with_palette(P.slices_2d(
        umi(S), slices_key="leiden", label_key="leiden", return_palette=True, axis_off=True,
        save_show_or_return="return")),
    "overlay_slices_2d": lambda P, S, d: _ret(P.overlay_slices_2d(
        slices(S, 3), overlay_type="both", title="o", save_show_or_return="return")),
    "overlay_slices_2d_forward_labels": lambda P, S, d: _ret(P.overlay_slices_2d(
        slices(S, 3), label_key="leiden", overlay_type="forward", axis_off=True, save_show_or_return="return")),
    "overlay_slices_2d_scalar": lambda P, S, d: _ret(P.overlay_slices_2d(
        slices(S, 2), label_key="g1", n_sampling=40, x_min=0, x_max=80, save_show_or_return="return")),
    "multi_slices_gene": lambda P, S, d: _ret(P.multi_slices(
        slices(S, 3), label="g0", spatial_key="spatial", ncols=2, save_show_or_return="return")),
    "multi_slices_categories": lambda P, S, d: _ret(P.multi_slices(
        slices(S, 2), slices_key="slices", label="leiden", save_show_or_return="return")),
    "multi_slices_plain": lambda P, S, d: _ret(P.multi_slices(slices(S, 2), save_show_or_return="return")),
    "plot_deformation_grid": lambda P, S, d: _ret(P.plot_deformation_grid(
        slices(S, 1)[0], "align_spatial", "spatial", "leiden",
        predict_func=lambda x: x + 0.1 * np.sin(x), grid_num=5, title="grid")),
    "optimization_animation": lambda P, S, d: (None, frame_bytes(P.optimization_animation(
        [np.random.default_rng(i).uniform(0, 1, (30, 2)) for i in range(3)],
        np.random.default_rng(9).uniform(0, 1, (25, 2)), filename=str(d / "a.gif"), fps=5))),
    "align_helpers": lambda P, S, d: (None, _align_helpers(P)),
    # bbs, utils.plot_polygon
    "polygon_loop": lambda P, S, d: _ret(P.polygon(np.array([[0, 0], [3, 0], [4, 2], [1, 3.0]]), figsize=(3, 3),
                                                   save_show_or_return="return")),
    "polygon_edges": lambda P, S, d: _ret(P.polygon(
        (np.array([[0, 0], [3, 0], [4, 2], [1, 3.0]]), np.array([[0, 1], [1, 2], [2, 3], [3, 0]])), fill=True,
        figsize=(3, 3), save_show_or_return="return")),
    "delaunay": lambda P, S, d: _ret(P.delaunay(
        np.random.default_rng(1).uniform(0, 5, (12, 2, 2)), title="d", figsize=(3, 3),
        save_show_or_return="return")),
    "plot_polygon": lambda P, S, d: _ret(P.utils.plot_polygon(np.array([[0, 0], [3, 0], [4, 2], [1, 3.0]]))),
    # contour
    "spatial_domains": lambda P, S, d: _spatial_domains(P, S, d),
    # dotplot
    "dotplot": lambda P, S, d: _ret(P.dotplot(umi(S), var_names=["g0", "g1", "g2"], cat_key="leiden",
                                              save_show_or_return="return")),
    "dotplot_options": lambda P, S, d: _ret(P.dotplot(
        umi(S), var_names=["g0", "g1", "g2", "g3"], cat_key="leiden", dendrogram=True, color_on="square",
        standard_scale="var", size_exponent=2.0, smallest_dot=10.0, grid=True, title="dp",
        colorbar_title="mean", size_title="frac", mean_only_expressed=True, expression_cutoff=1.0,
        save_show_or_return="return")),
    "dotplot_swap_groups": lambda P, S, d: _ret(P.dotplot(
        umi(S), var_names=["g0", "g1", "g2"], cat_key="leiden", swap_axes=True, dendrogram=True,
        standard_scale="group", show_size_legend=False, vmin=0, vmax=3, save_show_or_return="return")),
    "dotplot_var_groups_numeric": lambda P, S, d: _ret(P.dotplot(
        umi(S), var_names=["g0", "g1", "g2"], cat_key="score", num_categories=3,
        var_group_positions=[(0, 1), (2, 2)], var_group_labels=["ab", "c"], show_colorbar=False,
        save_show_or_return="return")),
    "Dotplot_class": lambda P, S, d: _dotplot_class(P, S),
    "CCDotplot": lambda P, S, d: _ccdotplot(P),
    "adata_to_frame": lambda P, S, d: (None, _frame(M(P, "dotplot").adata_to_frame(umi(S), ["g1", "g0"], "score", 4))),
    "make_grid_spec": lambda P, S, d: _grid_spec(P),
    # geo
    "geo_fallback": lambda P, S, d: _ret(P.geo(umi(S, n=60), color="leiden", save_show_or_return="return")),
    "geo_polygons_genes": lambda P, S, d: _ret(P.geo(polys(S), basis="cells", genes=["g0", "g1"], cmap="magma",
                                                     figsize=(3, 3), save_show_or_return="return")),
    "space_polygons": lambda P, S, d: _ret(P.space_polygons(polys(S), basis="cells", color="leiden",
                                                            save_show_or_return="return")),
    "color_label": lambda P, S, d: _ret(P.color_label(polys(S), basis="cells", save_show_or_return="return")),
    "create_polygon_object_nanostring": lambda P, S, d: (None, M(P, "geo").create_polygon_object_nanostring(
        pd.DataFrame({"cellID": np.repeat([1, 2, 3], 4), "x_local_px": np.arange(12.0),
                      "y_local_px": np.arange(12.0)[::-1]}))),
    # glm (loess_1d: the same bits in both packages)
    "glm_fit": lambda P, S, d: _ret(P.glm_fit(glm_adata(S), feature_x="torsion", ncols=2,
                                              save_show_or_return="return")),
    "glm_fit_color_key": lambda P, S, d: _ret(P.glm_fit(glm_adata(S), genes="g1", feature_x="torsion",
                                                        color_key="curv", color_key_cmap="viridis",
                                                        remove_zero=True,
                                                        save_show_or_return="return")),
    "glm_heatmap": lambda P, S, d: _ret(P.glm_heatmap(glm_adata(S), feature_x="torsion", frac=0.3,
                                                      save_show_or_return="return")),
    "glm_heatmap_raw": lambda P, S, d: _ret(P.glm_heatmap(glm_adata(S), genes=["g2", "g0"], feature_x="torsion",
                                                          lowess_smooth=False, robust=False, colormap="viridis",
                                                          save_show_or_return="return")),
    # interactions
    "ligrec": lambda P, S, d: _ret(P.ligrec(cci_adata(S), "cci", alpha=0.05, save_show_or_return="return")),
    "ligrec_dendrogram_swap": lambda P, S, d: _ret(P.ligrec(
        cci_adata(S), "cci", dendrogram="both", swap_axes=True, source_groups=["a", "b", "c"],
        remove_nonsig_interactions=True, alpha=0.2, save_show_or_return="return")),
    "plot_connections": lambda P, S, d: _ret(P.plot_connections(
        umi(S), "leiden", n_spatial_neighbors=5, expr_weights_matrix=_weights(), save_show_or_return="return")),
    "plot_connections_heatmap": lambda P, S, d: _ret(P.plot_connections(
        umi(S), "leiden", n_spatial_neighbors=4, shapes_style=False, zero_self_connections=False,
        normalize_by_self_connections=True, title_str="t", save_show_or_return="return")),
    # interactive
    "contours": lambda P, S, d: _ret(P.contours(agg(S), "X_bins")),
    "select_polygon": lambda P, S, d: _select_polygon(P, S),
    "cellbin_select": lambda P, S, d: _cellbin_select(P, S),
    # lisa
    "lisa_quantiles": lambda P, S, d: _ret(P.lisa_quantiles(lisa_df())),
    "lisa": lambda P, S, d: _ret(list(P.lisa(lisa_df()))),
    # networks
    "PlotNetwork_traces": lambda P, S, d: _network_traces(P),
    "plot_network": lambda P, S, d: _ret(P.plot_network(
        graph(), title="t", layout="circular", edge_thickness_attr="weight", node_label="score",
        edge_label="kind", edge_text=["weight"], save_show_or_return="return")),
    "plot_network_digraph": lambda P, S, d: _ret(P.plot_network(
        graph(directed=True), title="d", layout="circular", color_method="score", size_method="static",
        transparent_background=True, save_show_or_return="return")),
    # polarity
    "polarity_exp": lambda P, S, d: _ret(P.polarity(_regions(umi(S)), {"anno": ["g0", "g1"]}, "region", mode="exp")),
    "polarity_density": lambda P, S, d: _ret(P.polarity(_regions(umi(S)), {"a": "g0", "b": ["g2"]}, "region")),
    # scatters
    "scatters_categories": lambda P, S, d: _ret(P.scatters(umi(S), basis="spatial", color="leiden",
                                                           save_show_or_return="return")),
    "scatters_genes_panels": lambda P, S, d: _ret(P.scatters(
        umi(S), basis="spatial", color=["g0", "score", "leiden"], ncols=2, sym_c=True, sort="abs",
        show_legend="upper left", save_show_or_return="return")),
    "scatters_highlights_theme": lambda P, S, d: _ret(P.scatters(
        umi(S), basis="spatial", color="leiden", highlights=["a"], theme="fire", save_show_or_return="return")),
    "scatters_smooth_frontier_contour": lambda P, S, d: _ret(P.scatters(
        umi(S), basis="spatial", color="g1", smooth=2, frontier=True, contour=True, theme="fire",
        show_arrowed_spines=True, despline_sides=["top"], save_show_or_return="return")),
    "scatters_values_labels": lambda P, S, d: _ret(P.scatters(
        umi(S), basis="spatial", labels=list(np.random.default_rng(1).choice(["u", "v"], 120)),
        color_key_cmap="tab10", save_show_or_return="return")),
    "scatters_values_affine": lambda P, S, d: _ret(P.scatters(
        umi(S), basis="spatial", values=list(np.random.default_rng(2).normal(size=120)),
        affine_transform_degree=30, affine_transform_b=np.array([1.0, 2.0]), aspect="equal",
        save_show_or_return="return")),
    "scatters_color_key": lambda P, S, d: _ret(P.scatters(
        umi(S), basis="spatial", color=["leiden", "g0"], color_key={"a": "red", "b": "green", "c": "blue"},
        save_show_or_return="return")),
    "scatters_aggregate": lambda P, S, d: _ret(P.scatters(umi(S), basis="spatial", color="g0", aggregate="leiden",
                                                          save_show_or_return="return")),
    "scatters_phase": lambda P, S, d: _ret(P.scatters(umi(S), basis="spatial", color="leiden", x="g0", y="score",
                                                      save_show_or_return="return")),
    "scatters_geo": lambda P, S, d: _ret(P.scatters(umi(S, n=60), basis="spatial", color="g0", geo=True,
                                                    save_show_or_return="return")),
    "scatters_vectors_image": lambda P, S, d: _ret(P.scatters(
        _with_image(umi(S)), basis="spatial", color="g1", slices=0, img_layers=0,
        V=np.random.default_rng(3).normal(size=(120, 2)), vf_plot_method="stream", save_show_or_return="return")),
    "scatters_3d": lambda P, S, d: _ret(P.scatters(umi(S), basis="spatial3d", color="g1", projection="3d",
                                                   save_show_or_return="return")),
    "scatters_stacked": lambda P, S, d: _ret(P.scatters(umi(S), basis="spatial", color=["g0", "g1", "g2"],
                                                        stack_colors=True, save_show_or_return="return")),
    "scatters_return_all": lambda P, S, d: _ret(P.scatters(umi(S), basis="spatial", color="g2", return_all=True)[1]),
    "plot_vectors": lambda P, S, d: _vectors(P),
    "position": lambda P, S, d: _ret(M(P, "scatters").position(_position(umi(S)), color="leiden",
                                                           save_show_or_return="return")),
    # space
    "space": lambda P, S, d: _ret(P.space(umi(S), color="leiden", save_show_or_return="return")),
    "space_genes": lambda P, S, d: _ret(P.space(umi(S), genes=["g0", "g1"], width=4, save_show_or_return="return")),
    "space_stack_genes": lambda P, S, d: _ret(P.space(umi(S), genes=["g0", "g1"], stack_genes=True,
                                                      save_show_or_return="return")),
    "plot_cell_signaling_cell": lambda P, S, d: _ret(P.plot_cell_signaling(signaling(S), "vf", plot_method="cell",
                                                                           save_show_or_return="return")),
    "plot_cell_signaling_grid": lambda P, S, d: _ret(P.plot_cell_signaling(
        signaling(S), "vf", plot_method="grid", grid_density=0.5, grid_knn=10, pointsize=3,
        save_show_or_return="return")),
    "plot_cell_signaling_stream": lambda P, S, d: _ret(P.plot_cell_signaling(
        signaling(S), "vf", plot_method="stream", grid_density=0.6, stream_density=0.8,
        save_show_or_return="return")),
}


def _with_palette(out):
    axes, palette = out
    return figure_of(axes), {k: np.asarray(v) for k, v in palette.items()}


def _align_helpers(P):
    A = P.align
    x = np.random.default_rng(0).uniform(0, 5, (10, 2))
    lo, hi = A.get_min_max(x)
    return [np.array([lo, hi]), A.transform_by_min_max(x, lo, hi), A.get_H(0.4, 0.3),
            A.transform_H(x, A.get_H(), z_shift=2.0)]


def _spatial_domains(P, S, d):
    a = umi(S)
    a.obs["cluster_img_label"] = a.obs["leiden"]
    img = P.spatial_domains(a, bin_size=10, save_img=str(d / "c.png"))
    return plt.gcf(), [img, frame_bytes(d / "c.png")]


def _dotplot_class(P, S):
    a = umi(S)
    dp = M(P, "dotplot").Dotplot(adata=a, var_names=["g0", "g1", "g2"], cat_key="leiden",
                           var_group_positions=[(0, 1), (2, 2)], var_group_labels=["ab", "c"])
    dp.style(cmap="viridis", largest_dot=150.0).legend(colorbar_title="m", num_size_legend_dots=3)
    dp.add_dendrogram(size=1.0)
    dp.make_figure()
    return dp.fig, sorted(dp.get_axes())


def _ccdotplot(P):
    rng = np.random.default_rng(2)
    idx, cols = ["L1-R1", "L2-R2", "L3-R3"], ["a | b", "b | c"]
    color = pd.DataFrame(rng.uniform(0, 2, (3, 2)), index=idx, columns=cols)
    size = pd.DataFrame(rng.uniform(0, 1, (3, 2)), index=idx, columns=cols)
    sig = size > 0.5
    dp = M(P, "dotplot").CCDotplot(delta=1.0, minn=0.0, alpha=0.05, sig_df=sig, dot_color_df=color, dot_size_df=size,
                             title="cc")
    dp.swap_axes()
    dp.make_figure()
    return dp.fig, None


def _frame(df):
    return {c: np.asarray(df[c]) for c in df.columns}


def _grid_spec(P):
    fig, gs = M(P, "dotplot").make_grid_spec((3, 2), 2, 3, wspace=0.1, width_ratios=[1, 2, 1])
    fig.add_subplot(gs[0, 1])
    _, ax = plt.subplots()
    fig2, sub = M(P, "dotplot").make_grid_spec(ax, 1, 2)
    return fig, [np.array(gs.get_geometry()), np.array(sub.get_geometry()), fig2 is ax.figure]


def _weights():
    from scipy import sparse

    return sparse.random(120, 120, density=0.05, random_state=0, format="csr")


def _select_polygon(P, S):
    a = agg(S)
    sel = P.select_polygon(a, "X")
    sel.onselect([(5, 5), (25, 5), (25, 20), (5, 20)])
    fig = sel.ax.figure
    mask = np.asarray(a.layers["X_selection"])
    return fig, mask


def _cellbin_select(P, S):
    a = umi(S, n=200)
    sel, cb = P.cellbin_select(a, binsize=10, return_all=True)
    return sel.ax.figure, [np.asarray(cb.X), np.asarray(cb.layers["spliced"]), dict(cb.uns["spatial"])]


def _network_traces(P):
    pn = M(P, "networks").PlotNetwork(graph(), layout="circular")
    node = pn.generate_node_traces("YlGnBu", "deg", "degree", node_label="score", node_text=["score"],
                                   node_label_size=8, node_label_position="top center", node_opacity=0.8,
                                   size_method="degree")
    node2 = pn.generate_node_traces("YlGnBu", "", "score", None, None, 8, "top center", 0.8, "static")
    edges, mid = pn.generate_edge_traces("kind", 8, "middle center", edge_text=["weight"],
                                         edge_attribute_for_thickness="weight", add_text=True)
    fig = pn.generate_figure(node, edges, mid, "net", 14, 2.0, transparent_background=True,
                             highlight_neighbors_on_hover=True)
    pos = pn.pos_dict["A"]
    hovered = pn.on_hover(dict(node, marker=dict(node["marker"])),
                          {"point_inds": [list(pn.pos_dict).index("A")], "xs": [pos[0]], "ys": [pos[1]]})
    restored = pn.on_unhover(hovered)
    return fig, [str(node), str(node2), str(edges), str(mid), str(hovered["marker"]["color"]),
                 str(restored["marker"]["color"]), sorted(pn.pos)]


def _regions(a):
    a.obs["region"] = np.random.default_rng(0).integers(0, 5, a.n_obs)
    return a


def _with_image(a):
    img = np.random.default_rng(6).uniform(0, 1, (50, 40))
    a.uns["spatial"] = {0: {"images": {0: img}, "scalefactors": {0: 0.5}}}
    return a


def _vectors(P):
    rng = np.random.default_rng(7)
    X, V = rng.uniform(0, 10, (80, 2)), rng.normal(size=(80, 2))
    fig, axes = plt.subplots(1, 3)
    P.plot_vectors(axes[0], X, V, method="cell")
    P.plot_vectors(axes[1], X, V, method="grid", color="red", scale=5.0)
    P.plot_vectors(axes[2], X, V, method="stream", density=0.5)
    return fig, None


def _position(a):
    a.obsm["X_position"] = np.asarray(a.obsm["spatial"]) * 2
    return a


@pytest.mark.parametrize("case", sorted(CASES))
def test_plot_matches_jax(case, tmp_path):
    """One case: the JAX package's figure and the port's, equal pixels and
    artists within rtol 1e-6, and whatever else the call returns equal."""
    out = []
    for i, (P, S) in enumerate(SIDES):
        d = tmp_path / str(i)
        d.mkdir()
        out.append(CASES[case](P, S, d))
    (fj, xj), (ft, xt) = out
    if fj is not None:
        assert ft is not fj
        assert_same_figure(fj, ft)
    assert_close(xj, xt)


def test_every_public_plot_has_a_case():
    """Every public function and class of the 2-D plotting modules is drawn
    by a case of `test_plot_matches_jax` (or, for `space_plot_axes`, by
    `test_space_plot_axes_raises_as_jax_does`)."""
    import ast
    import importlib
    import inspect
    import sys

    covered = inspect.getsource(sys.modules[__name__])
    for mod in ("agg", "align", "bbs", "contour", "dotplot", "geo", "glm", "interactions", "interactive.agg",
                "lisa", "networks", "polarity", "scatters", "space"):
        src = inspect.getsource(importlib.import_module("spateo_tpu.plotting." + mod))
        for node in ast.parse(src).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
                assert f"{node.name}(" in covered, (mod, node.name)


def test_space_plot_axes_raises_as_jax_does():
    """`space_plot_axes` calls its parameter `space` (a string) in both
    packages, so it, and `plot_cell_signaling(color=...)`, raise `TypeError`
    in both."""
    for P, S in SIDES:
        with pytest.raises(TypeError, match="not callable"):
            M(P, "space").space_plot_axes(umi(S), "leiden", "spatial", 6, None, 100, 0.8, None)
        with pytest.raises(TypeError, match="not callable"):
            P.plot_cell_signaling(signaling(S), "vf", color="leiden", save_show_or_return="return")


def test_plotting_modules_load_without_matplotlib_and_plots_ask_for_it():
    """In a fresh interpreter where `matplotlib` cannot be imported,
    `spateo_tpu_torch.plotting` and every submodule load, and a plot raises
    `ModuleNotFoundError` naming matplotlib."""
    import subprocess
    import sys

    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['matplotlib'] = None\n"
        "import numpy as np\n"
        "import spateo_tpu_torch as stt\n"
        "import spateo_tpu_torch.plotting as P\n"
        "for m in pkgutil.walk_packages(P.__path__, 'spateo_tpu_torch.plotting.'):\n"
        "    importlib.import_module(m.name)\n"
        "a = stt.AnnData(X=np.ones((5, 2), np.float32))\n"
        "a.obsm['spatial'] = np.random.default_rng(0).uniform(size=(5, 2))\n"
        "try:\n"
        "    P.scatters(a, basis='spatial', color='0')\n"
        "except ModuleNotFoundError as e:\n"
        "    print('RAISED', e.name)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "RAISED matplotlib" in proc.stdout, proc.stdout[-2000:]


def test_scatters_registers_the_named_colormaps_itself():
    """In a fresh interpreter with no JAX package loaded, a theme that names
    one of the port's colormaps draws with it: `scatters` registers them."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import matplotlib\n"
        "matplotlib.use('Agg')\n"
        "import numpy as np\n"
        "import spateo_tpu_torch as stt\n"
        "a = stt.AnnData(X=np.arange(12, dtype=np.float32).reshape(6, 2))\n"
        "a.obsm['spatial'] = np.random.default_rng(0).uniform(size=(6, 2))\n"
        "ax = stt.pl.scatters(a, basis='spatial', color='0', theme='fire', save_show_or_return='return')\n"
        "print('CMAP', ax.collections[0].get_cmap().name, 'spateo_tpu' in sys.modules)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "CMAP fire False" in proc.stdout, proc.stdout[-2000:]
