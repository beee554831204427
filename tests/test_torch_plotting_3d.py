"""The port's 3-D plots (`spateo_tpu_torch.plotting.three_d_plot`:
`three_dims_plots`, `align_plots`, `backbone_plots`, `morphometrics_plots`,
`pairwise_align_plots`) against the JAX package's on the CPU, under Agg,
on the same models and AnnData built from a seed: equal rendered RGBA
buffers and artists within rtol 1e-6 (`tests/_figure_parity.py`); the files
the HTML writers and the animations write, equal byte for byte; what the
functions return besides, equal.

One named case computes on the device and differs by rounding:
`pairwise_exp_similarity` draws exp(-d / (2 beta2)) of the port's
`calc_distance` (one float32 GEMM in another blocking than XLA's). Its
distances are held to `calc_distance`'s own bar against the JAX package,
5e-5 of scale (`test_torch_morpho.py`), and every other artist of its
panels to rtol 1e-6, without pixel equality.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from _figure_parity import artists, assert_close, assert_same_figure  # noqa: E402

import spateo_tpu as st  # noqa: E402
import spateo_tpu.plotting as JP  # noqa: E402
import spateo_tpu_torch as stt  # noqa: E402
import spateo_tpu_torch.plotting as TP  # noqa: E402
from spateo_tpu.tdr.models import mesh_core as JMC  # noqa: E402
from spateo_tpu_torch.tdr.models import mesh_core as TMC  # noqa: E402

SIDES = ((JP, st, JMC), (TP, stt, TMC))
#: `calc_distance` against the JAX package (tests/test_torch_morpho.py)
DIST_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch, and for numpy's BLAS and OpenMP."""
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


def M(P, name):
    import importlib

    return importlib.import_module(f"{P.__name__}.three_d_plot.{name}")


# -- inputs ---------------------------------------------------------------------------------------------------


def cloud(MC, n=150, seed=0):
    pts = np.random.default_rng(seed).uniform(-1, 1, (n, 3))
    return MC.PointCloud(pts, {"val": pts[:, 0].copy(), "groups": np.where(pts[:, 1] > 0, "up", "down")})


def ellipsoid(MC, n=80, seed=0):
    from scipy.spatial import ConvexHull

    u = np.random.default_rng(seed).normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = u * np.array([1.0, 0.7, 0.5])
    return MC.Mesh(pts, ConvexHull(pts).simplices.copy(), {"h": pts[:, 2].copy()})


def grid_mesh(MC, k=5, shift=0.0):
    xs, ys = np.meshgrid(np.linspace(0, 1, k), np.linspace(0, 1, k))
    pts = np.c_[xs.ravel(), ys.ravel() + shift * np.sin(3 * xs.ravel()), np.zeros(k * k)]
    faces = []
    for i in range(k - 1):
        for j in range(k - 1):
            a = i * k + j
            faces += [[a, a + 1, a + k], [a + 1, a + k + 1, a + k]]
    return MC.Mesh(pts, np.asarray(faces), {"deformation": np.linalg.norm(pts[:, :2], axis=1)})


def adata3d(S):
    rng = np.random.default_rng(3)
    n = 120
    X = np.zeros((n, 3), dtype=np.float32)
    X[:40, 0] = rng.poisson(3.0, 40) + 1
    X[30:70, 1] = rng.poisson(3.0, 40) + 1
    a = S.AnnData(X=X, obs=pd.DataFrame({"celltype": ["A"] * 60 + ["B"] * 40 + ["C"] * 20,
                                         "depth": rng.uniform(0, 5, n)}, index=[f"c{i}" for i in range(n)]),
                  var=pd.DataFrame(index=["g0", "g1", "g2"]))
    a.obsm["spatial"] = rng.uniform(0, 10, (n, 3))
    S.SKM.init_adata_type(a, "UMI")
    return a


def slices(S, k=3, n=50):
    rng = np.random.default_rng(5)
    out = []
    for i in range(k):
        a = S.AnnData(X=rng.poisson(2.0, (n, 2)).astype(np.float32),
                      obs=pd.DataFrame({"slices": [f"s{i}"] * n, "leiden": rng.choice(["x", "y"], n)},
                                       index=[f"c{i}_{j}" for j in range(n)]),
                      var=pd.DataFrame(index=["g0", "g1"]))
        S.SKM.init_adata_type(a, "UMI")
        a.obsm["align_spatial"] = rng.uniform(0, 1, (n, 2))
        out.append(a)
    return out


def morpho_adata(S, n=60):
    rng = np.random.default_rng(7)
    a = S.AnnData(X=np.ones((n, 2), dtype=np.float32), obs=pd.DataFrame(index=[f"cell{i}" for i in range(n)]))
    S.SKM.init_adata_type(a, "UMI")
    a.obsm["spatial"] = rng.uniform(0, 1, (n, 3))
    for k in ("torsion", "acceleration", "curvature", "curl", "divergence", "feat"):
        a.obs[k] = rng.normal(size=n)
    a.uns["jacobian"] = rng.normal(size=(3, 3, n))
    return a


def pair(S, nA=30, nB=25):
    rng = np.random.default_rng(0)
    a = S.AnnData(X=rng.poisson(2.0, (nA, 4)).astype(np.float32),
                  obs=pd.DataFrame({"t": rng.choice(["u", "v"], nA)}, index=[f"a{i}" for i in range(nA)]),
                  var=pd.DataFrame(index=[f"g{j}" for j in range(4)]))
    b = S.AnnData(X=rng.poisson(2.0, (nB, 4)).astype(np.float32),
                  obs=pd.DataFrame({"t": rng.choice(["u", "v"], nB)}, index=[f"b{i}" for i in range(nB)]),
                  var=pd.DataFrame(index=[f"g{j}" for j in range(4)]))
    for x in (a, b):
        S.SKM.init_adata_type(x, "UMI")
        x.obsm["align_spatial"] = rng.uniform(0, 1, (x.n_obs, 2))
        x.obsm["spatial"] = x.obsm["align_spatial"] * 10
    a.uns["iter_spatial"] = {"spatial": {i: np.asarray(a.obsm["align_spatial"]) + 0.05 * i for i in range(5)},
                             "sigma2": {i: 1.0 / (i + 1) for i in range(5)}}
    return a, b, rng.uniform(0, 1, (nA, nB))


def backbone_model(MC):
    t = np.linspace(0, 1, 8)
    bb = MC.PointCloud(np.c_[t, np.sin(3 * t) * 0.2, t ** 2 * 0.3], {"nodes": np.arange(8)})
    bb.edges = np.array([[i, i + 1] for i in range(7)])
    return bb


def file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _fig(out):
    return out, None


CASES = {
    # three_dims_plots
    "three_d_plot_points": lambda P, S, MC, d: _fig(P.three_d_plot(cloud(MC), key="val", model_style="points",
                                                                   text="pc", window_size=(300, 300))),
    "three_d_plot_categories_outline": lambda P, S, MC, d: _fig(P.three_d_plot(
        cloud(MC), key="groups", model_style="points", show_outline=True, cpo="xz", window_size=(300, 300))),
    "three_d_plot_surface_stack": lambda P, S, MC, d: _fig(P.three_d_plot(
        [ellipsoid(MC), cloud(MC)], key=["h", "val"], model_style=["surface", "points"], opacity=[0.5, 1.0],
        colormap=["viridis", "rainbow"], cpo="xy", window_size=(300, 300))),
    "three_d_plot_wireframe_file": lambda P, S, MC, d: (
        None, file_bytes(P.three_d_plot(ellipsoid(MC), key="h", model_style="wireframe", cpo="yz",
                                        filename=str(d / "w.png"), window_size=(300, 300)))),
    "three_d_multi_plot": lambda P, S, MC, d: _fig(P.three_d_multi_plot(
        [cloud(MC, seed=i) for i in range(3)], key="val", text=["a", "b", "c"], window_size=(300, 300))),
    "three_d_multi_plot_shapes": lambda P, S, MC, d: _fig(P.three_d_multi_plot(
        [cloud(MC, seed=i) for i in range(4)], key="groups", shape="3|1", model_size=[2, 3, 4, 5],
        window_size=(300, 300))),
    "three_d_multi_plot_rows": lambda P, S, MC, d: _fig(P.three_d_multi_plot(
        [cloud(MC, seed=i) for i in range(3)], shape="1/2", show_legend=False, window_size=(300, 300))),
    "three_d_multi_plot_grid": lambda P, S, MC, d: _fig(P.three_d_multi_plot(
        [ellipsoid(MC), cloud(MC)], key=["h", "val"], shape=(1, 3), opacity=[0.4, 1.0], window_size=(300, 300))),
    "three_d_animate": lambda P, S, MC, d: (None, file_bytes(M(P, "three_dims_plots").three_d_animate(
        [cloud(MC, n=40, seed=i) for i in range(3)], stable_model=ellipsoid(MC, 30),
        stable_kwargs={"opacity": 0.3}, key="val", filename=str(d / "a.gif"), framerate=5,
        window_size=(200, 200)))),
    "merge_animations": lambda P, S, MC, d: (None, file_bytes(_merge(P, MC, d))),
    "wrap_to_plotter": lambda P, S, MC, d: _wrap(P, MC),
    "quick_plot_3D_celltypes": lambda P, S, MC, d: (None, [
        M(P, "three_dims_plots").quick_plot_3D_celltypes(adata3d(S), str(d / "ct.html"), group_key="celltype",
                                                          ct_subset=["A"], opacity=0.4),
        file_bytes(d / "ct.html")]),
    "quick_plot_3D_celltypes_all": lambda P, S, MC, d: (None, [
        M(P, "three_dims_plots").quick_plot_3D_celltypes(adata3d(S), str(d / "ct.png"), group_key="celltype",
                                                          title="t"),
        file_bytes(d / "ct.png")]),
    "plot_expression_3D": lambda P, S, MC, d: (None, [
        M(P, "three_dims_plots").plot_expression_3D(adata3d(S), str(d / "e.html"), "g0", pcutoff=90.0,
                                                     zero_opacity=0.3),
        file_bytes(d / "e.html")]),
    "plot_expression_3D_subset": lambda P, S, MC, d: (None, [
        M(P, "three_dims_plots").plot_expression_3D(adata3d(S), str(d / "e.png"), "g1", group_key="celltype",
                                                     ct_subset=["A", "B"]),
        file_bytes(d / "e.png")]),
    "plot_multiple_genes_3D": lambda P, S, MC, d: _multiple_genes(P, S, d),
    "visualize_3D_increasing_direction_gradient": lambda P, S, MC, d: (None, [
        M(P, "three_dims_plots").visualize_3D_increasing_direction_gradient(
            adata3d(S), str(d / "g.html"), coord_column=2, center=0.3, title="z"),
        file_bytes(d / "g.html")]),
    "visualize_3D_gradient_obs": lambda P, S, MC, d: (None, [
        M(P, "three_dims_plots").visualize_3D_increasing_direction_gradient(
            adata3d(S), str(d / "g.png"), color_key="depth", cmap="magma", opacity=0.5),
        file_bytes(d / "g.png")]),
    # align_plots
    "multi_models_single": lambda P, S, MC, d: _fig(P.multi_models(slices(S), mode="single",
                                                                   window_size=(300, 300))),
    "multi_models_overlap": lambda P, S, MC, d: _fig(P.multi_models(*slices(S), mode="overlap", cpo="xz",
                                                                    window_size=(300, 300))),
    "multi_models_both_groups": lambda P, S, MC, d: _fig(P.multi_models(
        slices(S, 2), mode="both", group_key="leiden", colormap="tab10", text="t", center_zero=True,
        window_size=(300, 300))),
    "multi_models_gene": lambda P, S, MC, d: _fig(P.multi_models(
        slices(S, 2), group_key="g1", colormap="viridis", shape=(1, 2), cpo="yz", show_legend=False,
        window_size=(300, 300))),
    "deformation": lambda P, S, MC, d: _fig(P.deformation(
        slices(S, 2), deformed_grid=[grid_mesh(MC), grid_mesh(MC, shift=0.1)], colormap="viridis",
        group_key="leiden", model_color="tab10", window_size=(300, 300))),
    "deformation_color": lambda P, S, MC, d: _fig(P.deformation(
        slices(S, 1)[0], deformed_grid=grid_mesh(MC, shift=0.2), show_model=False, text="d",
        window_size=(300, 300))),
    # backbone_plots
    "backbone": lambda P, S, MC, d: _fig(P.backbone(backbone_model(MC), bg_model=cloud(MC), bg_key="val",
                                                    window_size=(300, 300))),
    "backbone_file": lambda P, S, MC, d: (None, file_bytes(P.backbone(
        backbone_model(MC), nodes_key=None, filename=str(d / "b.png"), window_size=(300, 300)))),
    # morphometrics_plots
    "jacobian": lambda P, S, MC, d: _fig(P.jacobian(morpho_adata(S), _pc(MC, morpho_adata(S)), model_style="points",
                                                    window_size=(300, 300))),
    "feature": lambda P, S, MC, d: _fig(M(P, "morphometrics_plots").feature(
        morpho_adata(S), _pc(MC, morpho_adata(S)), "feat", colormap="magma", window_size=(300, 300))),
    "feature_models_by_obs_index": lambda P, S, MC, d: _fig(M(P, "morphometrics_plots").feature(
        morpho_adata(S), [_pc(MC, morpho_adata(S), [5, 3, 30, 12]), _pc(MC, morpho_adata(S), [1, 2, 9])], "feat",
        window_size=(300, 300))),
    "torsion": lambda P, S, MC, d: _fig(P.torsion(morpho_adata(S), _pc(MC, morpho_adata(S)),
                                                  window_size=(300, 300))),
    "acceleration": lambda P, S, MC, d: _fig(P.acceleration(morpho_adata(S), _pc(MC, morpho_adata(S)),
                                                            window_size=(300, 300))),
    "curvature": lambda P, S, MC, d: _fig(P.curvature(morpho_adata(S), _pc(MC, morpho_adata(S)),
                                                      window_size=(300, 300))),
    "curl": lambda P, S, MC, d: _fig(P.curl(morpho_adata(S), _pc(MC, morpho_adata(S)), window_size=(300, 300))),
    "divergence": lambda P, S, MC, d: _fig(P.divergence(morpho_adata(S), _pc(MC, morpho_adata(S)),
                                                        model_style="points", window_size=(300, 300))),
    # pairwise_align_plots
    "pi_heatmap": lambda P, S, MC, d: _fig(P.pi_heatmap(pair(S)[2], save_show_or_return="return").figure),
    "pi_heatmap_robust_file": lambda P, S, MC, d: (None, [_close_fig(P.pi_heatmap(
        pair(S)[2], robust=True, model1_name="A", model2_name="B", filename=str(d / "pi.png"),
        save_show_or_return="return")), file_bytes(d / "pi.png")]),
    "pairwise_mapping": lambda P, S, MC, d: _mapping(P, S, group_key=None),
    "pairwise_mapping_groups": lambda P, S, MC, d: _mapping(P, S, group_key="t", keep_all=True, direction="x"),
    "pairwise_mapping_gene": lambda P, S, MC, d: _mapping(P, S, group_key="g2", distance=None),
    "pairwise_iteration": lambda P, S, MC, d: (None, file_bytes(P.pairwise_iteration(
        *pair(S)[:2], filename=str(d / "it.gif"), fps=5))),
    "pairwise_iteration_panel": lambda P, S, MC, d: _fig(P.pairwise_iteration_panel(
        *pair(S)[:2], ncols=3, save_show_or_return="return")[0].figure),
}


def _pc(MC, a, rows=None):
    pts = np.asarray(a.obsm["spatial"])
    if rows is None:
        return MC.PointCloud(pts.copy())
    pc = MC.PointCloud(pts[rows].copy())
    pc.point_data["obs_index"] = np.asarray(a.obs.index)[rows]
    return pc


def _merge(P, MC, d):
    mod = M(P, "three_dims_plots")
    gifs = [mod.three_d_animate([cloud(MC, n=30, seed=i + k) for i in range(2)], key="val",
                                filename=str(d / f"m{k}.gif"), framerate=4, window_size=(160, 160))
            for k in range(2)]
    return mod.merge_animations(gif_files=gifs, filename=str(d / "merged.gif"))


def _wrap(P, MC):
    from importlib import import_module

    plotter = import_module(f"{P.__name__}.three_d_plot.three_dims_plotter")
    fig, axes = plotter.create_plotter(window_size=(300, 300))
    M(P, "three_dims_plots").wrap_to_plotter(axes[0, 0], cloud(MC), key="val", model_style="points")
    return fig, None


def _multiple_genes(P, S, d):
    a = adata3d(S)
    cats = M(P, "three_dims_plots").plot_multiple_genes_3D(a, ["g0", "g1"], str(d / "m.html"))
    b = adata3d(S)
    M(P, "three_dims_plots").plot_multiple_genes_3D(b, ["g0", "g1"], str(d / "s.png"), group_key="celltype",
                                                     ct_subset=["A"], colors=["red", "blue"])
    return None, [np.asarray(cats), {c: np.asarray(a.obs[c]).astype(str) for c in a.obs.columns},
                  file_bytes(d / "m.html"), file_bytes(d / "s.png")]


def _close_fig(ax):
    plt.close(ax.figure)
    return None


def _mapping(P, S, **kw):
    a, b, pi = pair(S)
    fig, mapping = P.pairwise_mapping(adataA=a, adataB=b, pi=pi, **kw)
    return fig, {c: np.asarray(mapping[c]) for c in mapping.columns}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plot_matches_jax(case, tmp_path):
    """One case: the JAX package's figure and the port's, equal pixels and
    artists within rtol 1e-6; files and returned values equal."""
    out = []
    for i, (P, S, MC) in enumerate(SIDES):
        d = tmp_path / str(i)
        d.mkdir()
        out.append(CASES[case](P, S, MC, d))
    (fj, xj), (ft, xt) = out
    if fj is not None:
        assert ft is not fj
        assert_same_figure(fj, ft)
    assert_close(xj, xt)


@pytest.mark.parametrize("dissimilarity", ["both", "euc", "kl"])
def test_pairwise_exp_similarity_matches_jax(dissimilarity):
    """Named case (compute that differs by rounding): the distances behind
    each panel, recovered from the drawn similarities, within DIST_TOL of
    scale of the JAX package's; every other artist within rtol 1e-6."""
    figs = []
    for P, S, _ in SIDES:
        a, b, _ = pair(S)
        kw = {"device": "cpu"} if P is TP else {}
        figs.append(M(P, "pairwise_align_plots").pairwise_exp_similarity(
            a, b, cells=[0, "a3"], dissimilarity=dissimilarity, beta2=5.0, **kw))
    fj, ft = figs
    for f in figs:
        f.canvas.draw()
    aj, at = artists(fj), artists(ft)
    n = 0
    for axj, axt in zip(aj["axes"], at["axes"]):
        if not axj["title"][1].startswith("cell "):  # a colorbar: its limits follow the similarities' range
            assert axj["type"] == axt["type"]
            assert_close(axj["ylim"], axt["ylim"], DIST_TOL)
            continue
        sj, stt_ = axj["collections"][0].pop("array"), axt["collections"][0].pop("array")
        # the facecolours are the colormap of the similarities; compare the distances instead
        for k in ("facecolors",):
            axj["collections"][0].pop(k), axt["collections"][0].pop(k)
        dj, dt = -2 * 5.0 * np.log(sj), -2 * 5.0 * np.log(stt_)
        assert np.abs(dt - dj).max() <= DIST_TOL * np.abs(dj).max()
        assert_close(axj, axt)
        n += 1
    assert n == 2 * (2 if dissimilarity == "both" else 1)


def test_every_public_3d_plot_has_a_case():
    """Every public function of the 3-D plotting modules but the renderer's
    (`three_dims_plotter`, held in `test_torch_widgets.py`) is drawn by a
    case here."""
    import ast
    import importlib
    import inspect
    import sys

    covered = inspect.getsource(sys.modules[__name__])
    for mod in ("three_dims_plots", "align_plots", "backbone_plots", "morphometrics_plots",
                "pairwise_align_plots"):
        src = inspect.getsource(importlib.import_module("spateo_tpu.plotting.three_d_plot." + mod))
        for node in ast.parse(src).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
                assert f"{node.name}(" in covered, (mod, node.name)
