"""The port's model-editing widgets (`stt.tdr`'s clip, pick and slice,
`spateo_tpu_torch.tdr.widgets`), its 3D renderer and plotting helpers
(`plotting.three_d_plot.three_dims_plotter`, `plotting.utils`), against the
JAX package on the CPU, on the same models.

Bars: every mask, index set and point array equal. `points_inside_mesh`
(float64 on the device, in [point-chunk, faces] blocks) against the JAX
package's numpy on points at least 1e-6 from every face's plane: equal
masks; so the overlap picks built on it give equal models. The rectangle,
lasso and slider loops, driven headless, keep the same points; the
renderer's collections hold the same geometry.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import spateo_tpu as st  # noqa: E402
import spateo_tpu_torch as stt  # noqa: E402
from spateo_tpu.tdr.models import mesh_core as JMC  # noqa: E402
from spateo_tpu.tdr.widgets import interactive as JI  # noqa: E402
from spateo_tpu.tdr.widgets import ops as JO  # noqa: E402
from spateo_tpu_torch.tdr.models import mesh_core as TMC  # noqa: E402
from spateo_tpu_torch.tdr.widgets import interactive as TI  # noqa: E402
from spateo_tpu_torch.tdr.widgets import ops as TO  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch, and for numpy's BLAS and OpenMP."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)
    plt.close("all")


def _same(a, b):
    """Two packages' models (or lists/tuples of them) hold equal points and
    point data."""
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if a is None or isinstance(a, np.ndarray):
        assert (a is None and b is None) or np.array_equal(a, b)
        return
    assert np.array_equal(np.asarray(a.points), np.asarray(b.points))
    assert sorted(a.point_data) == sorted(b.point_data)
    for k in a.point_data:
        assert np.array_equal(np.asarray(a.point_data[k]), np.asarray(b.point_data[k]))
    if hasattr(a, "faces"):
        assert np.array_equal(np.asarray(a.faces), np.asarray(b.faces))


def _cloud(n=400, seed=0):
    pts = np.random.default_rng(seed).uniform(-1, 1, (n, 3))
    data = {"val": pts[:, 0], "groups": np.where(pts[:, 0] > 0, "right", "left")}
    return JMC.PointCloud(pts, dict(data)), TMC.PointCloud(pts.copy(), dict(data))


def _cube(mc, center, half):
    c = np.asarray(center, float)
    v = np.array([[x, y, z] for x in (-half, half) for y in (-half, half) for z in (-half, half)]) + c
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    return mc.Mesh(v, f)


def _ellipsoid(mc, n=300, axes=(1.0, 0.7, 0.5), seed=0):
    """A closed triangle surface: the convex hull of points on an ellipsoid."""
    from scipy.spatial import ConvexHull

    u = np.random.default_rng(seed).normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = u * np.asarray(axes)
    hull = ConvexHull(pts)
    return mc.Mesh(pts, hull.simplices.copy())


def _off_faces(points, mesh, eps=1e-6):
    """The points at least `eps` from every face's plane."""
    tri = np.asarray(mesh.points, float)[np.asarray(mesh.faces)]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = np.abs(np.einsum("pfj,fj->pf", points[:, None, :] - tri[None, :, 0], n))
    return points[d.min(1) >= eps]


@pytest.mark.parametrize("shape", ["cube", "ellipsoid"])
@pytest.mark.parametrize("elems", [None, 5_000])
def test_points_inside_mesh_matches_jax(shape, elems, monkeypatch):
    if elems is not None:
        monkeypatch.setattr(TO, "PIM_ELEMS", elems)  # many blocks
    make = (lambda mc: _cube(mc, (0.1, 0, 0), 0.8)) if shape == "cube" else _ellipsoid
    mj, mt = make(JMC), make(TMC)
    pts = _off_faces(np.random.default_rng(1).uniform(-1.2, 1.2, (3000, 3)), mj)
    a = JO.points_inside_mesh(pts, mj)
    b = TO.points_inside_mesh(pts, mt, device="cpu")
    assert b.dtype == bool and a.any() and (~a).any()
    assert np.array_equal(a, b)


def test_overlap_picks_match_jax():
    cj, ct = _cube(JMC, (0, 0, 0), 1.0), _cube(TMC, (0, 0, 0), 1.0)
    pts = _off_faces(np.random.default_rng(0).uniform(-2, 2, (500, 3)), cj)
    pj, pt = JMC.PointCloud(pts, {"i": np.arange(len(pts))}), TMC.PointCloud(pts.copy(), {"i": np.arange(len(pts))})
    _same(JO.overlap_pc_pick(pj, cj), TO.overlap_pc_pick(pt, ct, device="cpu"))
    ej, et = _ellipsoid(JMC), _ellipsoid(TMC)
    _same(JO.overlap_mesh_pick(cj, ej), TO.overlap_mesh_pick(ct, et, device="cpu"))
    sj, pj2 = JO.overlap_pick(cj, ej, main_pc=pj)
    stt_, pt2 = TO.overlap_pick(ct, et, main_pc=pt, device="cpu")
    _same(sj, stt_)
    _same(pj2, pt2)
    assert TO.overlap_pick(ct, et, device="cpu")[1] is None


def test_clip_slice_pick_match_jax():
    pj, pt = _cloud()
    _same(JO.clip_models(pj, plane_origin=[0, 0, 0], plane_normal=[1, 0, 0]),
          TO.clip_models(pt, plane_origin=[0, 0, 0], plane_normal=[1, 0, 0]))
    _same(JO.clip_models(pj, invert=True), TO.clip_models(pt, invert=True))
    _same(JO.slice_models(pj, axis="z", n_slices=4), TO.slice_models(pt, axis="z", n_slices=4))
    _same(JO.pick_models(pj, "groups", "left"), TO.pick_models(pt, "groups", "left"))
    _same(JO.three_d_pick(pj, "groups"), TO.three_d_pick(pt, "groups"))
    _same(JO.three_d_pick(pj, "groups", ["right"]), TO.three_d_pick(pt, "groups", ["right"]))
    for method in ("axis", "orthogonal"):
        _same(JO.three_d_slice(pj, method=method, n_slices=5, axis="y"),
              TO.three_d_slice(pt, method=method, n_slices=5, axis="y"))
    sj, lpj, lj = JO.three_d_slice(pj, method="line", n_slices=7, vec=(1, 1, 0))
    st_, lpt, lt = TO.three_d_slice(pt, method="line", n_slices=7, vec=(1, 1, 0))
    _same(sj, st_)
    assert np.array_equal(lpj, lpt) and np.array_equal(lj, lt)
    with pytest.raises(ValueError, match="method"):
        TO.three_d_slice(pt, method="nope")
    for mod, m in ((JO, pj), (TO, pt)):
        assert mod.interactive_pick(m).n_points == 400
    _same(JO.interactive_pick(pj, predicate=lambda p: p[:, 2] > 0.3),
          TO.interactive_pick(pt, predicate=lambda p: p[:, 2] > 0.3))
    _same(JO.interactive_slice(pj, axis="x"), TO.interactive_slice(pt, axis="x"))
    for b in (None, (0, 1, -1, 1), (0, 1, -1, 1, -0.5, 0.5)):
        _same(JO.interactive_rectangle_clip(pj, bounds=b), TO.interactive_rectangle_clip(pt, bounds=b))
        for invert in (False, True):
            _same(JO.interactive_box_clip(pj, invert=invert, bounds=b),
                  TO.interactive_box_clip(pt, invert=invert, bounds=b))
    _same(JO._subset(pj, np.arange(400) % 3 == 0), st.tdr.utils._subset(pj, np.arange(400) % 3 == 0))
    _same(stt.tdr.utils._subset(pt, np.arange(400) % 3 == 0), JO._subset(pj, np.arange(400) % 3 == 0))


def test_geometry_helpers_match_jax():
    p1, p2, p3 = [0.0, 1.0, 2.0], [3.0, -1.0, 0.5], [1.0, 1.0, 1.0]
    assert TO.euclidean_distance(p1, p2) == JO.euclidean_distance(p1, p2)
    assert np.array_equal(TO.find_plane_equation(p1, p2, p3), JO.find_plane_equation(p1, p2, p3))
    pj, pt = _cloud()
    assert TO.find_model_outline_planes(pt) == JO.find_model_outline_planes(pj)
    plane = JO.find_plane_equation(p1, p2, p3)
    assert np.array_equal(TO.find_intersection(pt, [1, 0, 0], [0, 0, 0], plane),
                          JO.find_intersection(pj, [1, 0, 0], [0, 0, 0], plane))
    assert TO.find_intersection(pt, [0, 0, 0], [0, 0, 0], plane) is None
    assert np.array_equal(TO.create_line(p1, p2, 11), JO.create_line(p1, p2, 11))


def test_rectangle_clip_loop_matches_jax():
    pj, pt = _cloud()
    wj, wt = JI.InteractiveRectangleClip(pj, key="val", plane="xy"), TI.InteractiveRectangleClip(pt, key="val", plane="xy")
    for ext in ((0.0, 1.0, -1.0, 1.0), (-0.5, 0.2, -0.3, 0.9)):
        _same(wj.onselect_extents(*ext), wt.onselect_extents(*ext))
    assert len(wt.picked_models) == 2
    ev = type("E", (), {})
    e1, e2 = ev(), ev()
    e1.xdata, e1.ydata, e2.xdata, e2.ydata = 0.5, 0.6, -0.2, -0.4
    wj._on_event(e1, e2)
    wt._on_event(e1, e2)
    _same(wj.picked_models, wt.picked_models)
    bg = TMC.PointCloud(np.random.default_rng(3).uniform(-1, 1, (50, 3)))
    _same(JI.interactive_rectangle_clip(pj, key="groups", invert=True, bg_model=bg, bounds=(0, 1, -1, 1)),
          TI.interactive_rectangle_clip(pt, key="groups", invert=True, bg_model=bg, bounds=(0, 1, -1, 1)))
    assert isinstance(TI.interactive_rectangle_clip(pt), TI.InteractiveRectangleClip)
    plt.close("all")


def test_lasso_pick_loop_matches_jax():
    pj, pt = _cloud()
    poly = [(-0.5, -0.5), (0.5, -0.5), (0.6, 0.2), (0.5, 0.5), (-0.5, 0.5)]
    for plane in ("xy", "xz", "yz"):
        wj, wt = JI.InteractiveLassoPick(pj, plane=plane), TI.InteractiveLassoPick(pt, plane=plane)
        _same(wj.onselect(poly), wt.onselect(poly))
    _same(JI.interactive_pick(pj, polygon=poly), TI.interactive_pick(pt, polygon=poly))
    assert isinstance(TI.interactive_pick(pt), TI.InteractiveLassoPick)
    plt.close("all")


def test_slider_slice_loop_matches_jax():
    pj, pt = _cloud()
    wj, wt = JI.InteractiveSlicer(pj, key="val", axis="z", thickness=0.4), TI.InteractiveSlicer(pt, key="val", axis="z",
                                                                                              thickness=0.4)
    _same(wj.current_slice, wt.current_slice)
    for v in (0.0, 0.8, -0.95):
        _same(wj.set_position(v), wt.set_position(v))
    wt.slider.set_val(0.3)  # the slider's callback drives the same path
    _same(wt.current_slice, wj.set_position(0.3))
    _same(JI.interactive_slice(pj, axis="y", position=0.1), TI.interactive_slice(pt, axis="y", position=0.1))
    assert isinstance(TI.interactive_slice(pt), TI.InteractiveSlicer)
    plt.close("all")


def test_tdr_widget_aliases_are_the_ops():
    for name in ("clip_models", "interactive_box_clip", "overlap_pick", "slice_models", "three_d_slice"):
        assert getattr(stt.tdr, name) is getattr(TO, name)
    assert stt.tdr.interactive_pick is TI.interactive_pick and stt.tdr.interactive_slice is TI.interactive_slice
    assert stt.tdr.clip.InteractiveRectangleClip is TI.InteractiveRectangleClip
    assert stt.tdr.pick.overlap_pc_pick is TO.overlap_pc_pick and stt.tdr.slice.three_d_slice is TO.three_d_slice


# -- the renderer and the plotting helpers ---------------------------------------------------------------------------


def _draw(plotter, model, **kw):
    fig, axes = plotter.create_plotter(window_size=(200, 200))
    ax = axes[0, 0]
    plotter.add_model(ax, model, **kw)
    plotter.add_model_outline(ax, model)
    plotter.add_outline(ax, model)
    plotter.add_text(ax, "t")
    plotter.add_legend(ax)
    plotter.add_str_legend(ax, ["a", "b"])
    plotter.add_num_legend(ax)
    out = [(type(c).__name__, np.asarray(c.get_offsets() if hasattr(c, "get_offsets") else [])) for c in ax.collections]
    lims = (ax.get_xlim(), ax.get_ylim(), ax.get_zlim())
    plt.close(fig)
    return out, lims


@pytest.mark.parametrize("kind", ["points", "categories", "surface", "wireframe", "lines"])
def test_plotter_draws_what_jax_draws(kind):
    from spateo_tpu.plotting.three_d_plot import three_dims_plotter as JP
    from spateo_tpu_torch.plotting.three_d_plot import three_dims_plotter as TP

    pj, pt = _cloud(60)
    mj, mt, kw = pj, pt, {"key": "val", "model_style": "points"}
    if kind == "categories":
        kw = {"key": "groups", "model_style": "points"}
    elif kind in ("surface", "wireframe"):
        mj, mt = _ellipsoid(JMC, 40), _ellipsoid(TMC, 40)
        mj.point_data["h"] = mt.point_data["h"] = np.asarray(mj.points)[:, 2]
        kw = {"key": "h", "model_style": kind}
    elif kind == "lines":
        kw = {}
        for m in (mj, mt):
            m.edges = np.array([[0, 1], [1, 2], [2, 3]])
    a, b = _draw(JP, mj, **kw), _draw(TP, mt, **kw)
    assert [x[0] for x in a[0]] == [x[0] for x in b[0]]
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(a[0], b[0]))
    assert np.allclose(a[1], b[1])


def test_output_plotter_and_save(tmp_path):
    from spateo_tpu_torch.plotting.three_d_plot import three_dims_plotter as TP

    fig, axes = TP.create_plotter(window_size=(120, 120))
    TP.add_model(axes[0, 0], _cloud(30)[1])
    assert TP.output_plotter(fig) is fig
    assert TP.output_plotter(fig, filename=str(tmp_path / "a.png")) == str(tmp_path / "a.png")
    fig, axes = TP.create_plotter(window_size=(120, 120))
    TP.add_model(axes[0, 0], _cloud(30)[1])
    out = tmp_path / "orbit.gif"
    assert TP.output_plotter(fig, filename=str(out), framerate=10) == str(out) and out.stat().st_size > 1000
    fig = plt.figure()
    assert TP.save_plotter(fig, str(tmp_path / "b.png")) == str(tmp_path / "b.png")
    plt.close("all")


def test_plotting_utils_match_jax(tmp_path):
    from spateo_tpu.plotting import utils as JU
    from spateo_tpu_torch.plotting import utils as TU

    assert np.array_equal(np.asarray(TU.DEFAULT_PALETTE), np.asarray(JU.DEFAULT_PALETTE))
    v = np.linspace(-1, 3, 9)
    assert np.array_equal(TU.map2color(v), JU.map2color(v))
    assert TU._to_hex(TU.map2color(v, cmap="magma")) == JU._to_hex(JU.map2color(v, cmap="magma"))
    assert TU._select_font_color("black") == JU._select_font_color("black") == "white"
    n1, n2 = TU.check_colornorm(0, 4, vcenter=1), JU.check_colornorm(0, 4, vcenter=1)
    assert type(n1) is type(n2) and np.array_equal(n1(v), n2(v))
    assert TU.resolve_cmap(None).name == JU.resolve_cmap(None).name
    assert TU.quiver_autoscaler(np.c_[v, v], np.c_[v, -v]) == JU.quiver_autoscaler(np.c_[v, v], np.c_[v, -v])
    assert TU.default_quiver_args(2, 3) == JU.default_quiver_args(2, 3)
    assert np.array_equal(TU.tricubic(v / 3), JU.tricubic(v / 3))
    assert TU.is_list_of_lists([[1], [2]]) and TU.deduplicate_kwargs({"a": 1}, a=2, b=3) == {"a": 1, "b": 3}
    rng = np.random.default_rng(0)
    X = rng.poisson(2.0, (60, 8)).astype(np.float32)
    aj = st.AnnData(X=X, obs=pd.DataFrame({"c": np.repeat(list("abcd"), 15)}, index=[f"c{i}" for i in range(60)]),
                    var=pd.DataFrame(index=[f"g{i}" for i in range(8)]))
    aj.obsm["X_pca"] = rng.normal(size=(60, 5))
    at = stt.core.bridge.adata_from_reference(aj)
    assert TU.get_categorical_colors(at, "c") == JU.get_categorical_colors(aj, "c")
    assert np.array_equal(TU._get_adata_color_vec(at, None, "g3"), JU._get_adata_color_vec(aj, None, "g3"))
    assert TU.is_gene_name(at, "g1") and TU.is_cell_anno_column(at, "c") and not TU.is_layer_keys(at, "c")
    dj = JU.dendrogram(aj, "c", use_rep="X_pca", inplace=False)
    dt = TU.dendrogram(at, "c", use_rep="X_pca", inplace=False, device="cpu")
    assert dt["categories_ordered"] == dj["categories_ordered"]
    assert np.array_equal(dt["linkage"], dj["linkage"])
    TU.dendrogram(at, "c", var_names=["g1", "g2", "g5"], device="cpu")
    fig, ax = plt.subplots()
    TU.plot_dendrogram(ax, at, "c")
    TU.arrowed_spines(ax, "umap")
    TU.save_fig(str(tmp_path), prefix="d", ext="png", verbose=False)
    assert (tmp_path / "d.png").exists()
    assert TU.save_return_show_fig_utils("return", False, None, "p", None, 1, fig, ax) is ax
    plt.close("all")
