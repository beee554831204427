"""The port's BGI readers and IO utilities (`spateo_tpu_torch.io`) held
against the JAX package's on the CPU, on `test_tutorial_flow.py`'s synthetic
GEM generator and small numpy inputs. Host code in both packages: every
output must be equal (float properties to 1e-12)."""

import gzip

import numpy as np
import pandas as pd
import pytest
from scipy import sparse

import spateo_tpu_torch as stt
from spateo_tpu.io import bgi as jbgi
from spateo_tpu.io import utils as jio
from spateo_tpu_torch.io import bgi as tbgi
from spateo_tpu_torch.io import utils as tio
from test_torch_segmentation import write_gem


@pytest.fixture(scope="module")
def gem(tmp_path_factory):
    return write_gem(tmp_path_factory.mktemp("gem") / "tile.gem.gz")


@pytest.fixture(scope="module")
def labelled_gem(tmp_path_factory):
    """A GEM file with a cell-label column and spliced/unspliced counts."""
    rng = np.random.default_rng(3)
    n = 3000
    df = pd.DataFrame({
        "geneID": rng.choice([f"g{i}" for i in range(10)], n), "x": rng.integers(5, 60, n),
        "y": rng.integers(8, 70, n), "MIDCounts": rng.integers(1, 5, n),
        "EXONIC": rng.integers(0, 3, n), "INTRONIC": rng.integers(0, 3, n),
    })
    df["cell"] = (df["x"] // 12) * 10 + df["y"] // 14
    path = tmp_path_factory.mktemp("gem") / "labelled.gem.gz"
    with gzip.open(path, "wt") as f:
        df.to_csv(f, sep="\t", index=False)
    return str(path)


def _same_adata(a, b):
    assert a.shape == b.shape
    assert list(a.obs_names) == list(b.obs_names) and list(a.var_names) == list(b.var_names)
    xa = a.X.toarray() if sparse.issparse(a.X) else np.asarray(a.X)
    xb = b.X.toarray() if sparse.issparse(b.X) else np.asarray(b.X)
    np.testing.assert_array_equal(xa, xb)
    assert set(a.layers) == set(b.layers)
    for key in a.layers:
        la, lb = a.layers[key], b.layers[key]
        la = la.toarray() if sparse.issparse(la) else np.asarray(la)
        lb = lb.toarray() if sparse.issparse(lb) else np.asarray(lb)
        np.testing.assert_array_equal(la, lb, err_msg=key)
    assert list(a.obs.columns) == list(b.obs.columns)
    for col in a.obs.columns:
        np.testing.assert_allclose(np.asarray(a.obs[col], float), np.asarray(b.obs[col], float), rtol=1e-12)
    assert set(a.obsm) == set(b.obsm)
    for key in a.obsm:
        if key == "contour":
            for ca, cb in zip(a.obsm[key], b.obsm[key]):
                np.testing.assert_allclose(np.asarray(ca, float), np.asarray(cb, float), rtol=1e-12)
        else:
            np.testing.assert_allclose(a.obsm[key], b.obsm[key], rtol=1e-12)
    assert a.uns["__type"] == b.uns["__type"] and a.uns["spatial"] == b.uns["spatial"]


@pytest.mark.parametrize("binsize", [1, 3])
def test_read_bgi_agg_matches_jax(gem, labelled_gem, binsize):
    for path, kw in ((gem, {}), (labelled_gem, dict(label_column="cell", gene_agg={"first": ["g0", "g1"]}))):
        _same_adata(tbgi.read_bgi_agg(path, binsize=binsize, **kw), jbgi.read_bgi_agg(path, binsize=binsize, **kw))


def test_read_bgi_agg_with_stain(gem, tmp_path):
    import cv2

    img = np.random.default_rng(0).integers(0, 255, (130, 125)).astype(np.uint8)
    path = str(tmp_path / "stain.png")
    cv2.imwrite(path, img)
    for kw in (dict(), dict(binsize=2), dict(prealigned=True)):
        a = tbgi.read_bgi_agg(gem, stain_path=path, **kw)
        _same_adata(a, jbgi.read_bgi_agg(gem, stain_path=path, **kw))
        assert "stain" in a.layers
    with pytest.raises(stt.errors.IOError):
        tbgi.read_bgi_agg(gem, stain_path=str(tmp_path / "missing.png"))


def test_read_bgi_cells_matches_jax(gem, labelled_gem):
    """read_bgi per bin, per label column, per labels array and per
    segmentation AnnData (with seg_binsize > 1): cells x genes, areas,
    centroids, boxes and contours equal."""
    for kw in (dict(binsize=1), dict(binsize=10), dict(binsize=10, add_props=False)):
        _same_adata(tbgi.read_bgi(gem, **kw), jbgi.read_bgi(gem, **kw))
    _same_adata(tbgi.read_bgi(labelled_gem, label_column="cell"), jbgi.read_bgi(labelled_gem, label_column="cell"))
    labels = np.zeros((120, 120), int)
    labels[10:30, 10:25] = 1
    labels[50:70, 40:66] = 2
    labels[90:100, 90:119] = 3
    _same_adata(tbgi.read_bgi(gem, labels=labels), jbgi.read_bgi(gem, labels=labels))
    agg_j, agg_t = jbgi.read_bgi_agg(gem, binsize=2), tbgi.read_bgi_agg(gem, binsize=2)
    for a in (agg_j, agg_t):
        a.layers["cells"] = labels[::2, ::2]
    _same_adata(tbgi.read_bgi(gem, segmentation_adata=agg_t, labels_layer="cells"),
                jbgi.read_bgi(gem, segmentation_adata=agg_j, labels_layer="cells"))
    for bad in (dict(), dict(binsize=2, labels=labels), dict(segmentation_adata=agg_t), dict(binsize=-2)):
        with pytest.raises(stt.errors.IOError):
            tbgi.read_bgi(gem, **bad)


def test_label_rasters_from_dataframe(labelled_gem):
    df_j, df_t = jbgi.read_bgi_as_dataframe(labelled_gem, "cell"), tbgi.read_bgi_as_dataframe(labelled_gem, "cell")
    pd.testing.assert_frame_equal(df_t, df_j)
    np.testing.assert_array_equal(tbgi.dataframe_to_labels(df_t, "label"), jbgi.dataframe_to_labels(df_j, "label"))
    np.testing.assert_array_equal(tbgi.dataframe_to_filled_labels(df_t, "label"),
                                  jbgi.dataframe_to_filled_labels(df_j, "label"))
    with pytest.raises(stt.errors.IOError):
        tbgi.read_bgi_as_dataframe(labelled_gem, "nope")


def test_io_utils_match_jax():
    rng = np.random.default_rng(4)
    coords = rng.uniform(0, 500, 200)
    np.testing.assert_array_equal(tio.bin_indices(coords, 3.0, 7), jio.bin_indices(coords, 3.0, 7))
    np.testing.assert_array_equal(tio.centroids(np.arange(5), 2.0, 7), jio.centroids(np.arange(5), 2.0, 7))
    X = rng.integers(0, 5, (23, 31))
    np.testing.assert_array_equal(tio.bin_matrix(X, 4), jio.bin_matrix(X, 4))
    np.testing.assert_array_equal(tio.bin_matrix(sparse.csr_matrix(X), 4).toarray(),
                                  jio.bin_matrix(sparse.csr_matrix(X), 4).toarray())
    labels = np.zeros((40, 50), int)
    labels[3:15, 4:20] = 1
    labels[20:38, 30:45] = 2
    labels[25, 5] = 3
    pd.testing.assert_frame_equal(tio.get_coords_labels(labels), jio.get_coords_labels(labels))
    for tp, jp in ((tio.get_label_props(labels), jio.get_label_props(labels)),
                   (tio.get_points_props(tio.get_coords_labels(labels)), jio.get_points_props(jio.get_coords_labels(labels)))):
        assert list(tp.index) == list(jp.index)
        for col in jp.columns:
            if col == "contour":
                for a, b in zip(tp[col], jp[col]):
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(tp[col].to_numpy(float), jp[col].to_numpy(float))
    assert tio.get_label_props(np.zeros((4, 4), int)).empty
    bins = pd.DataFrame({"x": [0, 1, 2], "y": [3, 1, 0], "label": ["a", "b", "c"]})
    pd.testing.assert_frame_equal(tio.get_bin_props(bins, 5).drop(columns="contour"),
                                  jio.get_bin_props(bins, 5).drop(columns="contour"))
    np.testing.assert_array_equal(tio.contour_to_geo([[0, 1], [2, 3]]), jio.contour_to_geo([[0, 1], [2, 3]]))
    hull = np.array([[0.0, 0.0], [10.0, 0.0], [10.0, 10.0], [0.0, 10.0]])
    pts = rng.uniform(-5, 15, (50, 2))
    np.testing.assert_array_equal(tio.in_convex_hull(pts, hull), jio.in_convex_hull(pts, hull))
    np.testing.assert_array_equal(tio.in_concave_hull(pts, hull), jio.in_concave_hull(pts, hull))


def _polygons(rng):
    """Convex and concave star polygons, lattice polygons (repeated
    vertices, self-touching and self-crossing), a closed ring whose last
    vertex repeats its first, and a degenerate two-vertex path."""
    out = []
    for _ in range(30):
        m = int(rng.integers(3, 12))
        ang = np.sort(rng.uniform(0, 2 * np.pi, m))
        r = rng.uniform(0.3, 1.0, m)
        out.append(np.c_[r * np.cos(ang), r * np.sin(ang)])
        out.append(rng.integers(0, 6, (m, 2)).astype(float))
    square = np.array([[0.0, 0.0], [4.0, 0.0], [4.0, 4.0], [0.0, 4.0]])
    out += [square, np.vstack([square, square[:1]]), square[:2],
            np.array([[0, 0], [4, 0], [2, 2], [4, 4], [0, 4], [2, 2]], float)]
    return out


def _probe_points(rng, v):
    """Random points around the polygon, every vertex, points on every edge
    and a half-integer lattice through the vertices' grid."""
    lo, hi = v.min(0) - 1, v.max(0) + 1
    t = rng.uniform(0, 1, (60, 1))
    j = rng.integers(0, len(v), 60)
    on_edges = v[j] + t * (np.roll(v, -1, axis=0)[j] - v[j])
    lattice = np.mgrid[lo[0]:hi[0]:0.5, lo[1]:hi[1]:0.5].reshape(2, -1).T
    return np.vstack([rng.uniform(lo, hi, (300, 2)), v, on_edges, lattice])


def test_in_concave_hull_equals_matplotlib():
    """`in_concave_hull` (numpy, no matplotlib) against
    ``matplotlib.path.Path(hull).contains_points(p)``: the boolean arrays
    are equal, points on edges and vertices included; a non-finite point is
    outside in both."""
    from matplotlib.path import Path

    rng = np.random.default_rng(0)
    for v in _polygons(rng):
        p = _probe_points(rng, v)
        np.testing.assert_array_equal(tio.in_concave_hull(p, v), Path(v).contains_points(p))
    v = _polygons(rng)[0]
    p = np.array([[np.nan, 0.0], [0.0, np.inf], [0.0, 0.0]])
    np.testing.assert_array_equal(tio.in_concave_hull(p, v), Path(v).contains_points(p))


def test_in_concave_hull_blocks_agree(monkeypatch):
    """Points tested in blocks (a block smaller than the point count) give
    the same answer as one block."""
    rng = np.random.default_rng(1)
    v = _polygons(rng)[1]
    p = _probe_points(rng, v)
    whole = tio.in_concave_hull(p, v)
    monkeypatch.setattr(tio, "_HULL_BLOCK_ELEMS", 7 * len(v))
    np.testing.assert_array_equal(tio.in_concave_hull(p, v), whole)
