"""The port's image and IO layer against the JAX package on the CPU: every
platform reader of `io.platforms` (and its `nanostring`, `slideseq`, `tenx`
aliases), the stain images (`io.image`, `pp.remove_background`), the
top-level `data_io` readers and `sample_data`. All host code in both
packages, so the bars are equality: the AnnData's X, obs, var, obsm and uns
equal, images equal bit for bit. The inputs are written in each platform's
format under the test's `tmp_path` by `chip_smoke.platform_files` (the files
phase 32c reads on the card's machine).
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
from scipy.sparse import issparse

import spateo_tpu as st
import spateo_tpu_torch as stt
from chip_smoke import platform_files, read_platform, stain
from spateo_tpu_torch.core.bridge import adata_from_reference


def _equal(a, b, path="uns"):
    """Equal nested dicts, arrays and scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (np.ndarray, list, tuple)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype == object:
            for x, y in zip(a.ravel(), b.ravel()):
                _equal(x, y, path)
        else:
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    else:
        assert a == b or (a != a and b != b), path


def _same_adata(j, t):
    assert type(j.X) is type(t.X) or (issparse(j.X) and issparse(t.X))
    X_j, X_t = (x.toarray() if issparse(x) else np.asarray(x) for x in (j.X, t.X))
    assert X_j.dtype == X_t.dtype and np.array_equal(X_j, X_t)
    pd.testing.assert_frame_equal(j.obs, t.obs)
    pd.testing.assert_frame_equal(j.var, t.var)
    assert sorted(j.obsm) == sorted(t.obsm)
    for k in j.obsm:
        _equal(np.asarray(j.obsm[k]), np.asarray(t.obsm[k]), f"obsm/{k}")
    _equal(dict(j.uns), dict(t.uns))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return platform_files(tmp_path_factory.mktemp("platforms"), visium_spots=300, visium_genes=60, n=300, g=40)


@pytest.mark.parametrize("name", ["read_10x", "read_merfish", "read_seqfish", "read_slideseq", "read_seqscope",
                                  "read_nanostring", "read_starmap", "read_csv", "read_mtx"])
def test_platform_readers_match_jax(files, name):
    _same_adata(read_platform(st, name, files[name]), read_platform(stt, name, files[name]))


def test_stitch_images_matches_jax(files, tmp_path):
    spec = files["stitch_images"]
    a, b = read_platform(st, "stitch_images", spec), read_platform(stt, "stitch_images", spec)
    assert a.dtype == b.dtype and np.array_equal(a, b) and np.array_equal(b, spec[3])
    la = st.io.stitch_images(*spec[1], labels=True)
    lb = stt.io.stitch_images(*spec[1], labels=True)
    assert lb.dtype == np.uint64 and np.array_equal(la, lb)
    dup = os.path.join(spec[1][0], "copy_F001.png")
    shutil.copy(os.path.join(spec[1][0], "tile_F001.png"), dup)
    try:
        for mod in (st, stt):
            with pytest.raises(mod.SpateoError, match="Multiple images for FOV 1"):
                mod.io.stitch_images(*spec[1])
    finally:
        os.remove(dup)


@pytest.mark.parametrize("binsize", [None, 50])
def test_read_slideseq_binned_matches_jax(files, binsize):
    args = files["read_slideseq"][1]
    _same_adata(st.io.read_slideseq(*args, binsize=binsize), stt.io.slideseq.read_slideseq(*args, binsize=binsize))


@pytest.mark.parametrize("kw", [{"binsize": 30, "add_props": False}, {"binsize": 200},
                                {"label_columns": "cell_ID", "add_props": False}])
def test_read_nanostring_options_match_jax(files, kw):
    args = files["read_nanostring"][1]
    _same_adata(st.io.read_nanostring(*args, **kw), stt.io.nanostring.read_nanostring(*args, **kw))
    with pytest.raises(stt.SpateoError, match="Exactly one"):
        stt.io.read_nanostring(*args)


@pytest.mark.parametrize("binsize", [None, 1, 20])
def test_read_seqscope_binsizes_match_jax(files, binsize):
    args = files["read_seqscope"][1]
    _same_adata(st.io.read_seqscope(*args, binsize=binsize), stt.io.read_seqscope(*args, binsize=binsize))


def test_read_seqfish_offsets_and_10x_alias_match_jax(files):
    args = files["read_seqfish"][1]
    off = pd.DataFrame({"fov": [0, 1, 2, 3, 4], "x_offset": [0.0, 10, 20, 30, 40], "y_offset": [5.0, 0, 5, 0, 5]})
    for kw in ({"accumulate_x": True}, {"accumulate_y": True}, {}):
        _same_adata(st.io.read_seqfish(*args, fov_offset=off, **kw), stt.io.read_seqfish(*args, fov_offset=off, **kw))
    tenx = files["read_10x"][1]
    _same_adata(st.io.read_10x(*tenx), stt.io.tenx.read_10x(*tenx))
    pd.testing.assert_frame_equal(st.io.tenx.read_10x_positions_as_dataframe(tenx[1]),
                                  stt.io.tenx.read_10x_positions_as_dataframe(tenx[1]))


# -- stain images ----------------------------------------------------------------------------------------------------


def test_read_image_and_remove_background_match_jax(tmp_path):
    import cv2

    img = stain(256, seed=3)
    cv2.imwrite(str(tmp_path / "stain.png"), img)
    aj = st.AnnData(X=np.zeros((3, 2), np.float32))
    at = adata_from_reference(aj)
    st.io.read_image(aj, str(tmp_path / "stain.png"), 0.5, slice="s", img_layer="stain")
    stt.io.read_image(at, str(tmp_path / "stain.png"), 0.5, slice="s", img_layer="stain")
    _equal(aj.uns, at.uns)
    with pytest.raises(FileNotFoundError):
        stt.io.read_image(at, str(tmp_path / "missing.png"), 1.0)
    for kw in ({}, {"threshold": 90}):
        st.io.add_image_layer(aj, img, 0.5, "s", "gray")
        stt.io.add_image_layer(at, img, 0.5, "s", "gray")
        oj = st.pp.remove_background(aj, slice="s", used_img_layer="gray", return_img_layer="fg", **kw)
        ot = stt.pp.remove_background(at, slice="s", used_img_layer="gray", return_img_layer="fg", **kw)
        _equal(oj.uns, ot.uns)
        assert "fg" not in at.uns["spatial"]["s"]["images"]
    assert stt.pp.remove_background(at, slice="s", used_img_layer="gray", return_img_layer="fg", inplace=True) is None
    st.pp.remove_background(aj, slice="s", used_img_layer="gray", return_img_layer="fg", inplace=True)
    _equal(aj.uns, at.uns)
    assert stt.io.image_utils.read_image is stt.io.read_image


# -- data_io (tests/test_data_io.py's cases through both packages) -----------------------------------------------------


@pytest.fixture
def table(tmp_path):
    rng = np.random.default_rng(0)
    df = pd.DataFrame(rng.poisson(2, (6, 4)).astype(float), index=[f"c{i}" for i in range(6)],
                      columns=[f"g{j}" for j in range(4)])
    return df, tmp_path


def test_data_io_text_readers_match_jax(table):
    df, tmp = table
    df.to_csv(tmp / "t.csv")
    df.to_csv(tmp / "t.tsv", sep="\t")
    df.to_csv(tmp / "t.txt", sep=" ")
    for fn, args, kw in (("read_csv", (tmp / "t.csv",), {}), ("read_csv", (tmp / "t.csv",), {"first_column_names": False}),
                         ("read_text", (tmp / "t.tsv",), {"delimiter": "\t"}), ("read_text", (tmp / "t.txt",), {})):
        _same_adata(getattr(st, fn)(*args, **kw), getattr(stt, fn)(*args, **kw))
    rows = ["gene\tcell\tcount"] + [f"{g}\t{c}\t{i + 1}" for i, (g, c) in enumerate(
        [("G1", "A"), ("G2", "B"), ("G1", "C"), ("G3", "A")])]
    (tmp / "umi.tsv").write_text("\n".join(rows) + "\n")
    _same_adata(st.read_umi_tools(tmp / "umi.tsv"), stt.read_umi_tools(tmp / "umi.tsv"))


def test_data_io_mtx_hdf_loom_h5ad_match_jax(table):
    import h5py
    from scipy.io import mmwrite
    from scipy.sparse import csr_matrix

    df, tmp = table
    mmwrite(str(tmp / "t.mtx"), csr_matrix(df.values))
    _same_adata(st.read_mtx(tmp / "t.mtx"), stt.read_mtx(tmp / "t.mtx"))
    with h5py.File(tmp / "t.h5", "w") as f:
        f.create_dataset("X", data=df.values)
        f.create_dataset("obs_names", data=np.array([s.encode() for s in df.index]))
    _same_adata(st.read_hdf(tmp / "t.h5", "X"), stt.read_hdf(tmp / "t.h5", "X"))
    with pytest.raises(KeyError, match="missing"):
        stt.read_hdf(tmp / "t.h5", "missing")
    with h5py.File(tmp / "t.loom", "w") as f:
        f.create_dataset("matrix", data=df.values.T)
        f.create_group("col_attrs").create_dataset("CellID", data=np.array([s.encode() for s in df.index]))
        f["col_attrs"].create_dataset("cluster", data=np.array([b"a", b"b"] * 3))
        f.create_group("row_attrs").create_dataset("Gene", data=np.array([s.encode() for s in df.columns]))
    _same_adata(st.read_loom(tmp / "t.loom"), stt.read_loom(tmp / "t.loom"))
    with h5py.File(tmp / "bad.loom", "w") as f:
        f.create_dataset("X", data=df.values)
    with pytest.raises(ValueError, match="not a loom file"):
        stt.read_loom(tmp / "bad.loom")
    a = st.AnnData(X=df.values, obs=pd.DataFrame(index=df.index), var=pd.DataFrame(index=df.columns))
    a.write(str(tmp / "t.h5ad"))
    _same_adata(st.read(tmp / "t.h5ad"), stt.read(tmp / "t.h5ad"))


def test_read_zarr_raises_as_jax(tmp_path):
    errors = []
    for mod in (st, stt):
        with pytest.raises((ImportError, NotImplementedError)) as e:
            mod.read_zarr(tmp_path / "x.zarr")
        errors.append(type(e.value))
    assert errors[0] is errors[1]


# -- sample_data ---------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"n_cells": 500, "n_genes": 30, "n_domains": 5, "seed": 3}])
def test_synthetic_matches_jax(kw):
    _same_adata(st.sample_data.synthetic(**kw), stt.sample_data.synthetic(**kw))


def test_sample_accessors_fetch_through_urlretrieve(tmp_path, monkeypatch):
    """The accessors with `urlretrieve` replaced by a copy of a local .h5ad:
    the same URLs asked for, the same AnnData read, the backup tried when the
    first fails."""
    import spateo_tpu.sample_data as JS
    import spateo_tpu_torch.sample_data as TS

    src = tmp_path / "src.h5ad"
    st.sample_data.synthetic(n_cells=50, n_genes=8).write(str(src))
    names = ("drosophila", "mousebrain", "axolotl", "slideseq", "seqfish", "merfish", "seqscope", "starmap")
    asked, read, fallback = {}, {}, {}
    for mod in (JS, TS):
        urls = asked[mod] = []

        def fetch(url, path, urls=urls):
            urls.append(url)
            shutil.copy(src, path)

        monkeypatch.setattr(mod, "urlretrieve", fetch)
        read[mod] = [getattr(mod, name)(dir_name=str(tmp_path / mod.__name__)) for name in names]
        with pytest.raises(KeyError, match="unknown sample file"):
            mod.mousebrain(filename="nope.h5ad", dir_name=str(tmp_path / mod.__name__))
        urls = fallback[mod] = []

        def dropbox_down(url, path, urls=urls):
            urls.append(url)
            if "dropbox" in url:
                raise OSError("no route")
            shutil.copy(src, path)

        monkeypatch.setattr(mod, "urlretrieve", dropbox_down)
        mod.axolotl(dir_name=str(tmp_path / ("backup_" + mod.__name__)))
    assert asked[JS] == asked[TS] and len(asked[TS]) == len(names)
    assert fallback[JS] == fallback[TS] and len(fallback[TS]) == 2
    for a, b in zip(read[JS], read[TS]):
        _same_adata(a, b)
    assert TS.download_data("https://x.org/a.h5ad?dl=1", dir_name=str(tmp_path / "TS")).endswith("a.h5ad")
    with pytest.raises(ValueError, match="h5ad"):
        TS.get_adata("https://x.org/a.txt", dir_name=str(tmp_path / "TS"))


# -- the exported names ----------------------------------------------------------------------------------------------


def _init_names(pkg):
    """The public names a package's ``__init__.py`` binds (its imports and
    assignments; not submodules other imports attach later)."""
    import ast
    import pathlib

    tree = ast.parse(pathlib.Path(pkg.__file__).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def test_io_pp_and_root_export_what_jax_exports():
    """`stt.io` and `stt.pp` export every public name of `st.io` and `st.pp`;
    the root lacks none of the JAX package's names (`parallel` since ROADMAP
    item 13)."""
    for a, b in ((st.io, stt.io), (st.pp, stt.pp)):
        assert _init_names(a) <= _init_names(b) | {n for n in dir(b) if not n.startswith("_")}
    assert _init_names(st) - _init_names(stt) == set()
    for name in ("read", "read_csv", "read_excel", "read_h5ad", "read_hdf", "read_loom", "read_mtx", "read_text",
                 "read_umi_tools", "read_zarr", "sample_data", "pl", "ops", "config", "LazyAttribute", "LazyLoader",
                 "get_version", "profiler", "AlignmentError", "DigitizationError", "MeshError",
                 "PreprocessingError"):
        assert hasattr(stt, name), name
