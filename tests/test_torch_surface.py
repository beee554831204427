"""Public names that ported modules took from the JAX package late: point
cloud sampling (`alignment.methods.sample` and its helpers),
`segmentation.moran.binary_morani_result`, the logging helpers, the `core`
device helpers and PCA's randomized and ARPACK solvers, each against the JAX
package (or, for PCA, the scikit-learn it calls) on the CPU; and the diff of
top-level public names between every ported module and its JAX counterpart.

Bars:

- Sampling: the same indices and points, bit for bit (the k-means path is
  `ops.kmeans.MiniBatchKMeans`, held against scikit-learn's in
  `test_torch_kmeans.py`).
- `binary_morani_result`: pixels that differ, counted; 0 on these rasters.
- The bridge helpers: equal to the JAX arrays (sums of whole numbers below
  2^24 are exact in any order).
- PCA's randomized and ARPACK solvers: components, projections and
  variances within `PCA_TOL` = 1e-10 of scale of scikit-learn 1.9's
  (measured at most 5e-13).
"""

import ast
import logging
import pathlib

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse

import spateo_tpu as st
import spateo_tpu_torch as stt
from bench import make_raster
from spateo_tpu import logging as JLg
from spateo_tpu.alignment.methods import sampling as JS
from spateo_tpu.core import bridge as JB
from spateo_tpu.segmentation import moran as JM
from spateo_tpu_torch import logging as TLg
from spateo_tpu_torch.alignment.methods import sampling as TS
from spateo_tpu_torch.core import bridge as TB
from spateo_tpu_torch.core.bridge import adata_from_reference
from spateo_tpu_torch.segmentation import moran as TM
from spateo_tpu_torch.tools.dimensionality_reduction import PCA, pca_fit

PCA_TOL = 1e-10
ROOT = pathlib.Path(__file__).resolve().parents[1]
#: Public names of JAX modules that the port's counterpart lacks on purpose,
#: each with where it stands; renamed counterparts map to their new name.
LEFT_OUT = {
    # the port returns plain dicts filled by one batched copy
    "ops/vfc.py": {"LazyHostDict"},
}
RENAMED = {"ops/vfc.py": {"vector_field_function_jax": "vector_field_function_torch"}}
#: Names that a JAX package's ``__init__.py`` binds and its port's does not,
#: each with where it stands.
LEFT_OUT_EXPORTS = {}


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


def _scaled(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# -- the public-name diff ----------------------------------------------------------------------------


def _public_names(path):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def _ported_modules():
    jax_root, port_root = ROOT / "spateo_tpu", ROOT / "spateo_tpu_torch"
    return [p.relative_to(jax_root).as_posix() for p in sorted(jax_root.rglob("*.py"))
            if (port_root / p.relative_to(jax_root)).exists()]


def test_every_ported_module_has_its_counterparts_public_names():
    """For every module of the port with a JAX counterpart, the JAX module's
    top-level public functions and classes less the port's are exactly the
    `LEFT_OUT` set (renames applied)."""
    modules = _ported_modules()
    assert len(modules) > 150
    for rel in modules:
        jax_names = _public_names(ROOT / "spateo_tpu" / rel)
        port_names = _public_names(ROOT / "spateo_tpu_torch" / rel)
        renamed = RENAMED.get(rel, {})
        assert set(renamed.values()) <= port_names, rel
        missing = {renamed.get(n, n) for n in jax_names} - port_names
        assert missing == LEFT_OUT.get(rel, set()), (rel, sorted(missing))


def _exported_names(path):
    """The public names a package's ``__init__.py`` binds by its imports and
    assignments (not submodules that other imports attach later, and not
    names taken from `typing` or `__future__`)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module in ("typing", "__future__"):
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def test_every_ported_package_exports_its_counterparts_names():
    """For every package of the port with a JAX counterpart, the names the
    JAX package's ``__init__.py`` binds less the port's are exactly the
    `LEFT_OUT_EXPORTS` set."""
    packages = [rel for rel in _ported_modules() if rel.endswith("__init__.py")]
    assert len(packages) > 25
    for rel in packages:
        missing = _exported_names(ROOT / "spateo_tpu" / rel) - _exported_names(ROOT / "spateo_tpu_torch" / rel)
        assert missing == LEFT_OUT_EXPORTS.get(rel, set()), (rel, sorted(missing))


# -- sampling ----------------------------------------------------------------------------------------


def _cloud(n=500, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 10, (n, 2)), rng.normal(size=(n, 2))


@pytest.mark.parametrize("method", ["random", "velocity", "trn", "kmeans", "lhs", "LHS"])
@pytest.mark.parametrize("aux", [False, True])
def test_sample_matches_jax(method, aux):
    X, V = _cloud()
    arr = np.arange(len(X))[:, None] * np.ones((1, 3))
    kw = {"X": X} if aux else {}
    src = arr if aux else X
    a = JS.sample(src, 60, method=method, V=V, seed=5, **kw)
    b = TS.sample(src, 60, method=method, V=V, seed=5, device="cpu", **kw)
    assert np.array_equal(a, b)


def test_sample_rejects_velocity_without_V_as_jax_does():
    X, _ = _cloud()
    for mod in (JS, TS):
        with pytest.raises(NotImplementedError, match="velocity"):
            mod.sample(X, 10, method="velocity")


def test_sample_kmeans_ignores_seed_as_jax_does():
    """`sample(method="kmeans")` takes `sample_by_kmeans`'s own seed (0)."""
    X, _ = _cloud()
    a = TS.sample(X, 40, method="kmeans", seed=1, device="cpu")
    assert np.array_equal(a, TS.sample(X, 40, method="kmeans", seed=2, device="cpu"))
    assert np.array_equal(a, X[TS.sample_by_kmeans(X, 40, return_index=True, device="cpu")])


@pytest.mark.parametrize("return_index", [True, False])
def test_sample_by_kmeans_and_velocity_match_jax(return_index):
    X, V = _cloud()
    assert np.array_equal(TS.sample_by_kmeans(X, 30, return_index=return_index, seed=3, device="cpu"),
                          JS.sample_by_kmeans(X, 30, return_index=return_index, seed=3))
    assert np.array_equal(TS.sample_by_velocity(V, 70, seed=4), JS.sample_by_velocity(V, 70, seed=4))


@pytest.mark.parametrize("return_index", [True, False])
def test_trn_matches_jax(return_index):
    X, _ = _cloud(n=200)
    a, b = TS.trn(X, 25, return_index=return_index, seed=7), JS.trn(X, 25, return_index=return_index, seed=7)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("bounds", [None, [[0.0, 2.0], [-1.0, 1.0], [5.0, 6.0]]])
def test_lhsclassic_matches_jax(bounds):
    assert np.array_equal(TS.lhsclassic(17, 3, bounds=bounds, seed=2), JS.lhsclassic(17, 3, bounds=bounds, seed=2))


@pytest.mark.parametrize("c", [0, 3])
def test_trnet_matches_jax(c):
    X, _ = _cloud(n=150)
    a, b = TS.TRNET(12, X, seed=1), JS.TRNET(12, X, seed=1)
    assert np.array_equal(a.draw_sample(8), b.draw_sample(8))
    assert np.array_equal(a.run(tmax=120, c=c), b.run(tmax=120, c=c))
    a.run_n_pause(10, 40, tmax=60)
    b.run_n_pause(10, 40, tmax=60)
    assert np.array_equal(a.W, b.W)
    a.runOnce(X[3], 0.5, 0.1)
    b.runOnce(X[3], 0.5, 0.1)
    assert np.array_equal(a.W, b.W)


def test_sample_is_exported_where_jax_exports_it():
    assert stt.align.methods.sample is TS.sample and st.align.methods.sample is JS.sample


# -- binary_morani_result ---------------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["otsu", "edge-watershed"])
@pytest.mark.parametrize("tissue", [False, True])
def test_binary_morani_result_matches_jax(method, tissue):
    X = make_raster(96, 96, seed=0)
    _, c, _, p = JM.moranI(X, JM._moran_kernel_weights(7))
    tissue_mask = np.zeros(X.shape, np.uint8)
    tissue_mask[8:88, 4:80] = 1
    kw = {"tissue_mask": tissue_mask} if tissue else {}
    a = JM.binary_morani_result(c, p, method=method, **kw)
    b = TM.binary_morani_result(c, p, method=method, device="cpu", **kw)
    assert a.any() and (~a).any()
    assert int((a != b).sum()) == 0


def test_binary_morani_result_given_cutoffs_matches_jax():
    X = make_raster(64, 64, seed=1)
    _, c, _, p = JM.moranI(X, JM._moran_kernel_weights(5))
    for kw in ({"pvalue_cutoff": 0.05}, {"pvalue_cutoff": 0.01, "c_cutoff": 1.0}):
        assert np.array_equal(TM.binary_morani_result(c, p, device="cpu", **kw), JM.binary_morani_result(c, p, **kw))
    with pytest.raises(ValueError, match="unknown method"):
        TM.binary_morani_result(c, p, method="nope", device="cpu")


# -- logging ------------------------------------------------------------------------------------------------


def test_logging_helpers_match_jax():
    for level in (logging.INFO, logging.WARNING, logging.CRITICAL, logging.DEBUG, logging.ERROR):
        for indent in (1, 2):
            assert TLg.format_logging_message("m", level, indent) == JLg.format_logging_message("m", level, indent)
    TLg.set_logger_level("spateo_port_test", logging.WARNING)
    assert logging.getLogger("spateo_port_test").level == logging.WARNING
    TLg.silence_logger("spateo_port_test")
    lg = logging.getLogger("spateo_port_test")
    assert lg.level == logging.CRITICAL + 100 and lg.propagate is False

    @TLg.timeit
    def twice(x):
        """doc"""
        return 2 * x

    assert twice(4) == 8 and twice.__name__ == "twice" and twice.__doc__ == "doc"


# -- the core device helpers ----------------------------------------------------------------------------------


@pytest.mark.parametrize("pads", [(1, 1), (8, 128)])
def test_csr_and_layer_to_device_match_jax(pads):
    rng = np.random.default_rng(0)
    M = sparse.random(37, 53, density=0.2, random_state=0, format="csr") * 10
    M.data = np.round(M.data)
    a, shape_a = JB.csr_to_dense_device(M, pad_rows_to=pads[0], pad_cols_to=pads[1])
    b, shape_b = TB.csr_to_dense_device(M, pad_rows_to=pads[0], pad_cols_to=pads[1], device="cpu")
    assert shape_a == shape_b == (37, 53) and b.dtype == torch.float32
    assert np.array_equal(np.asarray(a), b.numpy())
    aj = st.AnnData(X=M, var=pd.DataFrame(index=[f"g{i}" for i in range(53)]))
    aj.layers["dense"] = rng.poisson(2.0, (37, 53)).astype(np.float64)
    at = adata_from_reference(aj)
    for layer in (None, "dense"):
        a, sa = JB.layer_to_device(aj, layer, pad_rows_to=pads[0], pad_cols_to=pads[1])
        b, sb = TB.layer_to_device(at, layer, pad_rows_to=pads[0], pad_cols_to=pads[1], device="cpu")
        assert sa == sb and np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.float32])
def test_segment_sum_device_matches_jax(dtype):
    rng = np.random.default_rng(1)
    values = rng.integers(0, 50, (400, 3)).astype(dtype)
    ids = rng.integers(-2, 12, 400)  # out-of-range ids are dropped in both
    a = np.asarray(JB.segment_sum_device(values, ids, 10))
    b = TB.segment_sum_device(values, ids, 10, device="cpu").numpy()
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_points_to_raster_matches_jax():
    rng = np.random.default_rng(2)
    x, y = rng.integers(0, 30, 1000), rng.integers(0, 20, 1000)
    counts = rng.integers(1, 9, 1000)
    a = np.asarray(JB.points_to_raster(x, y, counts, (30, 20)))
    b = TB.points_to_raster(x, y, counts, (30, 20), device="cpu").numpy()
    assert np.array_equal(a, b)
    assert stt.core.points_to_raster is TB.points_to_raster and stt.core.layer_to_device is TB.layer_to_device


# -- PCA's randomized and ARPACK solvers ---------------------------------------------------------------------


def _pca_data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)) @ rng.normal(size=(d, d)) * 0.1 + rng.normal(size=(n, d))


def _check_pca(X, **kw):
    from sklearn.decomposition import PCA as SkPCA

    a = SkPCA(random_state=0, **kw).fit(X)
    b = PCA(random_state=0, device="cpu", **kw).fit(X)
    assert _scaled(b.components_, a.components_) <= PCA_TOL
    assert _scaled(b.transform(X), a.transform(X)) <= PCA_TOL
    for attr in ("explained_variance_", "explained_variance_ratio_", "singular_values_", "mean_"):
        assert _scaled(getattr(b, attr), getattr(a, attr)) <= PCA_TOL, attr
    assert abs(b.noise_variance_ - a.noise_variance_) <= PCA_TOL * a.explained_variance_[0]
    assert b.n_components_ == a.n_components_
    return a


@pytest.mark.parametrize("n,d", [(2000, 1500), (2000, 300), (300, 2000)])
def test_pca_auto_takes_the_randomized_solver_as_sklearn(n, d):
    a = _check_pca(_pca_data(n, d), n_components=10)
    assert a._fit_svd_solver == "randomized"


@pytest.mark.parametrize("normalizer,iterated_power", [("LU", "auto"), ("QR", "auto"), ("none", "auto"),
                                                       ("auto", 2), ("auto", 5)])
def test_pca_randomized_normalizers_match_sklearn(normalizer, iterated_power):
    _check_pca(_pca_data(600, 200), n_components=12, svd_solver="randomized",
               power_iteration_normalizer=normalizer, iterated_power=iterated_power, n_oversamples=6)


@pytest.mark.parametrize("n,d,k", [(600, 200, 10), (150, 400, 20), (100, 30, None)])
def test_pca_arpack_matches_sklearn(n, d, k):
    _check_pca(_pca_data(n, d), n_components=k, svd_solver="arpack")


def test_pca_fit_runs_where_jax_runs():
    """`pca_fit` at 2,000 x 300 with 10 components, which scikit-learn's
    "auto" (the JAX package's `pca_fit`) sends to the randomized solver."""
    from spateo_tpu.tools.dimensionality_reduction import pca_fit as jax_pca_fit

    X = _pca_data(2000, 300)
    fa, Pa = jax_pca_fit(X, n_components=10, random_state=0)
    fb, Pb = pca_fit(X, n_components=10, random_state=0, device="cpu")
    assert _scaled(Pb, Pa) <= PCA_TOL and _scaled(fb.components_, fa.components_) <= PCA_TOL
    with pytest.raises(NotImplementedError, match="whole number"):
        PCA(n_components="mle", device="cpu").fit(X)
    with pytest.raises(ValueError, match="strictly below"):
        PCA(n_components=300, svd_solver="arpack", device="cpu").fit(X)
