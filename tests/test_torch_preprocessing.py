"""The port's `stt.pp` (filters, `normalize_total`, the edgeR factors, the
Seurat HVFs, sparse `scale`) and `stt.tl.pca` / `stt.align.group_pca`
against the JAX package's, on the CPU.

Bars:

- Filters, `normalize_total`, TMMwsp, RLE, upper quartile, the HVFs and the
  sparse scalings: exact (host code copied, or a CSR scaling equal to
  scikit-learn's `sparsefuncs` bit for bit).
- TMM (`_tmm_batched`, float64 on the device): 1e-10 of the JAX package's
  run with x64 on, on counts without equal ratios. On integer counts
  several genes share one ratio, so the trims' ranks break ties; XLA's
  `log2` rounds 52 of 300 such logratios one ulp off numpy's (torch's equal
  numpy's there), which reorders tied genes at a trim edge and moves
  factors by up to 5e-3. Those are held to 1e-12 of a numpy transcription
  of edgeR in float64 (the JAX package's own test's `np_tmm`), and to the
  JAX package's own float32 bar (1.5e-2) of its default run.
- PCA: 1e-8 of scale, each column up to its sign (QR and SVD signs are
  LAPACK's choice).
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.preprocessing import normalize as jn
from spateo_tpu_torch.core.bridge import adata_from_reference
from spateo_tpu_torch.preprocessing import normalize as tn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCA_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU among its
    workers, where torch's thread pools only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counts_adata(n=120, g=60, seed=0, sparse_x=True):
    rng = np.random.default_rng(seed)
    X = rng.poisson(rng.gamma(1.0, 1.0, g), size=(n, g)).astype(np.float32)
    X[:, :3] += rng.poisson(8.0, (n, 3))
    adata = st.AnnData(
        X=sparse.csr_matrix(X) if sparse_x else X,
        obs=pd.DataFrame({"area": rng.uniform(0, 10, n)}, index=[f"c{i}" for i in range(n)]),
        var=pd.DataFrame(index=[f"g{j}" for j in range(g)]),
    )
    adata.obsm["spatial"] = rng.uniform(0, 50, (n, 2))
    st.SKM.init_adata_type(adata, "UMI")
    return adata


def _dense(X):
    return X.toarray() if sparse.issparse(X) else np.asarray(X)


@pytest.mark.parametrize("kind", ["cells", "cells_area", "genes", "coords", "keep_filtered"])
def test_filters_match_jax(kind):
    a = _counts_adata()
    b = adata_from_reference(a)
    if kind == "cells":
        ja, tb = st.pp.filter_cells(a, min_expr_genes=25), stt.pp.filter_cells(b, min_expr_genes=25)
    elif kind == "cells_area":
        ja, tb = st.pp.filter_cells(a, min_expr_genes=5, min_area=3), stt.pp.filter_cells(b, min_expr_genes=5, min_area=3)
    elif kind == "genes":
        ja = st.pp.filter_genes(a, min_cells=40, min_avg_exp=0.5)
        tb = stt.pp.filter_genes(b, min_cells=40, min_avg_exp=0.5)
    elif kind == "coords":
        ja = st.pp.filter_by_coordinates(a, x_range=(5, 30), y_range=(10, 45))
        tb = stt.pp.filter_by_coordinates(b, x_range=(5, 30), y_range=(10, 45))
    else:
        ja = st.pp.filter_cells(a, min_expr_genes=25, keep_filtered=True)
        tb = stt.pp.filter_cells(b, min_expr_genes=25, keep_filtered=True)
        np.testing.assert_array_equal(tb.obs["pass_basic_filter"], ja.obs["pass_basic_filter"])
    assert list(tb.obs_names) == list(ja.obs_names) and list(tb.var_names) == list(ja.var_names)
    np.testing.assert_array_equal(_dense(tb.X), _dense(ja.X))


@pytest.mark.parametrize("sparse_x", [True, False])
@pytest.mark.parametrize("kw", [{}, {"target_sum": 100.0, "key_added": "n_counts"},
                                {"exclude_highly_expressed": True, "max_fraction": 0.1}])
def test_normalize_total_matches_jax(sparse_x, kw):
    a = _counts_adata(sparse_x=sparse_x)
    b = adata_from_reference(a)
    st.pp.normalize_total(a, **kw)
    stt.pp.normalize_total(b, **kw)
    assert sparse.issparse(b.X) == sparse_x
    np.testing.assert_array_equal(_dense(b.X), _dense(a.X))
    if "key_added" in kw:
        np.testing.assert_array_equal(b.obs["n_counts"], a.obs["n_counts"])
    out_j = st.pp.normalize_total(_counts_adata(sparse_x=sparse_x), inplace=False)
    out_t = stt.pp.normalize_total(adata_from_reference(_counts_adata(sparse_x=sparse_x)), inplace=False)
    np.testing.assert_array_equal(_dense(out_t["X"]), _dense(out_j["X"]))
    np.testing.assert_array_equal(out_t["norm_factor"], out_j["norm_factor"])


def test_factor_normalization_matches_jax():
    a = _counts_adata(sparse_x=False)
    b = adata_from_reference(a)
    st.pp.factor_normalization(a, method="upperquartile", target_sum=1e3)
    stt.pp.factor_normalization(b, method="upperquartile", target_sum=1e3, device="cpu")
    np.testing.assert_array_equal(_dense(b.X), _dense(a.X))


def _np_tmm(obs, ref, nO, nR, logratioTrim=0.3, sumTrim=0.05):
    """edgeR's calcFactorTMM in float64 numpy (tests/test_io.py's)."""
    logR = np.log2((obs / nO) / (ref / nR))
    absE = (np.log2(obs / nO) + np.log2(ref / nR)) / 2
    v = (nO - obs) / nO / obs + (nR - ref) / nR / ref
    fin = np.isfinite(logR) & np.isfinite(absE) & (absE > -1e10)
    logR, absE, v = logR[fin], absE[fin], v[fin]
    if np.max(np.abs(logR)) < 1e-6:
        return 1.0
    n = len(logR)
    loL = int(n * logratioTrim) + 1
    loS = int(n * sumTrim) + 1
    keep = (np.argsort(logR, kind="stable").argsort() >= loL) & (np.argsort(absE, kind="stable").argsort() >= loS)
    f = np.sum(logR[keep] / v[keep]) / np.sum(1 / v[keep])
    return 2**f if not np.isnan(f) else 1.0


@pytest.mark.parametrize("weighting", [True, False])
def test_tmm_matches_jax_in_float64(weighting):
    rng = np.random.default_rng(0)
    counts = rng.gamma(2.0, 3.0, size=(40, 300)) * (rng.random((40, 300)) > 0.2)
    with jax.enable_x64(True):
        ref = jn.calcNormFactors(counts, method="TMM", doWeighting=weighting)
    got = tn.calcNormFactors(counts, method="TMM", doWeighting=weighting, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    with jax.enable_x64(True):
        one = jn.calcFactorTMM(counts[3], counts[7])
    assert tn.calcFactorTMM(counts[3], counts[7], device="cpu") == pytest.approx(one, abs=1e-10)


def test_tmm_on_integer_counts():
    rng = np.random.default_rng(42)
    counts = rng.negative_binomial(5, 0.3, size=(12, 300)).astype(float)
    lib = counts.sum(1)
    f95 = np.percentile(counts, 95, axis=1) / lib
    ref_col = int(np.argmin(np.abs(f95 - f95.mean())))
    expected = np.array([_np_tmm(counts[i], counts[ref_col], lib[i], lib[ref_col]) for i in range(12)])
    got = tn.calcNormFactors(sparse.csr_matrix(counts), method="TMM", device="cpu")
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, jn.calcNormFactors(counts, method="TMM"), rtol=1.5e-2)


@pytest.mark.parametrize("method", ["TMMwsp", "RLE", "upperquartile"])
def test_host_factors_match_jax(method):
    rng = np.random.default_rng(1)
    counts = rng.negative_binomial(5, 0.3, size=(15, 200)).astype(float) + (method == "RLE")
    np.testing.assert_allclose(tn.calcNormFactors(counts, method=method, device="cpu"),
                               jn.calcNormFactors(counts, method=method), rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="Invalid method"):
        tn.calcNormFactors(counts, method="nope", device="cpu")


@pytest.mark.parametrize("n_top", [20, None])
def test_select_hvf_seurat_matches_jax(n_top):
    a = _counts_adata(n=200, g=80)
    st.pp.log1p(a)
    b = adata_from_reference(a)
    hj = jn.select_hvf_seurat(a, n_top=n_top)
    ht = tn.select_hvf_seurat(b, n_top=n_top)
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(b.var["hvf_rank"], a.var["hvf_rank"])


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_sparse_scale_matches_jax(fmt):
    """`scale(zero_center=False)` of a sparse matrix: the column scaling the
    JAX package asks scikit-learn for, bit for bit."""
    rng = np.random.default_rng(5)
    X = sparse.random(60, 25, density=0.3, format=fmt, random_state=3, data_rvs=lambda k: rng.gamma(2.0, 2.0, k))
    xj, mj, sj = st.pp.scale(X.copy(), zero_center=False, max_value=3.0, return_mean_std=True)
    xt, mt, s_t = stt.pp.scale(X.copy(), zero_center=False, max_value=3.0, return_mean_std=True)
    np.testing.assert_array_equal(xt.toarray(), xj.toarray())
    np.testing.assert_array_equal(s_t, sj)
    from sklearn.utils import sparsefuncs

    from spateo_tpu_torch.preprocessing.transform import inplace_column_scale, inplace_row_scale

    r = rng.uniform(0.5, 2.0, 60)
    A, B = X.copy(), X.copy()
    sparsefuncs.inplace_row_scale(A, r)
    inplace_row_scale(B, r)
    np.testing.assert_array_equal(A.toarray(), B.toarray())
    with pytest.raises(TypeError):
        inplace_column_scale(X.tocoo(), r[:25])


def test_fast_utils_copy_matches_jax():
    from spateo_tpu.preprocessing import _fast_utils as jf
    from spateo_tpu_torch.preprocessing import _fast_utils as tf

    X = sparse.random(30, 12, density=0.4, format="csr", random_state=0)
    codes = np.random.default_rng(0).integers(0, 3, 30)
    for axis in (0, 1):
        for a, b in zip(tf.calc_mean_and_var_sparse(30, 12, X.data, X.indices, X.indptr, axis),
                        jf.calc_mean_and_var_sparse(30, 12, X.data, X.indices, X.indptr, axis)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tf.calc_stat_per_batch_dense(30, 12, X.toarray(), 3, codes),
                    jf.calc_stat_per_batch_dense(30, 12, X.toarray(), 3, codes)):
        np.testing.assert_array_equal(a, b)


def _same_up_to_sign(got, ref, tol=PCA_TOL):
    s = np.sign((got * ref).sum(0))
    scale = np.abs(ref).max()
    assert np.abs(got * s - ref).max() <= tol * scale
    return s


@pytest.mark.parametrize("sparse_x", [True, False])
def test_pca_matches_jax(sparse_x):
    from spateo_tpu.tools import dimensionality_reduction as jdr
    from spateo_tpu_torch.tools import dimensionality_reduction as tdr

    a = _counts_adata(n=150, g=70, sparse_x=sparse_x)
    a.X[:, 5] = 0
    b = adata_from_reference(a)
    jdr.pca(a, n_pca_components=12)
    tdr.pca(b, n_pca_components=12, device="cpu")
    np.testing.assert_array_equal(b.var["use_for_pca"], a.var["use_for_pca"])
    s = _same_up_to_sign(b.obsm["X_pca"], a.obsm["X_pca"])
    _same_up_to_sign(b.uns["PCs"].T, a.uns["PCs"].T)
    assert np.array_equal(np.sign((b.uns["PCs"] * a.uns["PCs"]).sum(1)), s)
    np.testing.assert_allclose(b.uns["explained_variance_ratio_"], a.uns["explained_variance_ratio_"], rtol=1e-10)
    _, Xj = jdr.truncated_SVD_with_center(a.X, 6)
    _, Xt = tdr.truncated_SVD_with_center(b.X, 6, device="cpu")
    _same_up_to_sign(Xt, Xj)


def test_group_pca_matches_jax():
    """Joint HVGs and PCA of two slices: the same HVGs, PCs up to sign."""
    a1, a2 = _counts_adata(n=90, g=50, seed=1), _counts_adata(n=70, g=50, seed=2)
    for a in (a1, a2):
        st.pp.log1p(a)
    b1, b2 = adata_from_reference(a1), adata_from_reference(a2)
    st.align.group_pca([a1, a2], hvg_top=30, n_comps=8)
    stt.align.group_pca([b1, b2], hvg_top=30, n_comps=8, device="cpu")
    s = _same_up_to_sign(np.vstack([b1.obsm["X_pca"], b2.obsm["X_pca"]]),
                         np.vstack([a1.obsm["X_pca"], a2.obsm["X_pca"]]))
    assert len(s) == 8
    assert list(b1.obs["slices"]) == list(a1.obs["slices"])


def test_no_module_imports_sklearn_jax_or_the_jax_package():
    """Every module of `spateo_tpu_torch` imported in a fresh interpreter,
    and the calls for which the JAX package asks scikit-learn, optax or JAX's
    device programs (`pc_KDE`, `SimplePPT_tree` in its 3D models; `pca_fit`,
    the Frobenius center NMF, `cal_ami`, `cal_f1score`; the neighbour
    graphs, `scc`, `mclust_py`, k-means, the silhouette, SpaGCN, UMAP, the
    two-group CCI test, Moran's I of cell bins, the three interpolation
    engines and `backbone_scc`; PCA's randomized and ARPACK solvers,
    `sample`, `binary_morani_result`, the `core` device helpers, LISA, the
    spatial-lag model, bivariate Moran, the spatial DEGs and smoothing;
    t-SNE, `points_inside_mesh`, `remove_background`, the platform readers,
    `data_io` and `sample_data.synthetic`) run on the CPU, bring in no
    scikit-learn, JAX, optax, umap, `spateo_tpu`, matplotlib or imageio; and
    no line of the package imports them."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import numpy as np\n"
        "import spateo_tpu_torch\n"
        "for m in pkgutil.walk_packages(spateo_tpu_torch.__path__, 'spateo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "X = np.random.default_rng(0).normal(size=(60, 3))\n"
        "spateo_tpu_torch.tdr.pc_KDE(spateo_tpu_torch.tdr.PointCloud(X), device='cpu')\n"
        "spateo_tpu_torch.tdr.models.models_backbone.SimplePPT_tree(X, NumNodes=5, device='cpu')\n"
        "spateo_tpu_torch.tl.pca_fit(X, n_components=2, device='cpu')\n"
        "spateo_tpu_torch.align.methods.center_NMF(2, 0, 'euclidean', device='cpu').fit_transform(np.abs(X))\n"
        "spateo_tpu_torch.cs.simulation_evaluation.cal_ami(X[:, 0] > 0, X[:, 1] > 0)\n"
        "spateo_tpu_torch.cs.simulation_evaluation.cal_f1score(X[:, 0] > 0, X[:, 1] > 0)\n"
        "spateo_tpu_torch.io.in_concave_hull(X[:, :2], X[:5, :2])\n"
        "import pandas as pd\n"
        "stt = spateo_tpu_torch\n"
        "rng = np.random.default_rng(1)\n"
        "c = rng.uniform(0, 10, (120, 2))\n"
        "E = rng.poisson(1.0, (120, 8)).astype(np.float32)\n"
        "E[:, 0] += (c[:, 0] < 5) * 3\n"
        "E[:, 1] += (c[:, 0] >= 5) * 3\n"
        "a = stt.AnnData(X=E, obs=pd.DataFrame({'g': np.where(c[:, 0] < 5, 'A', 'B')}, index=[f'c{i}' for i in range(120)]),\n"
        "                var=pd.DataFrame(index=['TGFB1', 'TGFBR1_TGFBR2'] + [f'g{i}' for i in range(6)]))\n"
        "stt.SKM.init_adata_type(a, 'UMI')\n"
        "a.obsm['spatial'] = c\n"
        "a.obsm['X_pca'] = np.c_[E[:, :2], rng.normal(size=(120, 3))]\n"
        "stt.tl.neighbors(a, n_neighbors=8, device='cpu')\n"
        "stt.tl.construct_nn_graph(a, device='cpu')\n"
        "stt.tl.scc(a, e_neigh=8, s_neigh=4, device='cpu')\n"
        "stt.tl.mclust_py(a, n_components=2, device='cpu')\n"
        "stt.tl.kmeans_clustering(a, 2, device='cpu')\n"
        "stt.tl.ecp_silhouette(a.obsm['X_pca'], a.obs['g'], device='cpu')\n"
        "stt.tl.spagcn_pyg(a, n_clusters=2, device='cpu')\n"
        "stt.tl.perform_dimensionality_reduction(a, n_pca_components=5, n_neighbors=10, max_iter=5, device='cpu')\n"
        "stt.tl.find_cci_two_group(a, group='g', sender_group='A', receiver_group='B', num=10, pvalue=1.1, min_pairs_ratio=1e-5, device='cpu')\n"
        "a.obs['Celltype'] = a.obs['g']\n"
        "stt.tl.cellbin_morani(a, binsize=1)\n"
        "T = rng.uniform(1, 9, (20, 2))\n"
        "stt.tdr.vtk_interpolation(a, T, keys=['g0'], device='cpu')\n"
        "stt.tdr.gp_interpolation(a, T, keys=['g0'], training_iter=3, inducing_num=16, device='cpu')\n"
        "stt.tdr.deep_intepretation(a, T, keys=['g0'], max_iter=3, device='cpu')\n"
        "bb = stt.tdr.PointCloud(np.c_[np.linspace(0, 10, 4), np.linspace(0, 10, 4)])\n"
        "bb.edges = np.array([[0, 1], [1, 2], [2, 3]])\n"
        "stt.tdr.backbone_scc(a, bb, e_neigh=8, s_neigh=4, device='cpu')\n"
        "Y = rng.normal(size=(80, 40))\n"
        "stt.tl.pca_fit(Y, n_components=5, svd_solver='randomized', device='cpu')\n"
        "stt.tl.pca_fit(Y, n_components=5, svd_solver='arpack', device='cpu')\n"
        "for m in ('random', 'trn', 'kmeans', 'lhs'):\n"
        "    stt.align.methods.sample(c, 20, method=m, device='cpu')\n"
        "stt.align.methods.sample(c, 20, method='velocity', V=c, device='cpu')\n"
        "from spateo_tpu_torch.segmentation.moran import binary_morani_result, moranI, _moran_kernel_weights\n"
        "_, mc, _, mp = moranI(np.abs(Y), _moran_kernel_weights(5), device='cpu')\n"
        "binary_morani_result(mc, mp, method='otsu', device='cpu')\n"
        "binary_morani_result(mc, mp, method='edge-watershed', device='cpu')\n"
        "stt.core.layer_to_device(a, device='cpu')\n"
        "stt.core.segment_sum_device(E, np.arange(120) % 3, 3, device='cpu')\n"
        "stt.core.points_to_raster(np.arange(5), np.arange(5), np.ones(5), (6, 6), device='cpu')\n"
        "a.obs['score'] = E[:, 0]\n"
        "stt.tl.local_moran_i(a, 'g', device='cpu')\n"
        "stt.tl.lisa_geo_df(a, 'g2', device='cpu')\n"
        "stt.tl.GM_lag_model(a, 'g', genes=['g2', 'g3'], device='cpu')\n"
        "stt.tl.spatial_bv_moran_obs_genes(a, 'score', genes=['g2'], permutations=9, device='cpu')\n"
        "stt.tl.spatial_bv_local_moran(a, 'g2', 'score', permutations=9, device='cpu')\n"
        "stt.tl.find_spatial_cluster_degs(a, 'A', group='g', k=5, device='cpu')\n"
        "stt.tl.smooth(E, a.obsp['spatial_connectivities'])\n"
        "from spateo_tpu_torch.tools import _tsne\n"
        "Y0 = _tsne.TSNE(device='cpu').initial_embedding(a.obsm['X_pca'])\n"
        "P = _tsne.joint_probabilities_nn(*_tsne.knn_sqdistances(a.obsm['X_pca'], 30, device='cpu'), 10.0)\n"
        "_tsne.gradient_descent(lambda y, ce: _tsne.kl_divergence_bh(y, P, P.values.float(), 1, 0.5, ce), Y0, 0, 3)\n"
        "import tempfile, chip_smoke\n"
        "m = chip_smoke.e95_stack(n_sections=2, n_cells=10, n_surface=200)[0]\n"
        "stt.tdr.overlap_pc_pick(stt.tdr.PointCloud(rng.uniform(-1, 1, (50, 3))), m, device='cpu')\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    spec = chip_smoke.platform_files(tmp, visium_spots=20, visium_genes=10, n=30, g=5)\n"
        "    for name in spec:\n"
        "        chip_smoke.read_platform(stt, name, spec[name])\n"
        "stt.io.add_image_layer(a, chip_smoke.stain(64), 1.0, 's', 'stain')\n"
        "stt.pp.remove_background(a, slice='s', used_img_layer='stain', return_img_layer='fg')\n"
        "stt.sample_data.synthetic(n_cells=40, n_genes=6)\n"
        "bad = sorted({k.split('.')[0] for k in sys.modules}\n"
        "             & {'sklearn', 'jax', 'jaxlib', 'optax', 'umap', 'spateo_tpu', 'matplotlib', 'imageio'})\n"
        "print('BAD', bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BAD []" in proc.stdout, proc.stdout[-2000:]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|optax|sklearn|umap|spateo_tpu)\b", re.MULTILINE)
    hits = []
    for root, _, files in os.walk(os.path.join(REPO, "spateo_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                hits += [f"{path}: {m.group(0)}" for m in pattern.finditer(open(path).read())]
    assert hits == []


def test_no_module_imports_matplotlib_on_import():
    """Importing every module of `spateo_tpu_torch` in a fresh interpreter
    (`plotting` and its submodules, `profiler`, `configuration` and
    `colormaps` among them), `in_concave_hull`, the configuration, the
    profiler's timer and audit and the palettes load no matplotlib (the GPU
    machine has none; plot functions and the figure settings import it
    inside themselves)."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import numpy as np\n"
        "import spateo_tpu_torch\n"
        "walked = set()\n"
        "for m in pkgutil.walk_packages(spateo_tpu_torch.__path__, 'spateo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    walked.add(m.name)\n"
        "spateo_tpu_torch.io.in_concave_hull(np.zeros((2, 2)), np.eye(3)[:, :2])\n"
        "stt = spateo_tpu_torch\n"
        "with stt.profiler.timer('t', log=False), stt.profiler.sync_audit(log=False):\n"
        "    float(stt.config.dtype is not None) + len(stt.colormaps.cyc_20)\n"
        "need = {'spateo_tpu_torch.' + n for n in ('plotting.scatters', 'plotting.space', 'plotting.dotplot',\n"
        "        'plotting.interactive.agg', 'plotting.static', 'plotting.three_d_plot.three_dims_plots',\n"
        "        'plotting.three_d_plot.pairwise_align_plots', 'profiler', 'configuration', 'colormaps',\n"
        "        'get_version', 'utils', 'warnings', '_lazy_loader')}\n"
        "print('UNWALKED', sorted(need - walked))\n"
        "print('MPL', sorted(k for k in sys.modules if k.split('.')[0] in ('matplotlib', 'mpl_toolkits')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "UNWALKED []" in proc.stdout, proc.stdout[-2000:]
    assert "MPL []" in proc.stdout, proc.stdout[-2000:]
