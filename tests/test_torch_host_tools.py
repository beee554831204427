"""The port's host tools (`stt.tl`: cluster and GLM DEGs, LISA and the
spatial-lag model, bivariate Moran, smoothing, the niche tools and FDR,
expression variance, labels, archetypes, the lasso, live wire, ROI;
`stt.pp.auxseg`) against the JAX package on the CPU, on 300-600 cells.

Bars:

- Code copied from the JAX package: equal, or to `COPY_TOL` = 1e-12
  relative where a float passes through another function of the port.
- What runs on the card (the kNN graph, LISA's lags and permutations,
  `GM_lag_model`'s 2SLS without the [n, n] projection, bivariate Moran's
  products and null): values within `DEVICE_TOL` = 1e-10 relative in
  float64. LISA's lags sum in another order than the JAX package's dense
  products, so a permuted statistic that ties the observed one in exact
  arithmetic may fall on either side of it; its p-values may differ only
  at such ties, counted (`_tie_flips_only`). The local bivariate lags add
  in scipy's CSR order, so its I and p-values are equal.
- The spatial kNN (`find_spatial_cluster_degs`, LISA) is held equal on a
  cloud with no ties; scikit-learn orders tied neighbours its own way, the
  port by index (`test_torch_cluster.py` pins that on a lattice).
"""

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.tools import lisa as JL
from spateo_tpu_torch.core.bridge import adata_from_reference
from spateo_tpu_torch.tools import lisa as TL
from spateo_tpu_torch.tools import spatial_correlation as TC

COPY_TOL, DEVICE_TOL, TIE_TOL = 1e-12, 1e-10, 1e-9
LR_GENES = ["TGFB1", "TGFBR1_TGFBR2", "EGF", "EGFR"]


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


def _section(n=400, g=24, seed=0, sparse_x=False):
    """A JAX package AnnData of `n` cells in 3 horizontal bands (genes 0-5
    planted by band, the first four named as ligands and receptors) and the
    port's copy."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 10, (n, 2))
    band = np.minimum((coords[:, 1] // (10 / 3)).astype(int), 2)
    X = rng.poisson(1.0, (n, g)).astype(float)
    X[:, :6] += (band[:, None] == np.arange(6)[None] % 3) * rng.poisson(4, (n, 6))
    names = LR_GENES + [f"g{i}" for i in range(4, g)]
    obs = pd.DataFrame({"band": np.array(["b0", "b1", "b2"])[band], "time": coords[:, 1] / 10,
                        "score": X[:, 0] + rng.normal(size=n)}, index=[f"c{i}" for i in range(n)])
    aj = st.AnnData(X=sparse.csr_matrix(X) if sparse_x else X, obs=obs, var=pd.DataFrame(index=names))
    st.SKM.init_adata_type(aj, "UMI")
    aj.obsm["spatial"] = coords
    return aj, adata_from_reference(aj)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.nanmax(np.abs(a - b)) / max(np.nanmax(np.abs(b)), 1e-300))


def _frames_equal(a, b, rtol=COPY_TOL):
    pd.testing.assert_frame_equal(a.reset_index(drop=True), b.reset_index(drop=True), check_exact=False, rtol=rtol,
                                  atol=0)


def _tie_flips_only(p_t, p_j, I_obs, I_perm_j):
    """The cells whose p-values differ all have a permuted statistic of the
    JAX package within `TIE_TOL` of scale of the observed one; returns
    their count."""
    diff = np.flatnonzero(p_t != p_j)
    scale = max(np.abs(I_obs).max(), 1e-300)
    for i in diff:
        assert np.min(np.abs(I_perm_j[:, i] - I_obs[i])) <= TIE_TOL * scale, i
    return len(diff)


# -- LISA ------------------------------------------------------------------------------------------


def _jax_local_moran_null(x, W, permutations, seed=0):
    """The JAX package's permuted I (its loop, kept here to find ties)."""
    n = len(x)
    z = (x - x.mean()) / max(x.std(), 1e-30)
    m2 = (z**2).sum() / n
    rng = np.random.default_rng(seed)
    return np.stack([z * (W @ z[rng.permutation(n)]) / m2 for _ in range(permutations)])


@pytest.mark.parametrize("k", [5, 8])
def test_knn_weights_match_the_dense_graph(k):
    aj, _ = _section()
    coords = np.asarray(aj.obsm["spatial"])
    W = JL._row_std_knn_w(coords, k)
    nbr, w = TL._row_std_knn_w(coords, k, device="cpu")
    Wt = np.zeros_like(W)
    np.add.at(Wt, (np.repeat(np.arange(len(W)), nbr.shape[1]), nbr.numpy().ravel()), w.numpy().ravel())
    assert np.array_equal(Wt, W)


@pytest.mark.parametrize("permutations", [99, 199])
def test_local_moran_matches_jax(permutations):
    aj, _ = _section()
    coords = np.asarray(aj.obsm["spatial"])
    X = np.asarray(aj.X)[:, :8]
    W = JL._row_std_knn_w(coords, 5)
    nbr, w = TL._row_std_knn_w(coords, 5, device="cpu")
    Is, q, p, z, lag = TL._local_moran(X, nbr, w, permutations=permutations)
    flips = 0
    for j in range(X.shape[1]):
        Ij, qj, pj, zj, lagj = JL._local_moran(X[:, j], W, permutations=permutations)
        assert _rel(Is[j], Ij) <= DEVICE_TOL and _rel(lag[j], lagj) <= DEVICE_TOL
        assert np.array_equal(z[j], zj) and np.array_equal(q[j], qj)
        flips += _tie_flips_only(p[j], pj, Ij, _jax_local_moran_null(X[:, j], W, permutations))
    assert flips > 0  # counts tie often
    Xc = X + np.random.default_rng(1).uniform(0, 0.5, X.shape)  # no ties
    p = TL._local_moran(Xc, nbr, w, permutations=permutations)[2]
    for j in range(X.shape[1]):
        assert np.array_equal(p[j], JL._local_moran(Xc[:, j], W, permutations=permutations)[2])


@pytest.mark.parametrize("layer", [None, "counts"])
def test_lisa_geo_df_matches_jax(layer):
    aj, at = _section()
    if layer:
        aj.layers[layer] = np.asarray(aj.X).copy()
        at.layers[layer] = np.asarray(at.X).copy()
    lj, dj = st.tl.lisa_geo_df(aj, "TGFB1", layer=layer)
    lt, dt = stt.tl.lisa_geo_df(at, "TGFB1", layer=layer, device="cpu")
    num = ["x", "y", "exp", "w_exp", "exp_zscore", "w_exp_zscore", "Is"]
    _frames_equal(dt[num], dj[num], rtol=DEVICE_TOL)
    if np.array_equal(lt.p_sim, lj.p_sim):
        assert (dt[["labels", "sig", "group"]] == dj[["labels", "sig", "group"]]).all().all()
    else:
        W = JL._row_std_knn_w(np.asarray(aj.obsm["spatial"]), 8)
        _tie_flips_only(lt.p_sim, lj.p_sim, lj.Is, _jax_local_moran_null(dj["exp"].values, W, 199))


def test_local_moran_i_matches_jax():
    """On expression with no ties (counts jittered), where the p-values
    agree exactly."""
    aj, at = _section()
    jitter = np.random.default_rng(1).uniform(0, 0.5, aj.X.shape)
    aj.X = np.asarray(aj.X) + jitter
    at.X = np.asarray(at.X) + jitter
    st.tl.local_moran_i(aj, "band")
    stt.tl.local_moran_i(at, "band", device="cpu")
    cols = [c for c in aj.var.columns if c.endswith(("_val", "_group"))]
    assert len(cols) == 24
    pd.testing.assert_frame_equal(at.var[cols], aj.var[cols])


@pytest.mark.parametrize("drop_dummy", [None, "b1"])
def test_GM_lag_model_matches_jax(drop_dummy):
    aj, at = _section()
    genes = [f"g{i}" for i in range(4, 12)] + ["TGFB1"]
    st.tl.GM_lag_model(aj, "band", genes=genes, drop_dummy=drop_dummy)
    stt.tl.GM_lag_model(at, "band", genes=genes, drop_dummy=drop_dummy, device="cpu")
    cols = [c for c in aj.var.columns if "_GM_lag_" in c]
    assert cols and list(at.var.columns) == list(aj.var.columns)
    for c in cols:
        a, b = at.var[c].values.astype(float), aj.var[c].values.astype(float)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert _rel(a, b) <= DEVICE_TOL, c


# -- bivariate Moran ---------------------------------------------------------------------------------


def test_spatial_bv_moran_obs_genes_matches_jax():
    aj, at = _section()
    dj = st.tl.spatial_bv_moran_obs_genes(aj, "score", genes=list(aj.var_names[:10]), copy=True)
    dt = stt.tl.spatial_bv_moran_obs_genes(at, "score", genes=list(at.var_names[:10]), copy=True, device="cpu")
    assert list(dt.index) == list(dj.index) and list(dt.columns) == list(dj.columns)
    for c in ("I", "EI_sim", "z_sim"):
        assert _rel(dt[c], dj[c]) <= DEVICE_TOL, c
    assert np.array_equal(dt["pval_sim"], dj["pval_sim"])
    assert _rel(dt["pval_z_sim"], dj["pval_z_sim"]) <= 1e-8
    for genes in ("TGFB1", 3):
        a = stt.tl.spatial_bv_moran_obs_genes(at, "score", genes=genes, permutations=None, copy=True, device="cpu")
        b = st.tl.spatial_bv_moran_obs_genes(aj, "score", genes=genes, permutations=None, copy=True)
        assert list(a.index) == list(b.index) and _rel(a["I"], b["I"]) <= DEVICE_TOL


@pytest.mark.parametrize("keys", [("TGFB1", "score"), ("g4", "g5")])
def test_spatial_bv_local_moran_matches_jax(keys):
    """The lags and the null add each row's terms in scipy's CSR order, so
    I and the p-values equal the JAX package's bit for bit, counts (whose
    lags tie often) included."""
    aj, at = _section()
    dj = st.tl.spatial_bv_local_moran(aj, *keys, copy=True)
    dt = stt.tl.spatial_bv_local_moran(at, *keys, copy=True, device="cpu")
    assert list(dt.columns) == list(dj.columns)
    for c in ("I", "q", "pval_sim"):
        assert np.array_equal(dt[c], dj[c]), c
    for c in ("EI_sim", "z_sim", "pval_z_sim"):
        assert _rel(dt[c], dj[c]) <= DEVICE_TOL, c
    stt.tl.spatial_bv_local_moran(at, *keys, device="cpu")
    assert f"{keys[0]}_{keys[1]}_bv_local_moranI" in at.uns


def test_permutations_are_drawn_once_in_jax_order():
    """Both statistics reseed with 0 for every gene in the JAX package, so
    one set of draws serves every gene."""
    rng = np.random.default_rng(0)
    expect = np.stack([rng.permutation(50) for _ in range(7)])
    assert np.array_equal(TC._permutations(50, 7, 0, "cpu").numpy(), expect)


# -- DEGs --------------------------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["multiple", "pairwise"])
def test_find_cluster_degs_matches_jax(method):
    aj, at = _section()
    dj = st.tl.find_cluster_degs(aj, "b0", ["b1", "b2"], group="band", method=method)
    dt = stt.tl.find_cluster_degs(at, "b0", ["b1", "b2"], group="band", method=method)
    assert len(dj) > 0
    _frames_equal(dt, dj)


def test_find_all_cluster_degs_and_top_n_match_jax():
    aj, at = _section(sparse_x=True)
    st.tl.find_all_cluster_degs(aj, "band", copy=False)
    stt.tl.find_all_cluster_degs(at, "band", copy=False)
    mj, mt = aj.uns["cluster_markers"], at.uns["cluster_markers"]
    assert mt["de_genes"] == mj["de_genes"]
    for g in mj["deg_tables"]:
        _frames_equal(mt["deg_tables"][g], mj["deg_tables"][g])
    assert stt.tl.top_n_degs(at, "band") == st.tl.top_n_degs(aj, "band")
    _frames_equal(stt.tl.top_n_degs(at, "band", only_deg_list=False),
                  st.tl.top_n_degs(aj, "band", only_deg_list=False))


@pytest.mark.parametrize("k", [6, 10])
def test_find_spatial_cluster_degs_matches_jax(k):
    aj, at = _section()
    dj = st.tl.find_spatial_cluster_degs(aj, "b1", group="band", k=k)
    dt = stt.tl.find_spatial_cluster_degs(at, "b1", group="band", k=k, device="cpu")
    _frames_equal(dt, dj)


@pytest.mark.parametrize("zinb", [False, True])
def test_glm_degs_matches_jax(zinb):
    aj, at = _section(n=300)
    genes = ["TGFB1", "g4", "g5", "EGF"]
    st.tl.glm_degs(aj, genes=genes, use_zinb=zinb, llf_threshold=None)
    stt.tl.glm_degs(at, genes=genes, use_zinb=zinb, llf_threshold=None)
    rj, rt = aj.uns["glm_degs"], at.uns["glm_degs"]
    _frames_equal(rt["glm_result"], rj["glm_result"])
    assert list(rt["correlation"]) == list(rj["correlation"])
    for g in rj["correlation"]:
        _frames_equal(rt["correlation"][g], rj["correlation"][g])


def test_glm_test_and_lrt_match_jax():
    from spateo_tpu.tools import glm as JG
    from spateo_tpu_torch.tools import glm as TG

    aj, _ = _section(n=300)
    data = aj.obs[["time"]].copy()
    data["band"] = pd.Categorical(aj.obs["band"].astype(object))
    data["expression"] = np.asarray(aj.X)[:, 0]
    for full, red in (("~cr(time, df=3)", "~1"), ("~band + time", "~time")):
        fj, nj = JG.glm_test(data, full, red)
        ft, nt = TG.glm_test(data, full, red)
        assert _rel(ft.llf, fj.llf) <= COPY_TOL and _rel(ft.mu, fj.mu) <= COPY_TOL
        assert ft.df_model == fj.df_model and _rel(nt.llf, nj.llf) <= COPY_TOL
        assert _rel(TG.lrt(ft, nt), JG.lrt(fj, nj)) <= 1e-10
        zj = JG.zinb_test(data, full, red)
        zt = TG.zinb_test(data, full, red)
        assert _rel([zt[0].llf, zt[1].llf], [zj[0].llf, zj[1].llf]) <= COPY_TOL


# -- smoothing ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["normalize", "discrete", "ct", "jaccard", "subsample", "probabilistic", "mask"])
def test_smooth_matches_jax(case):
    aj, at = _section(n=300)
    X = sparse.csr_matrix(np.asarray(aj.X))
    stt.tl.neighbors(at, basis="spatial", n_neighbors=8, device="cpu")
    W = at.obsp["spatial_connectivities"]
    kw = {
        "normalize": {}, "discrete": {"return_discrete": True},
        "ct": {"ct": np.asarray(aj.obs["band"])}, "jaccard": {"gene_expr_subset": X[:, :6]},
        "subsample": {"n_subsample": 4}, "probabilistic": {"normalize_W": False, "smoothing_threshold": 0.5},
        "mask": {"manual_mask": np.asarray(W.todense()) > 0, "return_W": True},
    }[case]
    outs = []
    for mod in (st.tl, stt.tl):
        np.random.seed(3)
        outs.append(mod.smooth(X, W, **kw))
    for a, b in zip(outs[1] if isinstance(outs[1], tuple) else [outs[1]],
                    outs[0] if isinstance(outs[0], tuple) else [outs[0]]):
        a = a.toarray() if sparse.issparse(a) else np.asarray(a)
        b = b.toarray() if sparse.issparse(b) else np.asarray(b)
        assert np.array_equal(a, b)


def test_smooth_helpers_match_jax():
    from spateo_tpu.tools import spatial_smooth as JS
    from spateo_tpu_torch.tools import spatial_smooth as TS

    rng = np.random.default_rng(1)
    B = sparse.random(80, 30, density=0.2, random_state=1, format="csr")
    for data in (B, B.toarray()):
        a, b = TS.compute_jaccard_similarity_matrix(data, chunk_size=7), JS.compute_jaccard_similarity_matrix(data,
                                                                                                              chunk_size=7)
        assert np.array_equal(a.toarray() if sparse.issparse(a) else a, b.toarray() if sparse.issparse(b) else b)
    for nz in (False, True):
        assert TS.sparse_matrix_median(B, nonzero_only=nz) == JS.sparse_matrix_median(B, nonzero_only=nz)
    Wd = (rng.random((40, 40)) < 0.3).astype(float)
    np.random.seed(0)
    a = TS.subsample_neighbors_dense(Wd, 5)
    np.random.seed(0)
    assert np.array_equal(a, JS.subsample_neighbors_dense(Wd, 5))


# -- niche tools, FDR, variance, labels, archetypes --------------------------------------------------


@pytest.mark.parametrize("system,method,weighted", [("niches_n2n", "sum", False), ("niches_c2n", "gmean", False),
                                                    ("niches_n2c", "mean", True), ("niches_c2c", "sum", False)])
def test_niches_match_jax(system, method, weighted):
    aj, at = _section(n=120)
    st.tl.neighbors(aj, basis="spatial", n_neighbors=6)
    stt.tl.neighbors(at, basis="spatial", n_neighbors=6, device="cpu")
    oj = st.tl.niches(aj, system=system, method=method, weighted=weighted)
    ot = stt.tl.niches(at, system=system, method=method, weighted=weighted)
    assert list(ot.var_names) == list(oj.var_names) and list(ot.obs_names) == list(oj.obs_names)
    pd.testing.assert_frame_equal(ot.obs, oj.obs)
    assert _rel(ot.X.toarray(), oj.X.toarray()) <= COPY_TOL


def test_ligand_activities_and_targets_match_jax():
    aj, at = _section(n=120)
    geneset = ["EGFR", "g4", "g5", "g6"]
    with np.errstate(all="ignore"):
        _frames_equal(stt.tl.predict_ligand_activities(at, geneset=geneset),
                      st.tl.predict_ligand_activities(aj, geneset=geneset))
        _frames_equal(stt.tl.predict_target_genes(at, geneset=geneset),
                      st.tl.predict_target_genes(aj, geneset=geneset))


@pytest.mark.parametrize("axis", ["clusters", "interactions"])
def test_fdr_correct_matches_jax(axis):
    from spateo_tpu.tools.cci_fdr import fdr_correct as jf
    from spateo_tpu_torch.tools.cci_fdr import fdr_correct as tf

    pv = pd.DataFrame(np.random.default_rng(0).uniform(size=(12, 4)), columns=list("abcd"))
    pv.iloc[2, 1] = np.nan
    _frames_equal(tf(pv, corr_axis=axis), jf(pv, corr_axis=axis))


def test_variance_tools_match_jax():
    from spateo_tpu.tools import gene_expression_variance as JV
    from spateo_tpu_torch.tools import gene_expression_variance as TV

    aj, at = _section()
    aj.obs["region"] = at.obs["region"] = np.where(np.asarray(aj.obsm["spatial"])[:, 0] > 5, "r", "l")
    genes = ["TGFB1", "g4", "g7"]
    _frames_equal(TV.compute_variance_decomposition(at, "region", "band", genes=genes),
                  JV.compute_variance_decomposition(aj, "region", "band", genes=genes))
    _frames_equal(TV.genewise_variance_decomposition(at, "band", genes),
                  JV.genewise_variance_decomposition(aj, "band", genes))
    g1, g2 = (aj.obs["band"] == "b0").values, (aj.obs["band"] == "b1").values
    assert TV.compute_gene_groups_p_val("TGFB1", at[g1], at[g2]) == JV.compute_gene_groups_p_val("TGFB1", aj[g1],
                                                                                                 aj[g2])
    X = np.asarray(aj.X)
    for kw in ({}, {"numgenes": 5}):
        (dt, it), (dj, ij) = TV.get_highvar_genes(X, **kw), JV.get_highvar_genes(X, **kw)
        _frames_equal(dt, dj)
        assert it == ij
    (dt, it), (dj, ij) = TV.get_highvar_genes_sparse(sparse.csr_matrix(X)), JV.get_highvar_genes_sparse(
        sparse.csr_matrix(X))
    _frames_equal(dt, dj)


def test_labels_match_jax():
    from spateo_tpu.tools import labels as JLb
    from spateo_tpu_torch.tools import labels as TLb

    aj, at = _section(n=60)
    rng = np.random.default_rng(0)
    dense = [rng.integers(0, k, 60) for k in (3, 4, 5)]
    G = sparse.random(60, 60, density=0.1, random_state=0, format="csr")
    assert (TLb.row_normalize(G, verbose=False) != JLb.row_normalize(G, verbose=False)).nnz == 0
    lt, lj = [TLb.Label(d) for d in dense], [JLb.Label(d) for d in dense]
    for a, b in zip(lt, lj):
        assert np.array_equal(a.dense, b.dense) and (a.get_normalized_onehot() != b.get_normalized_onehot()).nnz == 0
        assert np.array_equal(TLb.interlabel_connections(a, G), JLb.interlabel_connections(b, G))
    assert np.array_equal(TLb.expand_labels(lt[0], 6).dense, JLb.expand_labels(lj[0], 6).dense)
    for assign in ("greedy", "random"):
        np.random.seed(0)
        a = TLb.match_labels(lt[0], lt[2], extra_labels_assignment=assign)
        np.random.seed(0)
        assert np.array_equal(a.dense, JLb.match_labels(lj[0], lj[2], extra_labels_assignment=assign).dense)
    mt, nt = TLb.match_label_series(lt)
    mj, nj = JLb.match_label_series(lj)
    assert nt == nj and all(np.array_equal(a.dense, b.dense) for a, b in zip(mt, mj))
    ct, cj = TLb.create_label_class(at, ["band"]), JLb.create_label_class(aj, ["band"])
    assert np.array_equal(ct[0].dense, cj[0].dense) and ct[0].str_map == cj[0].str_map


def test_archetypes_match_jax():
    aj, at = _section()
    genes = list(aj.var_names[:16])
    arch_j = st.tl.archetypes(aj, moran_i_genes=genes, num_clusters=3)
    arch_t = stt.tl.archetypes(at, moran_i_genes=genes, num_clusters=3)
    assert np.array_equal(arch_t, arch_j) and np.array_equal(at.obsm["archetype"], aj.obsm["archetype"])
    oj = st.tl.archetypes_genes(aj, arch_j, 3, genes)
    ot = stt.tl.archetypes_genes(at, arch_t, 3, genes)
    assert ot.keys() == oj.keys() and all(np.array_equal(ot[k], oj[k]) for k in oj)
    E = np.asarray(aj.X)[:, :16].T
    (a1, c1, g1), (a2, c2, g2) = stt.tl.find_spatial_archetypes(3, E), st.tl.find_spatial_archetypes(3, E)
    assert np.array_equal(a1, a2) and np.array_equal(c1, c2) and np.array_equal(g1, g2)
    for thr in (0.0, 0.05):
        a = stt.tl.get_genes_from_spatial_archetype(E, genes, a1, 0, pval_threshold=thr)
        b = st.tl.get_genes_from_spatial_archetype(E, genes, a2, 0, pval_threshold=thr)
        assert (a is None and b is None) or np.array_equal(a, b)
        a = stt.tl.find_spatially_related_genes(E, genes, a1, 2, pval_threshold=thr)
        b = st.tl.find_spatially_related_genes(E, genes, a2, 2, pval_threshold=thr)
        assert (a is None and b is None) or np.array_equal(a, b)


# -- lasso, live wire, ROI, auxseg -------------------------------------------------------------------


def test_lasso_select_matches_jax():
    aj, at = _section()
    poly = np.array([[1.0, 1.0], [7.0, 2.0], [6.0, 8.0], [2.0, 6.0]])
    sj, stt_sub = st.tl.Lasso(aj).select(poly), stt.tl.Lasso(at).select(poly)
    assert list(stt_sub.obs_names) == list(sj.obs_names) and stt.tl.Lasso.sub_adata is stt_sub


def _valley(n=40, seed=0):
    img = np.random.default_rng(seed).uniform(0.4, 0.6, (n, n))
    img[:, n // 2 - 1 : n // 2 + 2] = 0.0
    img[n // 3, :] = 0.05
    return img


@pytest.mark.parametrize("smooth,thresh", [(False, False), (True, False), (False, True)])
def test_live_wire_matches_jax(smooth, thresh):
    img = _valley()
    a = stt.tl.LiveWireSegmentation(img, smooth_image=smooth, threshold_gradient_image=thresh)
    b = st.tl.LiveWireSegmentation(img, smooth_image=smooth, threshold_gradient_image=thresh)
    assert np.array_equal(a.edges, b.edges) and (a._graph != b._graph).nnz == 0
    for s, e in (((2, 20), (37, 20)), ((13, 2), (30, 35))):
        assert a.compute_shortest_path(s, e) == b.compute_shortest_path(s, e)
    assert stt.tl.compute_shortest_path(img, (2, 20), (37, 20)) == st.tl.compute_shortest_path(img, (2, 20), (37, 20))


def test_roi_matches_jax():
    from spateo_tpu.tools import roi as JR
    from spateo_tpu_torch.tools import roi as TR

    bounds = [np.array([(5, 5), (5, 35), (35, 35), (35, 5)]), np.array([(10, 10), (10, 20), (20, 20), (20, 10)])]
    assert np.array_equal(TR.img_segmentation(np.zeros((40, 40)), bounds),
                          JR.img_segmentation(np.zeros((40, 40)), bounds))
    a, b = TR.ROIAnnotator(np.zeros((40, 40))), JR.ROIAnnotator(np.zeros((40, 40)))
    for r in (a, b):
        for bd in bounds:
            r.add_boundary([tuple(p) for p in bd])
    assert np.array_equal(a.fill_regions(), b.fill_regions())
    assert all(np.array_equal(x, y) for x, y in zip(a.region_masks(), b.region_masks()))
    TR.draw_init(np.zeros((30, 30)))
    JR.draw_init(np.zeros((30, 30)))
    for mod in (TR, JR):
        mod.line_mode(3, 3), mod.line_mode(3, 25), mod.line_mode(25, 25), mod.line_mode(25, 3)
        mod.add_contours()
    assert np.array_equal(TR.mask_fill(), JR.mask_fill())
    assert np.array_equal(TR.fill_mask_color(), JR.fill_mask_color())


def test_auxseg_matches_jax():
    from spateo_tpu.preprocessing import auxseg as JA
    from spateo_tpu_torch.preprocessing import auxseg as TA

    img = _valley()
    a, b = TA.LiveWireSegmentation(img), JA.LiveWireSegmentation(img)
    assert np.array_equal(a.compute_shortest_path((2, 20), (37, 20)), b.compute_shortest_path((2, 20), (37, 20)))
    assert np.array_equal(TA.LiveWireSegmentation.LineDDA((0, 0), (7, 3)), JA.LiveWireSegmentation.LineDDA((0, 0),
                                                                                                          (7, 3)))
    ring = np.array([(2, 2), (2, 3), (2, 4), (3, 4), (4, 4), (4, 3), (4, 2), (3, 2)])
    assert np.array_equal(TA.LiveWireSegmentation.fill_contours(ring), JA.LiveWireSegmentation.fill_contours(ring))
    assert TA.compute_shortest_path is stt.tl.compute_shortest_path
