"""The port's neighbour graphs, spatial clustering, UMAP, Moran's I of cell
bins and the two-group CCI test (`stt.tl`) against the JAX package on the
CPU; scikit-learn is imported here only, as the reference of what the JAX
package calls.

Bars:

- `knn`, `neighbors`, `construct_nn_graph`, `spatial_adj` on untied points:
  indices and connectivities equal, distances to 1e-12 of scale (measured
  0: the same difference form); on a lattice, where scikit-learn's trees
  order equal distances their own way, the port orders them by index:
  distances equal, and every row whose indices differ ties at its k-th
  distance (pinned: 44 of 100 rows at k 6).
- `scc` (Louvain and Leiden), `mclust_py` (all four covariance types),
  `kmeans_clustering`, `cellbin_morani`, the SpaGCN host helpers: equal.
- `ops.gmm.GaussianMixture` against scikit-learn's: means and covariances to
  1e-10 of scale (measured 1.1e-14), `n_iter_` and labels equal.
- `ecp_silhouette` against scikit-learn's `silhouette_score`: 1e-10
  (measured 0).
- GC-DEC (`simple_GC_DEC`) from `core.bridge.gc_dec_from_reference`: the
  soft assignment given the same W and mu to 1e-6, and the fit from the same
  W (both k-means initialisations equal) to q within 1e-4 with equal
  labels; torch's SGD with momentum 0.9 against optax's on the same
  gradients: equal to 1e-7.
- `spagcn_pyg`: the length scale l equal to the JAX package's float64
  bisection to 1e-12, labels equal.
- UMAP: the kNN, sigma and rho, the graph, a and b equal; the layout after 3
  epochs from the same spectral init (ARPACK's start vector fixed for both by
  a test-local `eigsh` wrapper) and the JAX package's own negatives, to 1e-3
  of scale (measured 1.8e-4: `index_add_` and XLA's scatter add the same
  terms in another order and the layout is chaotic); after all epochs, with
  the port's own negatives, 15-NN preservation within 0.05 of the JAX
  package's (measured 0.023).
- `find_cci_two_group`: cell pairs and subclusters equal, scores to 1e-6
  relative, p-values equal but where a null score lies within 1e-5 of the
  observed one (counted; 0 here).
"""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse.linalg as sla
import torch

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.tools import dimensionality_reduction as JD
from spateo_tpu.tools.cluster import spagcn_utils as JS
from spateo_tpu_torch.core.bridge import adata_from_reference, gc_dec_from_reference
from spateo_tpu_torch.ops.gmm import GaussianMixture
from spateo_tpu_torch.tools import dimensionality_reduction as TD
from spateo_tpu_torch.tools.cluster import spagcn_utils as TS
from spateo_tpu_torch.tools.find_neighbors import knn

DIST_TOL, GMM_TOL, SIL_TOL = 1e-12, 1e-10, 1e-10
GCDEC_Q_TOL, SGD_TOL, L_TOL = 1e-4, 1e-7, 1e-12
UMAP_EPOCH_TOL, UMAP_PRES_TOL = 1e-3, 0.05
CCI_SCORE_TOL, CCI_TIE_TOL = 1e-6, 1e-5


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


def _section(n=300, g=40, seed=0):
    """A JAX package AnnData of `n` cells in 3 horizontal bands (6 genes and
    3 principal components planted by band) and the port's copy."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 10, (n, 2))
    band = (coords[:, 1] // (10 / 3)).astype(int)
    X = rng.poisson(1.0, (n, g)).astype(np.float32)
    X[:, :6] += (band[:, None] == np.arange(6)[None] % 3) * rng.poisson(4, (n, 6))
    aj = st.AnnData(X=X, obs=pd.DataFrame({"band": band.astype(str)}, index=[f"c{i}" for i in range(n)]),
                    var=pd.DataFrame(index=[f"g{i}" for i in range(g)]))
    st.SKM.init_adata_type(aj, "UMI")
    aj.obsm["spatial"] = coords
    pcs = np.random.default_rng(seed + 1).normal(size=(n, 10))
    pcs[:, :3] += band[:, None] * 2
    aj.obsm["X_pca"] = pcs
    return aj, adata_from_reference(aj)


# -- neighbour graphs ------------------------------------------------------------------------------


@pytest.mark.parametrize("basis,k", [("pca", 8), ("spatial", 6), ("pca", 30)])
def test_neighbors_match_jax(basis, k):
    aj, at = _section()
    cj, _ = st.tl.neighbors(aj, basis=basis, n_neighbors=k)
    ct, _ = stt.tl.neighbors(at, basis=basis, n_neighbors=k, device="cpu")
    pre = "spatial_" if basis == "spatial" else "expression_"
    assert (cj != ct).nnz == 0
    dj, dt = aj.obsp[pre + "distances"], at.obsp[pre + "distances"]
    assert np.array_equal(dj.indices, dt.indices) and np.array_equal(dj.indptr, dt.indptr)
    assert np.abs(dj.data - dt.data).max() <= DIST_TOL * dj.data.max()
    np.testing.assert_array_equal(at.uns[pre + "neighbors"]["indices"], aj.uns[pre + "neighbors"]["indices"])
    assert at.uns[pre + "neighbors"]["params"] == aj.uns[pre + "neighbors"]["params"]


@pytest.mark.parametrize("exclude_self,sym", [(True, False), (True, True), (False, False)])
def test_construct_nn_graph_matches_jax(exclude_self, sym):
    aj, at = _section()
    st.tl.construct_nn_graph(aj, n_neighbors=7, exclude_self=exclude_self, make_symmetrical=sym, save_id="nid")
    stt.tl.construct_nn_graph(at, n_neighbors=7, exclude_self=exclude_self, make_symmetrical=sym, save_id="nid",
                              device="cpu")
    assert (aj.obsp["adj"] != at.obsp["adj"]).nnz == 0
    np.testing.assert_array_equal(aj.obs["nid"], at.obs["nid"])


def test_knn_ties_on_a_lattice_ordered_by_index():
    """On a 10 x 10 integer lattice (ties everywhere) the port's rows are
    sorted by (distance, index), the distances equal scikit-learn's, and
    each row whose indices differ from scikit-learn's ties at its k-th
    distance; 44 of the 100 rows differ."""
    from sklearn.neighbors import NearestNeighbors

    P = np.stack(np.meshgrid(np.arange(10.0), np.arange(10.0)), -1).reshape(-1, 2)
    idx, dist = knn(P, 6, device="cpu")
    D = np.sqrt(((P[:, None] - P[None]) ** 2).sum(-1))
    ref = np.stack([np.lexsort((np.arange(100), D[i]))[:6] for i in range(100)])
    np.testing.assert_array_equal(idx, ref)
    sd, si = NearestNeighbors(n_neighbors=6).fit(P).kneighbors(P)
    np.testing.assert_array_equal(dist, sd)
    differ = (np.sort(idx, 1) != np.sort(si, 1)).any(1)
    kth = dist[:, -1]
    assert all(((D[i] == kth[i]).sum() > (dist[i] == kth[i]).sum()) for i in np.flatnonzero(differ))
    assert int(differ.sum()) == 44


def test_knn_untied_matches_sklearn_and_other_metrics():
    from scipy.spatial.distance import cdist
    from sklearn.neighbors import NearestNeighbors

    X = np.random.default_rng(3).normal(size=(400, 30))
    idx, dist = knn(X, 12, device="cpu")
    sd, si = NearestNeighbors(n_neighbors=12, algorithm="ball_tree").fit(X).kneighbors(X)
    np.testing.assert_array_equal(idx, si)
    assert np.abs(dist - sd).max() <= DIST_TOL * sd.max()
    assert (idx[:, 0] == np.arange(400)).all() and (dist[:, 0] == 0).all()
    im, dm = knn(X, 5, device="cpu", metric="cityblock")
    D = cdist(X, X, "cityblock")
    np.testing.assert_array_equal(dm, np.sort(D, 1)[:, :5])


def test_find_neighbors_helpers_match_jax():
    from spateo_tpu.tools import find_neighbors as JF
    from spateo_tpu_torch.tools import find_neighbors as TF

    aj, at = _section(120)
    rng = np.random.default_rng(4)
    adj = rng.uniform(size=(30, 30))
    np.testing.assert_array_equal(TF.normalize_adj(adj), JF.normalize_adj(adj))
    for a, b in zip(TF.adj_to_knn(adj, 5), JF.adj_to_knn(adj, 5)):
        np.testing.assert_array_equal(a, b)
    i, w = JF.adj_to_knn(adj, 5)
    assert (TF.knn_to_adj(i, w) != JF.knn_to_adj(i, w)).nnz == 0
    b = rng.integers(0, 2, (30, 12))
    np.testing.assert_array_equal(TF.jaccard_index(b[0], b), JF.jaccard_index(b[0], b))
    np.testing.assert_array_equal(TF.calculate_affinity(adj[:, :3]), JF.calculate_affinity(adj[:, :3]))
    assert TF.find_bw_for_n_neighbors(at, verbose=False) == JF.find_bw_for_n_neighbors(aj, verbose=False)
    tj = JF.find_threshold_distance(aj, coords_key="spatial", chunk_size=50)
    tt = TF.find_threshold_distance(at, coords_key="spatial", chunk_size=50, device="cpu")
    assert abs(tj - tt) <= 1e-5 * tj
    X = aj.obsm["spatial"]
    cj = JF.calculate_distances_chunk(X[:10], 0, X, metric="cityblock")
    np.testing.assert_array_equal(TF.calculate_distances_chunk(X[:10], 0, X, metric="cityblock", device="cpu"), cj)
    ej = JF.calculate_distances_chunk(X[:10], 0, X)
    # float32 matmul form: near a zero distance either package's value is the
    # square root of a cancellation residual, up to sqrt(eps32) |x| apart
    cancel = np.sqrt(np.finfo(np.float32).eps) * np.abs(X).max()
    assert np.abs(TF.calculate_distances_chunk(X[:10], 0, X, device="cpu") - ej).max() <= 1e-5 * ej.max() + cancel
    for a, b in zip(TF.compute_distances_and_connectivities(i, w), JF.compute_distances_and_connectivities(i, w)):
        assert (a != b).nnz == 0


def test_spatial_adj_matches_jax():
    aj, at = _section()
    assert (st.tl.spatial_adj(aj, e_neigh=10, s_neigh=6) != stt.tl.spatial_adj(at, e_neigh=10, s_neigh=6,
                                                                                device="cpu")).nnz == 0


# -- clustering ------------------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["louvain", "leiden"])
def test_scc_matches_jax(method):
    aj, at = _section()
    st.tl.scc(aj, e_neigh=10, s_neigh=6, cluster_method=method)
    stt.tl.scc(at, e_neigh=10, s_neigh=6, cluster_method=method, device="cpu")
    np.testing.assert_array_equal(at.obs["scc"], aj.obs["scc"])
    assert aj.obs["scc"].nunique() >= 3


@pytest.mark.parametrize("model", ["EEE", "VVV", "EEV", "VVI"])
def test_mclust_py_matches_jax(model):
    aj, at = _section()
    st.tl.mclust_py(aj, n_components=3, modelNames=model)
    stt.tl.mclust_py(at, n_components=3, modelNames=model, device="cpu")
    np.testing.assert_array_equal(at.obs["mclust"], aj.obs["mclust"])
    np.testing.assert_array_equal(at.obs["gmm_cluster"], aj.obs["gmm_cluster"])


@pytest.mark.parametrize("cov", ["full", "tied", "diag", "spherical"])
def test_gaussian_mixture_matches_sklearn(cov):
    from sklearn.mixture import GaussianMixture as SkGM

    rng = np.random.default_rng(0)
    X = np.r_[rng.normal(0, 1, (100, 4)), rng.normal(3, 1, (100, 4)), rng.normal([0, 4, 0, 0], 0.5, (100, 4))]
    ref = SkGM(3, covariance_type=cov, random_state=42).fit(X)
    out = GaussianMixture(3, cov, random_state=42, device="cpu").fit(X)
    for a in ("means_", "covariances_", "weights_", "precisions_cholesky_"):
        r = getattr(ref, a)
        assert np.abs(getattr(out, a) - r).max() <= GMM_TOL * np.abs(r).max(), a
    assert out.n_iter_ == ref.n_iter_ and out.converged_ == ref.converged_
    assert abs(out.lower_bound_ - ref.lower_bound_) <= GMM_TOL * abs(ref.lower_bound_)
    np.testing.assert_array_equal(out.predict(X), ref.predict(X))
    with pytest.raises(ValueError, match="covariance_type"):
        GaussianMixture(3, "EEE", device="cpu")


def test_ecp_silhouette_matches_sklearn():
    from sklearn.metrics import silhouette_score

    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 5))
    lab = rng.integers(0, 4, 300)
    lab[7] = 9  # a cluster of one scores 0
    assert abs(stt.tl.ecp_silhouette(X, lab, device="cpu") - silhouette_score(X, lab)) <= SIL_TOL
    assert stt.tl.ecp_silhouette(X, lab, device="cpu") == pytest.approx(st.tl.ecp_silhouette(X, lab), abs=SIL_TOL)
    with pytest.raises(ValueError, match="Number of labels"):
        stt.tl.ecp_silhouette(X, np.zeros(300), device="cpu")


def test_kmeans_clustering_and_pca_helpers_match_jax():
    aj, at = _section()
    st.tl.kmeans_clustering(aj, 3)
    stt.tl.kmeans_clustering(at, 3, device="cpu")
    np.testing.assert_array_equal(at.obs["kmeans_clusters"], aj.obs["kmeans_clusters"])
    pj, nj, rj = st.tl.compute_pca_components(np.asarray(aj.X))
    pt, nt, rt = stt.tl.compute_pca_components(np.asarray(at.X), device="cpu")
    assert (nj, rj) == (nt, rt)
    sign = np.sign((pj[:, :nj] * pt[:, :nj]).sum(0))
    assert np.abs(pt[:, :nj] * sign - pj[:, :nj]).max() <= 1e-3 * np.abs(pj).max()
    st.tl.pca_spateo(aj, n_pca_components=5, pca_key="p5")
    stt.tl.pca_spateo(at, n_pca_components=5, pca_key="p5", device="cpu")
    assert at.obsm["p5"].shape == aj.obsm["p5"].shape == (300, 5)
    st.tl.pearson_residuals(aj, n_top_genes=10)
    stt.tl.pearson_residuals(at, n_top_genes=10)
    np.testing.assert_array_equal(at.obsm["pearson_residuals"], aj.obsm["pearson_residuals"])
    np.testing.assert_array_equal(at.var["highly_variable"], aj.var["highly_variable"])
    oj, ot = st.tl.integrate([aj.copy(), aj.copy()]), stt.tl.integrate([at.copy(), at.copy()])
    assert ot.shape == oj.shape and list(ot.obs["slices"]) == list(oj.obs["slices"])


def test_refusals_cite_their_items():
    """`CAST` and `pySTAGATE.train`, which raised until the external models
    were ported, now train (their parity with the JAX package is in
    `tests/test_torch_external.py`); t-SNE, which raised until it was ported,
    is held to scikit-learn in `tests/test_torch_tsne.py`. An unknown method
    raises."""
    _, at = _section(50)
    with pytest.raises(ValueError, match="Unknown reduction_method"):
        stt.tl.perform_dimensionality_reduction(at, reduction_method="pacmap", device="cpu")
    stt.tl.CAST(at, n_epochs=2, d_hidden=8, d_out=4, device="cpu")
    assert at.obsm["X_cast"].shape == (50, 4)
    stt.tl.pySTAGATE(at, num_epoch=2, hidden_dims=[8, 2], rad_cutoff=1e9, device="cpu").train()
    assert at.obsm["STAGATE"].shape == (50, 2)


def test_pystagate_cal_psm_on_a_given_embedding():
    """`cal_pSM` on an embedding already in .obsm['STAGATE']: the port's kNN
    graph gives the JAX package's pseudo-spatial map
    (its Fiedler vector up to sign)."""
    aj, at = _section(200)
    emb = np.random.default_rng(5).normal(size=(200, 4))
    emb[:, 0] += np.asarray(aj.obsm["spatial"])[:, 1]
    aj.obsm["STAGATE"] = at.obsm["STAGATE"] = emb
    pj = st.tl.pySTAGATE(aj)
    pj._trained = True
    a = pj.cal_pSM(n_neighbors=10)
    b = stt.tl.pySTAGATE(at, device="cpu").cal_pSM(n_neighbors=10)
    assert min(np.abs(a - b).max(), np.abs(a - (1 - b)).max()) <= 1e-8


# -- SpaGCN -----------------------------------------------------------------------------------------


def test_spagcn_host_helpers_match_jax():
    rng = np.random.default_rng(0)
    x, y = rng.uniform(0, 10, 60), rng.uniform(0, 10, 60)
    adj = TS.calculate_adj_matrix(x, y)
    np.testing.assert_array_equal(adj, JS.calculate_adj_matrix(x, y))
    assert TS.calculate_p(adj, 2.0) == JS.calculate_p(adj, 2.0)
    assert TS.search_l(0.5, adj) == JS.search_l(0.5, adj)
    pred = rng.integers(0, 3, 60)
    assert TS.refine(np.arange(60), pred, adj, "hexagon") == JS.refine(np.arange(60), pred, adj, "hexagon")
    assert TS.get_cluster_num(pred) == JS.get_cluster_num(pred) == 3


def test_gc_dec_from_reference_and_fit_match_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    emb = rng.normal(size=(150, 8)).astype(np.float32)
    emb[:50, 0] += 3
    emb[50:100, 1] += 3
    A = np.exp(-rng.uniform(0, 4, (150, 150))).astype(np.float32)
    A /= A.sum(1, keepdims=True)
    mj = JS.simple_GC_DEC(8, 8)
    mt = gc_dec_from_reference(mj, device="cpu")
    mj.fit(emb, A, n_clusters=3, max_epochs=30, seed=1)
    mt.fit(emb, A, n_clusters=3, max_epochs=30, seed=1)
    qj, lj = mj.predict()
    qt, lt = mt.predict()
    assert np.abs(qj - qt).max() <= GCDEC_Q_TOL
    np.testing.assert_array_equal(lt, lj)
    # the soft assignment from the fitted JAX head's W and mu
    mt2 = gc_dec_from_reference(mj, device="cpu")
    with torch.no_grad():
        q2 = mt2.soft_assign(torch.from_numpy(emb), torch.from_numpy(A)).numpy()
    qj2 = np.asarray(mj._soft_assign(mj.params, jnp.asarray(emb), jnp.asarray(A)))
    assert np.abs(q2 - qj2).max() <= 1e-6


def test_torch_sgd_momentum_is_optax_sgd():
    """torch.optim.SGD(lr, momentum=0.9) and optax.sgd(lr, momentum=0.9)
    take the same steps on the same gradients."""
    import optax

    rng = np.random.default_rng(0)
    grads = rng.normal(size=(6, 5)).astype(np.float32)
    p0 = rng.normal(size=5).astype(np.float32)
    opt = optax.sgd(0.01, momentum=0.9)
    pj, state = p0.copy(), opt.init(p0)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    sgd = torch.optim.SGD([pt], lr=0.01, momentum=0.9)
    for g in grads:
        upd, state = opt.update(g, state)
        pj = np.asarray(optax.apply_updates(pj, upd))
        pt.grad = torch.from_numpy(g.copy())
        sgd.step()
    assert np.abs(pt.detach().numpy() - pj).max() <= SGD_TOL


def test_spagcn_pyg_matches_jax():
    """The length scale l against the JAX package's float64 bisection (its
    loop, replayed in numpy here: the JAX package does not return l), and
    the labels."""
    from scipy.spatial.distance import cdist

    from spateo_tpu_torch.tools.cluster.find_clusters import spagcn_adjacency

    aj, at = _section(200, 30)
    coords = np.asarray(aj.obsm["spatial"])
    D = cdist(coords, coords)
    lo, hi = 1e-3, float(D.max()) + 1e-6
    for _ in range(60):
        mid = (lo + hi) / 2
        if float(np.exp(-(D**2) / (2 * mid**2)).mean()) < 0.5:
            lo = mid
        else:
            hi = mid
    A, l = spagcn_adjacency(coords, device="cpu")
    assert abs(float(l) - (lo + hi) / 2) <= L_TOL * (lo + hi) / 2
    Aj = np.exp(-(D**2) / (2 * ((lo + hi) / 2) ** 2))
    assert A.dtype == torch.float32 and np.abs(A.numpy() - Aj / Aj.sum(1, keepdims=True)).max() <= 1e-7
    st.tl.spagcn_pyg(aj, n_clusters=3, seed=1, refine_shape="hexagon")
    stt.tl.spagcn_pyg(at, n_clusters=3, seed=1, refine_shape="hexagon", device="cpu")
    np.testing.assert_array_equal(at.obs["spagcn_pred"], aj.obs["spagcn_pred"])
    np.testing.assert_array_equal(at.obs["spagcn_pred_refined"], aj.obs["spagcn_pred_refined"])
    bj = st.tl.spagcn_vanilla(aj.copy(), n_clusters=3, key_added="sv", copy=True)
    bt = stt.tl.spagcn_vanilla(at.copy(), n_clusters=3, key_added="sv", copy=True, device="cpu")
    np.testing.assert_array_equal(bt.obs["sv"], bj.obs["sv"])


# -- UMAP ------------------------------------------------------------------------------------------


@pytest.fixture
def fixed_eigsh(monkeypatch):
    """ARPACK's start vector is not repeatable within a process: both
    packages' `eigsh` calls start from ones."""
    orig = sla.eigsh

    def eigsh(A, k=6, **kw):
        kw.setdefault("v0", np.ones(A.shape[0]))
        return orig(A, k=k, **kw)

    monkeypatch.setattr(sla, "eigsh", eigsh)


def _umap_data():
    rng = np.random.default_rng(0)
    return np.r_[rng.normal(0, 1, (150, 8)), rng.normal(4, 1, (150, 8))].astype(np.float32)


def test_umap_graph_and_first_epochs_match_jax(fixed_eigsh, monkeypatch):
    import jax
    import scipy.optimize as so

    X = _umap_data()
    fits = []
    orig_fit = so.curve_fit

    def curve_fit(*a, **kw):
        fits.append(orig_fit(*a, **kw)[0])
        return orig_fit(*a, **kw)

    monkeypatch.setattr(so, "curve_fit", curve_fit)
    gj, kij, kdj, ej = JD.umap_conn_indices_dist_embedding(X, n_neighbors=10, max_iter=3, return_mapper=False)
    key, negs = jax.random.PRNGKey(0), []
    for _ in range(3):
        key, sub = jax.random.split(key)
        negs.append(np.asarray(jax.random.randint(sub, (gj.nnz,), 0, len(X))))
    gt, kit, kdt, et = TD.umap_conn_indices_dist_embedding(X, n_neighbors=10, max_iter=3, return_mapper=False,
                                                           negatives=np.stack(negs), device="cpu")
    np.testing.assert_array_equal(kit, kij)
    np.testing.assert_array_equal(kdt, kdj)
    assert (gt != gj).nnz == 0
    np.testing.assert_array_equal(fits[0], fits[1])
    for a, b in zip(TD._smooth_knn(kdj, 10), JD._smooth_knn(kdj, 10)):
        np.testing.assert_array_equal(a, b)
    assert np.abs(et - ej).max() <= UMAP_EPOCH_TOL * np.abs(ej).max()


def test_umap_layout_structure_and_mapper_match_jax(fixed_eigsh):
    X = _umap_data()
    mj, *_, ej = JD.umap_conn_indices_dist_embedding(X, n_neighbors=10)
    mt, *_, et = TD.umap_conn_indices_dist_embedding(X, n_neighbors=10, device="cpu")
    pj, pt = TD.knn_preservation(X, ej, device="cpu"), TD.knn_preservation(X, et, device="cpu")
    assert abs(pj - pt) <= UMAP_PRES_TOL and pt > 0.3
    np.testing.assert_array_equal(mt.transform(X[:20] + 0.01), _FittedUMAP_from(mj, et).transform(X[:20] + 0.01))
    assert et.shape == (300, 2) and np.isfinite(et).all()


@pytest.mark.parametrize("k", [5, 15])
def test_knn_preservation_matches_the_host_kdtree(k):
    """`knn_preservation` takes X's neighbours from `find_neighbors.knn`; the
    JAX package's `find_optimal_n_umap_components` scores with a host cKDTree
    on both sides. On untied data the two give the same share."""
    from scipy.spatial import cKDTree

    X = _umap_data()
    emb = X[:, :2] + np.random.default_rng(1).normal(0, 0.5, (len(X), 2)).astype(np.float32)
    true_nbrs = cKDTree(X).query(X, k=k + 1)[1][:, 1:]
    emb_nbrs = cKDTree(emb).query(emb, k=k + 1)[1][:, 1:]
    ref = np.mean([len(set(a) & set(b)) / k for a, b in zip(true_nbrs, emb_nbrs)])
    got = TD.knn_preservation(X, emb, k, device="cpu")
    assert got == ref and 0.0 < got < 1.0


def _FittedUMAP_from(mj, emb):
    """The JAX package's mapper around the port's embedding."""
    return JD._FittedUMAP(mj.X_train_, emb, mj.n_neighbors)


def test_perform_dimensionality_reduction_and_optimal_components(fixed_eigsh):
    aj, at = _section(200)
    stt.tl.perform_dimensionality_reduction(at, n_pca_components=10, n_neighbors=15, max_iter=50, device="cpu")
    assert at.obsm["X_umap"].shape == (200, 2) and np.isfinite(at.obsm["X_umap"]).all()
    X = _umap_data()[::3]
    assert TD.find_optimal_n_umap_components(X, max_components=4, n_neighbors=10, device="cpu") in (2, 4)


# -- Moran's I of cell bins, the two-group CCI test --------------------------------------------------


def test_cellbin_morani_matches_jax():
    aj, at = _section(400)
    aj.obs["Celltype"] = at.obs["Celltype"] = aj.obs["band"]
    dj = st.tl.cellbin_morani(aj, binsize=1)
    dt = stt.tl.cellbin_morani(at, binsize=1)
    pd.testing.assert_frame_equal(dt, dj)


def _cci_pair(n=400, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 20, (n, 2))
    grp = np.where(coords[:, 0] < 10, "A", "B")
    X = rng.poisson(0.5, (n, 20)).astype(np.float32)
    names = [f"g{i}" for i in range(20)]
    names[0], names[10] = "TGFB1", "TGFBR1_TGFBR2"
    X[:, 0] += (grp == "A") * (coords[:, 0] > 8) * 3
    X[:, 10] += (grp == "B") * (coords[:, 0] < 12) * 3
    aj = st.AnnData(X=X, obs=pd.DataFrame({"cell_type": grp}, index=[f"c{i}" for i in range(n)]),
                    var=pd.DataFrame(index=names))
    st.SKM.init_adata_type(aj, "UMI")
    aj.obsm["spatial"] = coords
    return aj, adata_from_reference(aj)


@pytest.mark.parametrize("num,seed", [(200, 0), (50, 3)])
def test_find_cci_two_group_matches_jax(num, seed):
    """Scores to 1e-6 relative; p-values equal but where the port's own null
    (replayed with the JAX draws) puts a score within 1e-5 of the observed
    one, counted: 0 flips here."""
    from spateo_tpu_torch.tools.cci_two_cluster import permutation_null

    aj, at = _cci_pair(seed=seed)
    kw = dict(species="human", group="cell_type", sender_group="A", receiver_group="B", num=num, pvalue=1.1,
              min_pairs_ratio=1e-5, seed=seed)
    rj = st.tl.find_cci_two_group(aj, **kw)
    rt = stt.tl.find_cci_two_group(at, device="cpu", **kw)
    pd.testing.assert_frame_equal(rt["cell_pair"], rj["cell_pair"])
    np.testing.assert_array_equal(at.obs["cell_typesp"], aj.obs["cell_typesp"])
    lj, lt = rj["lr_pair"], rt["lr_pair"]
    assert list(lt["lr_pair"]) == list(lj["lr_pair"])
    np.testing.assert_array_equal(lt["lr_co_exp_num"], lj["lr_co_exp_num"])
    assert np.abs(lt["lr_score"].values - lj["lr_score"].values).max() <= CCI_SCORE_TOL * lj["lr_score"].abs().max()
    # the port's null from the JAX package's draws
    names = list(at.var_names)
    s = at.obs_names.get_indexer(rt["cell_pair"]["cell_sender"])
    r = at.obs_names.get_indexer(rt["cell_pair"]["cell_receiver"])
    rng = np.random.default_rng(seed)
    perm = np.array([[rng.choice(at.n_obs, len(s)), rng.choice(at.n_obs, len(s))] for _ in range(num)])
    lig = torch.from_numpy(np.asarray(at.X)[:, [names.index(f) for f in lt["from"]]].astype(np.float32))
    rec = torch.from_numpy(np.asarray(at.X)[:, [names.index(t) for t in lt["to"]]].astype(np.float32))
    null = permutation_null(lig, rec, torch.from_numpy(perm[:, 0]), torch.from_numpy(perm[:, 1])).numpy()
    near_tie = (np.abs(null - lt["lr_score"].values[None]) <= CCI_TIE_TOL * np.abs(null).max()).any(0)
    flips = lt["lr_value"].values != lj["lr_value"].values
    assert not (flips & ~near_tie).any() and int(flips.sum()) == 0
    pvals = ((null >= lt["lr_score"].values[None].astype(np.float32)).sum(0) + 1) / (num + 1)
    np.testing.assert_array_equal(pvals, lt["lr_value"].values)


def test_cci_helpers_match_jax():
    aj, at = _cci_pair()
    kw = dict(species="human", group="cell_type", sender_group="A", receiver_group="B", num=20, pvalue=1.1,
              min_pairs_ratio=1e-5)
    rj = st.tl.find_cci_two_group(aj, **kw)
    rt = stt.tl.find_cci_two_group(at, device="cpu", **kw)
    pj = st.tl.prepare_cci_cellpair_adata(aj.copy(), "A", "B", "cell_type", cci_dict=rj)
    pt = stt.tl.prepare_cci_cellpair_adata(at.copy(), "A", "B", "cell_type", cci_dict=rt)
    np.testing.assert_array_equal(pt.obs["spec"], pj.obs["spec"])
    df = pd.DataFrame({"m": [1.0, 2.0, 3.0], "p": [0.1, 0.2, 0.3], "lr": ["a-b", "a-b", "c-d"],
                       "sr": ["A-B", "B-A", "A-B"]})
    for k in ("means", "pvalues"):
        pd.testing.assert_frame_equal(stt.tl.prepare_cci_df(df, "m", "p", "lr", "sr")[k],
                                      st.tl.prepare_cci_df(df, "m", "p", "lr", "sr")[k])
    from spateo_tpu.tools.cci_two_cluster import _load_lr_network, calculate_group_pair_lr_pair as jg
    from spateo_tpu_torch.tools.cci_two_cluster import calculate_group_pair_lr_pair as tg

    net = _load_lr_network(None, "human")
    net = net[net["from"].isin(aj.var_names) & net["to"].isin(aj.var_names)]
    pd.testing.assert_frame_equal(tg(at, "cell_type", [("A", "B")], ["A", "B"], net),
                                  jg(aj, "cell_type", [("A", "B")], ["A", "B"], net))
