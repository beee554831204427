"""The port's Barnes-Hut t-SNE (`spateo_tpu_torch.tools._tsne`,
`stt.tl.perform_dimensionality_reduction(reduction_method="tsne")`) on the
CPU. The JAX package's t-SNE *is* scikit-learn's ``TSNE(n_components,
random_state=0)``, so each step is held against scikit-learn 1.9's own
functions on the same float32 inputs, and the whole path against
`st.tl.perform_dimensionality_reduction`. scikit-learn is imported here only.

Bars (one torch, BLAS and OpenMP thread, so scikit-learn's `sum_Q`, summed
across OpenMP threads, is repeatable):

- kNN: the neighbour sets of `kneighbors_graph()` (each point's own entry
  dropped), distances to 1e-12 of scale.
- P against `_joint_probabilities_nn` on the same distances: the same CSR
  pattern, values to `P_TOL` = 1e-12 relative (measured 1.6e-15).
- The tree against `_QuadTree`'s cells: the same (depth, size, leaf, centre)
  for every cell, barycentres to 1e-6 of scale (scikit-learn's are float32
  running means).
- The gradient and KL against `_kl_divergence_bh`, at angle 0.5 and 0.2, in
  2-D and 3-D, with planted duplicate points: to `GRAD_TOL` = 1e-5 of the
  gradient's scale (measured 8.2e-7), the KL to 1e-4 relative
  (scikit-learn sums it in float32).
- 10 iterations against `_gradient_descent(_kl_divergence_bh, ...)` from the
  same init: to `ITER_TOL` = 5e-4 of the positions' scale (measured 1.9e-4
  in 2-D, 8.5e-5 in 3-D).
- The PCA init against scikit-learn's PCA, signs included: to 1e-6 of scale.
- The whole path at 1,000 cells in four bands, from a JAX package AnnData
  carried over by `core.bridge.adata_from_reference`: 15-NN preservation
  within `PRES_TOL` = 0.01 of the JAX package's (measured 0.0041), the
  bands' ARI by k-means on both embeddings within `ARI_TOL` = 0.02 (measured
  0.0047); in 3-D at 300 cells against scikit-learn's `TSNE` within the
  same bars (measured 0.0047 and 0.0017).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu_torch.core.bridge import adata_from_reference
from spateo_tpu_torch.tools import _tsne as T
from spateo_tpu_torch.tools.dimensionality_reduction import knn_preservation

P_TOL, GRAD_TOL, KL_TOL, ITER_TOL, INIT_TOL = 1e-12, 1e-5, 1e-4, 5e-4, 1e-6
PRES_TOL, ARI_TOL = 0.01, 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch, and for numpy's BLAS and OpenMP."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _blobs(n=400, d=10, k=4, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(size=(n // k, d)) + 4 * i for i in range(k)])


def _sk_distances(X, k):
    from sklearn.neighbors import NearestNeighbors

    D = NearestNeighbors(n_neighbors=k).fit(X).kneighbors_graph(mode="distance")
    D.data **= 2
    D.sort_indices()
    return D


def _port_P(D):
    n = D.shape[0]
    k = D.nnz // n
    nb = torch.as_tensor(D.indices.reshape(n, k).astype(np.int64))
    return T.joint_probabilities_nn(nb, torch.as_tensor(D.data.reshape(n, k).astype(np.float32)), 30.0)


def _scaled(a, b):
    return float(np.abs(np.asarray(a, float) - np.asarray(b, float)).max() / np.abs(np.asarray(b, float)).max())


def _embedding(n, d, seed=1):
    """Positions at a late stage's scale, with planted duplicates: an exact
    one and one within the tree's 1e-6."""
    Y = (np.random.default_rng(seed).normal(size=(n, d)) * 5).astype(np.float32)
    Y[10] = Y[11]
    Y[12] = Y[11] + np.float32(5e-7)
    Y[40] = Y[41] - np.float32(2e-6)
    return Y


def test_knn_matches_sklearn_kneighbors_graph():
    X = _blobs()
    D = _sk_distances(X, 91)
    nb, sq = T.knn_sqdistances(X, 91, device="cpu")
    order = np.argsort(nb.numpy(), axis=1, kind="stable")
    n = len(X)
    assert np.array_equal(np.take_along_axis(nb.numpy(), order, 1), D.indices.reshape(n, 91))
    assert _scaled(np.take_along_axis(sq.numpy(), order, 1), D.data.reshape(n, 91)) <= 1e-6
    nb2, _ = T.knn_sqdistances(np.r_[X[:1], X[:1], X[:1], X[1:40]], 1, device="cpu")
    assert nb2[:3, 0].tolist() == [1, 0, 1]  # row 2 (its neighbours 0, 1 tie with it) drops the first


@pytest.mark.parametrize("perplexity", [30.0, 5.0, 12.5])
def test_P_matches_sklearn(perplexity):
    from sklearn.manifold import _t_sne as sk

    X = _blobs()
    k = min(len(X) - 1, int(3 * perplexity + 1))
    D = _sk_distances(X, k)
    ref = sk._joint_probabilities_nn(D.copy(), perplexity, 0).tocsr()
    ref.sort_indices()
    n = len(X)
    nb = torch.as_tensor(D.indices.reshape(n, k).astype(np.int64))
    P = T.joint_probabilities_nn(nb, torch.as_tensor(D.data.reshape(n, k).astype(np.float32)), perplexity)
    assert np.array_equal(np.repeat(np.arange(n), np.diff(ref.indptr)), P.rows.numpy())
    assert np.array_equal(ref.indices, P.cols.numpy())
    assert np.abs(P.values.numpy() / ref.data - 1).max() <= P_TOL


@pytest.mark.parametrize("d", [2, 3])
def test_tree_matches_sklearn_quad_tree(d):
    from sklearn.neighbors._quad_tree import _QuadTree

    Y = _embedding(500, d)
    qt = _QuadTree(d, 0)
    qt.build_tree(Y)
    cells = qt.__getstate__()["cells"][: qt.cell_count]
    tree = T.build_tree(torch.as_tensor(Y))
    a = sorted(zip(cells["depth"], cells["cumulative_size"], cells["is_leaf"].astype(bool),
                   map(tuple, cells["center"][:, :d]), map(tuple, cells["barycenter"][:, :d])))
    b = sorted(zip(tree.depth.tolist(), tree.size.long().tolist(), tree.leaf.tolist(),
                   map(tuple, tree.center.numpy()), map(tuple, tree.barycenter.numpy())))
    assert [x[:4] for x in a] == [x[:4] for x in b]
    assert _scaled([x[4] for x in b], [x[4] for x in a]) <= 1e-6
    assert int(tree.size[0]) == len(Y) and int(tree.leaf.sum()) == len(Y) - 2  # two duplicates share leaves


@pytest.mark.parametrize("angle", [0.5, 0.2])
@pytest.mark.parametrize("d", [2, 3])
def test_gradient_matches_sklearn(d, angle):
    from sklearn.manifold import _t_sne as sk

    X = _blobs()
    D = _sk_distances(X, 91)
    ref_P = sk._joint_probabilities_nn(D.copy(), 30.0, 0).tocsr()
    P = _port_P(D)
    n, dof = len(X), max(d - 1, 1)
    Y = _embedding(n, d)
    err_ref, g_ref = sk._kl_divergence_bh(Y.ravel().copy(), ref_P, dof, n, d, angle=angle, num_threads=1)
    err, g = T.kl_divergence_bh(torch.as_tensor(Y), P, P.values.to(torch.float32), dof, angle)
    assert _scaled(g.numpy(), g_ref.reshape(n, d)) <= GRAD_TOL
    assert abs(float(err) / err_ref - 1) <= KL_TOL
    err2, g2 = T.kl_divergence_bh(torch.as_tensor(Y), P, P.values.to(torch.float32), dof, angle, compute_error=False)
    assert err2 is None and torch.equal(g2, g)


@pytest.mark.parametrize("d", [2, 3])
def test_pca_init_and_ten_iterations_match_sklearn(d):
    from sklearn.decomposition import PCA
    from sklearn.manifold import _t_sne as sk

    X = _blobs()
    n, dof = len(X), max(d - 1, 1)
    ref = PCA(n_components=d, random_state=np.random.RandomState(0)).fit_transform(X).astype(np.float32)
    ref = ref / np.std(ref[:, 0]) * 1e-4
    Y0 = T.TSNE(n_components=d, device="cpu").initial_embedding(X)
    assert _scaled(Y0.numpy(), ref) <= INIT_TOL
    D = _sk_distances(X, 91)
    ref_P = sk._joint_probabilities_nn(D.copy(), 30.0, 0).tocsr()
    ref_P *= 12.0
    lr = np.maximum(n / 12.0 / 4, 50)
    p_ref, e_ref, i_ref = sk._gradient_descent(
        sk._kl_divergence_bh, ref.ravel().copy(), 0, 10, n_iter_check=5, momentum=0.5, learning_rate=lr,
        n_iter_without_progress=250, args=[ref_P, dof, n, d],
        kwargs=dict(angle=0.5, num_threads=1, verbose=0, skip_num_points=0))
    P = _port_P(D)
    val_P = (P.values * 12.0).to(torch.float32)
    reads = T.gradient_descent.host_reads
    p, e, i = T.gradient_descent(lambda y, ce: T.kl_divergence_bh(y, P, val_P, dof, 0.5, ce), torch.as_tensor(ref),
                                 0, 10, n_iter_check=5, momentum=0.5, learning_rate=lr, n_iter_without_progress=250)
    assert i == i_ref == 9 and T.gradient_descent.host_reads - reads == 2
    assert _scaled(p.numpy(), p_ref.reshape(n, d)) <= ITER_TOL
    assert abs(e / e_ref - 1) <= KL_TOL


def _four_bands(n=1000, seed=0):
    """A JAX package AnnData of `n` cells in four bands, planted in 3 of its
    30 principal components."""
    rng = np.random.default_rng(seed)
    band = rng.integers(0, 4, n)
    pcs = rng.normal(size=(n, 30))
    pcs[:, :3] += 3.0 * (band[:, None] == np.arange(3)) - 1.5 * (band[:, None] == 3)
    aj = st.AnnData(X=np.zeros((n, 5), np.float32),
                    obs=pd.DataFrame({"band": band.astype(str)}, index=[f"c{i}" for i in range(n)]))
    aj.obsm["X_pca"] = pcs
    return aj, band


def _ari(band, emb):
    from sklearn.cluster import KMeans
    from sklearn.metrics import adjusted_rand_score

    return adjusted_rand_score(band, KMeans(4, n_init=10, random_state=0).fit_predict(emb))


def test_tsne_path_matches_jax():
    aj, band = _four_bands()
    at = adata_from_reference(aj)
    st.tl.perform_dimensionality_reduction(aj, reduction_method="tsne")
    stt.tl.perform_dimensionality_reduction(at, reduction_method="tsne", device="cpu")
    ej, et = aj.obsm["X_tsne"], at.obsm["X_tsne"]
    assert et.shape == ej.shape == (1000, 2) and et.dtype == np.float32 and np.isfinite(et).all()
    X = aj.obsm["X_pca"]
    pj, pt = knn_preservation(X, ej, device="cpu"), knn_preservation(X, et, device="cpu")
    assert abs(pj - pt) <= PRES_TOL and pt > 0.2
    aj_, at_ = _ari(band, ej), _ari(band, et)
    assert abs(aj_ - at_) <= ARI_TOL and at_ > 0.8


def test_tsne_in_3d_matches_sklearn():
    """The estimator in 3-D (the octree, dof 2) at 300 cells and its 1,000
    iterations against scikit-learn's `TSNE`: the iteration count, 15-NN
    preservation within `PRES_TOL` (measured 0.0047) and the bands' ARI
    within `ARI_TOL` (measured 0.0017)."""
    from sklearn.manifold import TSNE

    aj, band = _four_bands(300, seed=2)
    X = aj.obsm["X_pca"]
    ref = TSNE(n_components=3, random_state=0).fit(X)
    est = T.TSNE(n_components=3, device="cpu")
    emb = est.fit_transform(X)
    assert emb.shape == (300, 3) and np.isfinite(emb).all() and est.learning_rate_ == 50
    assert est.n_iter_ == ref.n_iter_ == 999 and np.isfinite(est.kl_divergence_)
    pres = [knn_preservation(X, e, device="cpu") for e in (emb, ref.embedding_)]
    assert abs(pres[0] - pres[1]) <= PRES_TOL
    assert abs(_ari(band, emb) - _ari(band, ref.embedding_)) <= ARI_TOL


def test_refusals_match_sklearn():
    X = _blobs(40)
    with pytest.raises(ValueError, match="inferior to 4"):
        T.TSNE(n_components=4, device="cpu").fit_transform(X)
    with pytest.raises(ValueError, match="must be less than n_samples"):
        T.TSNE(device="cpu").fit_transform(X[:30])
