"""The port's external models (`spateo_tpu_torch.external`: CAST-Mark, the
CAST helpers, STAGATE and the MERFISHVI family), the scikit-learn
replacements they need, the weights carried over by `core.bridge`, and the
two `stt.tl` entry points they serve, against the JAX package on the CPU;
scikit-learn is imported here only, as the reference of what the JAX package
calls.

Bars:

- The radius graph (`find_neighbors.radius_neighbors`) against
  scikit-learn's `radius_neighbors`: the same neighbour sets and distances
  to 1e-12 on random points, and on a lattice at radii on its distances
  (``dist <= r``, scikit-learn's squared test); `knn` with query points
  against `kneighbors`: equal.
- `ops.gmm.GaussianMixture(n_init=3)` against scikit-learn's: labels and
  `n_iter_` equal, means and covariances to 1e-10 of scale;
  `ops.kmeans.KMeans` on a shared ``RandomState``: the labels of three fits
  in a row and the state left behind equal scikit-learn's.
- The CAST helpers (graphs, node merge, delta analysis, preprocessing): equal
  (the delta means to 1e-6: float32 products).
- CAST-Mark: the normalized graph equal bit for bit; the first 10 Adam steps
  of `_train_cast` from the JAX package's weights and replayed feature masks:
  losses to 1e-5 relative and weights to 1e-5 of scale (measured 4.9e-7 and
  3.7e-7; torch and optax Adam round differently); `CAST_MARK` and `tl.CAST`
  end to end on the same draws, 10 epochs: the embeddings to 1e-4 of scale
  (measured 1.8e-6).
- STAGATE: the init equal bit for bit (numpy's `default_rng` in both); the
  first 10 Adam steps: losses to 1e-5 relative (measured 1.0e-6), the
  weights to 1e-5 of scale (measured 3.7e-7), but for the source attention
  vectors of layers 2-4, whose logits lie on one side of the leaky ReLU so
  that their gradient is rounding noise that Adam scales to steps of about
  lr: those to 10 x lr x steps absolute (measured 1.1e-3); the latent to
  1e-5 of scale. `train_STAGATE` and `tl.pySTAGATE(...).train()` end to end,
  10 epochs at seed 0, where those vectors weigh more: the latent and the
  reconstruction to 2e-3 of scale (measured 5.2e-4). The graphs,
  `Batch_Data`, `Transfer_pytorch_Data`, `mclust_R`: equal.
- MERFISHVI `_train_vae`, 10 steps from the JAX package's weights with its
  normal draws and minibatches replayed (nb, zinb, poisson; minibatch;
  gene-batch; protein; the spatial encoder; the linear decoder; the
  smoothness penalty): losses to 1e-5 relative (measured 7.7e-7), weights to
  1e-6 absolute (measured 7.9e-8: they moved by about 1e-2), the latent to
  1e-5 of scale. The VAE family: forwards from carried weights to 1e-6 of
  scale (the spatial features, of size 1e-3, to 1e-6 absolute); 10 Adam
  steps with replayed draws as MERFISHVI's.
- The likelihood helpers: 1e-6 relative.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.external import cast as JC
from spateo_tpu.external import cast_utils as JU
from spateo_tpu.external import merfishvi as JM
from spateo_tpu.external import merfishvi_modules as JMM
from spateo_tpu.external import stagate as JG
from spateo_tpu_torch.core.bridge import (
    adata_from_reference,
    cast_params_from_reference,
    merfishvi_params_from_reference,
    stagate_params_from_reference,
)
from spateo_tpu_torch.external import cast as TC
from spateo_tpu_torch.external import cast_utils as TU
from spateo_tpu_torch.external import merfishvi as TM
from spateo_tpu_torch.external import merfishvi_modules as TMM
from spateo_tpu_torch.external import stagate as TG

REPO = Path(__file__).resolve().parents[1]
DIST_TOL, GMM_TOL, DELTA_TOL = 1e-12, 1e-10, 1e-6
LOSS_TOL, W_TOL, E2E_TOL, FWD_TOL = 1e-5, 1e-5, 1e-4, 1e-6
VAE_W_ABS, LIK_TOL, STEPS, LR, STAGATE_E2E_TOL = 1e-6, 1e-6, 10, 1e-3, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch, and for numpy's BLAS and OpenMP: the
    tier-1 run shares the CPU among its workers."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _scale_err(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    """{path: array} of a nested dict / list."""
    if isinstance(tree, dict):
        return {k2: v for k in tree for k2, v in _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, t in enumerate(tree) for k2, v in _flat(t, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree, float)}


# -- scikit-learn's replacements ---------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "lattice"])
def test_radius_neighbors_match_sklearn(case):
    from sklearn.neighbors import NearestNeighbors

    from spateo_tpu_torch.tools.find_neighbors import radius_neighbors, radius_neighbors_graph

    rng = np.random.default_rng(0)
    if case == "random":
        X = rng.uniform(0, 10, (150, 2))
        radii = (0.7, 1.5)
    else:
        X = np.stack(np.meshgrid(np.arange(10.0), np.arange(10.0)), -1).reshape(-1, 2) * 0.3
        radii = (0.3, 0.3 * np.sqrt(2), 0.6)  # on the lattice's own distances
    nn = NearestNeighbors().fit(X)
    for r in radii:
        dist, ind = nn.radius_neighbors(X, radius=r)
        indptr, cols, d = radius_neighbors(X, r, device="cpu")
        for i in range(len(X)):
            o = np.argsort(ind[i])
            np.testing.assert_array_equal(cols[indptr[i]:indptr[i + 1]], ind[i][o])
            assert np.abs(d[indptr[i]:indptr[i + 1]] - dist[i][o]).max(initial=0) <= DIST_TOL
        G = radius_neighbors_graph(X, r, device="cpu")
        assert (G != nn.radius_neighbors_graph(X, radius=r)).nnz == 0


def test_knn_with_queries_matches_sklearn():
    from sklearn.neighbors import NearestNeighbors

    from spateo_tpu_torch.tools.find_neighbors import knn

    rng = np.random.default_rng(1)
    X, Y = rng.normal(size=(80, 3)), rng.normal(size=(30, 3))
    d, i = NearestNeighbors(n_neighbors=4).fit(X).kneighbors(Y)
    it, dt = knn(X, 4, device="cpu", Y=Y)
    np.testing.assert_array_equal(it, i)
    assert np.abs(dt - d).max() <= DIST_TOL
    np.testing.assert_array_equal(TU.nearest_neighbors_idx(X, Y, device="cpu"), JU.nearest_neighbors_idx(X, Y))


@pytest.mark.parametrize("cov", ["full", "tied", "diag", "spherical"])
def test_gaussian_mixture_n_init_matches_sklearn(cov):
    from sklearn.mixture import GaussianMixture as SkGM

    from spateo_tpu_torch.ops.gmm import GaussianMixture

    rng = np.random.default_rng(3)
    X = np.r_[rng.normal(0, 1, (60, 3)), rng.normal(3, 1.5, (60, 3)), rng.normal([0, 5, 0], 0.7, (60, 3))]
    sk = SkGM(3, covariance_type=cov, random_state=2020, n_init=3)
    ls = sk.fit_predict(X)
    gm = GaussianMixture(3, cov, random_state=2020, n_init=3, device="cpu")
    np.testing.assert_array_equal(gm.fit_predict(X), ls)
    assert gm.n_iter_ == sk.n_iter_ and gm.converged_ == sk.converged_
    assert _scale_err(sk.means_, gm.means_) <= GMM_TOL
    assert _scale_err(sk.covariances_, gm.covariances_) <= GMM_TOL
    assert abs(gm.lower_bound_ - sk.lower_bound_) <= GMM_TOL * abs(sk.lower_bound_)


def test_kmeans_on_a_shared_random_state_matches_sklearn():
    from sklearn.cluster import KMeans as SkKMeans

    from spateo_tpu_torch.ops.kmeans import KMeans

    X = np.random.default_rng(4).normal(size=(200, 4))
    rs_sk, rs_port = np.random.RandomState(7), np.random.RandomState(7)
    for k in (3, 5, 4):
        a = SkKMeans(k, n_init=1, random_state=rs_sk).fit(X).labels_
        b = KMeans(k, n_init=1, random_state=rs_port, device="cpu").fit(X).labels_
        np.testing.assert_array_equal(b, a)
    assert rs_sk.randint(1 << 30) == rs_port.randint(1 << 30)


# -- the CAST helpers ----------------------------------------------------------------


def test_cast_graph_and_node_merge_equal():
    rng = np.random.default_rng(2)
    ct = rng.normal(size=(200, 2)) * 50
    for strat in ("delaunay", "convex"):
        a = JU.coords2adjacentmat(ct, output_mode="adjacent_sparse", strategy_t=strat)
        b = TU.coords2adjacentmat(ct, output_mode="adjacent_sparse", strategy_t=strat)
        assert (a != b).nnz == 0
    exp = rng.poisson(2.0, (200, 8)).astype(float)
    ea, ia = JU.sub_node_sum(ct, exp, nodenum=40, vis=False)
    eb, ib = TU.sub_node_sum(ct, exp, nodenum=40, vis=False, device="cpu")
    np.testing.assert_array_equal(ib, ia)
    np.testing.assert_array_equal(eb.toarray(), ea.toarray())
    ca, xa, _ = JU.sub_data_extract(["s"], {"s": ct}, {"s": exp}, nodenum_t=50)
    cb, xb, _ = TU.sub_data_extract(["s"], {"s": ct}, {"s": exp}, nodenum_t=50, device="cpu")
    np.testing.assert_array_equal(cb["s"], ca["s"])
    np.testing.assert_array_equal(xb["s"], xa["s"])
    np.testing.assert_array_equal(TU.non_zero_center_scale(exp), JU.non_zero_center_scale(exp))
    np.testing.assert_array_equal(TU.random_sample(ct, 30), JU.random_sample(ct, 30))
    assert TU.hv_cutoff(exp.max(0), 4) == JU.hv_cutoff(exp.max(0), 4)
    with pytest.raises(ImportError, match="harmonypy"):
        TU.Harmony_integration()


def test_cast_delta_analysis_equal():
    rng = np.random.default_rng(0)
    ct = rng.normal(size=(120, 2)) * 50
    cr = rng.normal(size=(150, 2)) * 50 + 5
    ta, tb = rng.choice(["A", "B", "C"], 120), rng.choice(["A", "B", "C"], 150)
    for x, y in zip(JU.delta_cell_cal(ct, cr, ta, tb, 30.0), TU.delta_cell_cal(ct, cr, ta, tb, 30.0, device="cpu")):
        pd.testing.assert_frame_equal(y, x)
    et, er = rng.poisson(2.0, (120, 6)).astype(float), rng.poisson(2.0, (150, 6)).astype(float)
    for x, y in zip(JU.delta_exp_cal(ct, cr, et, er, 25.0), TU.delta_exp_cal(ct, cr, et, er, 25.0, device="cpu")):
        assert np.abs(x - y).max() <= DELTA_TOL
    np.testing.assert_array_equal(TU.get_neighborhood_rad(ct, cr, 30.0, device="cpu"),
                                  JU.get_neighborhood_rad(ct, cr, 30.0))
    d = TU.delta_exp_cal(ct, cr, et, er, 25.0, device="cpu")
    pa, aa = JU.delta_exp_statistics(d[0], d[1])
    pb, ab = TU.delta_exp_statistics(d[0], d[1])
    assert pa == pb and aa == ab


def test_cast_preprocessing_equal():
    rng = np.random.default_rng(2)
    X = rng.poisson(1.5, (80, 30)).astype(np.float32)
    aj = st.AnnData(X=X.copy())
    aj.obs["batch"] = np.repeat(["s1", "s2"], 40)
    aj.obsm["spatial"] = rng.normal(size=(80, 2))
    at = adata_from_reference(aj)
    np.testing.assert_array_equal(
        TU.detect_highly_variable_genes(at, batch_key="batch", n_top_genes=10, count_layer=".X"),
        JU.detect_highly_variable_genes(aj, batch_key="batch", n_top_genes=10, count_layer=".X"))
    cj, ej = JU.extract_coords_exp(aj, batch_key="batch", count_layer=".X", data_format="log2_norm1e4")
    ctt, ett = TU.extract_coords_exp(at, batch_key="batch", count_layer=".X", data_format="log2_norm1e4")
    for s in ("s1", "s2"):
        np.testing.assert_array_equal(ctt[s], cj[s])
        np.testing.assert_allclose(ett[s], ej[s], rtol=1e-6, atol=1e-6)
    pj = JU.preprocess_fast(st.AnnData(X=X.copy()), mode="customized", regressout=True)
    pt = TU.preprocess_fast(stt.AnnData(X=X.copy()), mode="customized", regressout=True)
    for k in ("raw", "norm1e4", "log2_norm1e4", "log2_norm1e4_scaled"):
        a, b = pj.layers[k], pt.layers[k]
        a, b = (m.toarray() if hasattr(m, "toarray") else np.asarray(m) for m in (a, b))
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


# -- CAST-Mark -----------------------------------------------------------------------


def _cast_masks(seed, n_epochs, F, p=0.2):
    """The JAX package's per-epoch feature masks, by replaying
    `_train_cast`'s key splits: [n_epochs, 2, F]."""
    import jax

    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        views = []
        for k in jax.random.split(sub):
            views.append(np.asarray(jax.random.bernoulli(jax.random.split(k)[0], 1 - p, (1, F)))[0])
        out.append(views)
    return np.array(out)


@pytest.fixture(scope="module")
def mark_case():
    rng = np.random.default_rng(0)
    n, G = 150, 24
    coords = rng.uniform(0, 10, (n, 2))
    X = rng.poisson(3, (n, G)).astype(np.float32)
    X[coords[:, 0] > 5, :10] += rng.poisson(5, ((coords[:, 0] > 5).sum(), 10))
    return coords, X


def test_cast_norm_adj_equal(mark_case):
    coords, _ = mark_case
    for k in (5, 10):
        np.testing.assert_array_equal(TC._norm_adj(coords, k, "cpu").numpy(),
                                      JC._norm_adj(coords, k).astype(np.float32))


def test_train_cast_first_steps_match_jax(mark_case):
    import jax
    import jax.numpy as jnp

    coords, X = mark_case
    A = JC._norm_adj(coords, 10).astype(np.float32)
    key = jax.random.PRNGKey(3)
    pj = JC._init_params(key, X.shape[1], 32, 8)
    pj2, lj = JC._train_cast(pj, jnp.asarray(A), jnp.asarray(X), key, n_epochs=STEPS)
    pt2, lt = TC._train_cast(cast_params_from_reference(pj, "cpu"), _t(A), _t(X), n_epochs=STEPS,
                             masks=_t(_cast_masks(3, STEPS, X.shape[1])))
    assert _scale_err(lj, lt.numpy()) <= LOSS_TOL
    for k in pj2:
        assert _scale_err(pj2[k], pt2[k].numpy()) <= W_TOL, k


def test_cast_mark_and_tl_cast_end_to_end_match_jax(mark_case):
    import jax

    coords, X = mark_case
    init = JC._init_params(jax.random.PRNGKey(0), X.shape[1], 32, 8)
    masks = _cast_masks(0, STEPS, X.shape[1])
    ej = JC.CAST_MARK(coords, X, d_hidden=32, d_out=8, n_epochs=STEPS)
    et = TC.CAST_MARK(coords, X, d_hidden=32, d_out=8, n_epochs=STEPS, device="cpu", init_params=init, masks=masks)
    assert _scale_err(ej, et) <= E2E_TOL
    aj = st.AnnData(X=X.copy(), var=pd.DataFrame(index=[f"g{i}" for i in range(X.shape[1])]))
    aj.obsm["spatial"] = coords
    st.SKM.init_adata_type(aj, "UMI")
    at = adata_from_reference(aj)
    st.tl.CAST(aj, n_epochs=STEPS, d_hidden=32, d_out=8)
    F = min(50, X.shape[1] - 1)
    init = JC._init_params(jax.random.PRNGKey(0), F, 32, 8)
    stt.tl.CAST(at, n_epochs=STEPS, d_hidden=32, d_out=8, device="cpu", init_params=init,
                masks=_cast_masks(0, STEPS, F))
    assert _scale_err(aj.obsm["X_cast"], at.obsm["X_cast"]) <= E2E_TOL
    # the public path draws its own weights and masks, from the seed
    a = TC.CAST_MARK(coords, X, d_hidden=16, d_out=4, n_epochs=5, device="cpu")
    np.testing.assert_array_equal(a, TC.CAST_MARK(coords, X, d_hidden=16, d_out=4, n_epochs=5, device="cpu"))
    assert a.shape == (len(X), 4) and np.isfinite(a).all()


def test_cast_mark_graph_and_augmentation(tmp_path):
    rng = np.random.default_rng(2)
    coords = rng.normal(size=(80, 2)) * 10
    A = TC.delaunay_dgl("s", coords, str(tmp_path), if_plot=False)
    assert (A != JC.delaunay_dgl("s", coords, str(tmp_path), if_plot=False)).nnz == 0
    x = rng.normal(size=(80, 12)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    xd = TC.drop_feature(torch.from_numpy(x), 0.5, gen).numpy()
    assert (((xd == 0).all(0)) | ((xd == x).all(0))).all()
    assert len(TC.mask_edge(A.todense(), 0.4, gen)) <= (np.asarray(A.todense()) != 0).sum()
    ng, feat = TC.random_aug(A.todense(), torch.from_numpy(x), 0.2, 0.3, gen)
    assert ng.shape == (80, 80) and feat.shape == x.shape
    assert _scale_err(JC.standardize(x), TC.standardize(torch.from_numpy(x)).numpy()) <= FWD_TOL
    emb = TC.train_seq([("s", A, x)], None, [], "", device="cpu")
    assert emb["s"].shape == (80, 512) and np.isfinite(emb["s"]).all()


# -- STAGATE -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stagate_case():
    rng = np.random.default_rng(0)
    n, G = 150, 20
    coords = rng.uniform(0, 10, (n, 2))
    X = rng.poisson(3, (n, G)).astype(np.float32)
    X[coords[:, 0] > 5, :8] += rng.poisson(5, ((coords[:, 0] > 5).sum(), 8))
    aj = st.AnnData(X=X, obs=pd.DataFrame({"X": coords[:, 0], "Y": coords[:, 1]}, index=[f"c{i}" for i in range(n)]),
                    var=pd.DataFrame(index=[f"g{i}" for i in range(G)]))
    aj.obsm["spatial"] = coords
    st.SKM.init_adata_type(aj, "UMI")
    return aj


def test_stagate_init_and_masks_equal(stagate_case):
    coords = np.asarray(stagate_case.obsm["spatial"])
    mj, mt = JG.STAGATE(20, (16, 4), seed=3), TG.STAGATE(20, (16, 4), seed=3, device="cpu")
    for k in mj.params:
        np.testing.assert_array_equal(mt.params[k].numpy(), np.asarray(mj.params[k]))
    np.testing.assert_array_equal(TG._adj_mask(coords, 1.5, device="cpu").numpy(), JG._adj_mask(coords, 1.5))
    np.testing.assert_array_equal(TG._adj_mask(coords, None, 6, device="cpu").numpy(), JG._adj_mask(coords, None, 6))


def test_train_stagate_first_steps_match_jax(stagate_case):
    import jax.numpy as jnp

    coords = np.asarray(stagate_case.obsm["spatial"])
    X = np.log1p(np.asarray(stagate_case.X, np.float32))
    mask = JG._adj_mask(coords, 1.5)
    init = JG.STAGATE(X.shape[1], (16, 4), seed=1).params
    pj, zj, _, lj = JG._train_stagate(init, jnp.asarray(mask), jnp.asarray(X), n_epochs=STEPS)
    pt, zt, _, lt = TG._train_stagate(stagate_params_from_reference(init, "cpu"), _t(mask), _t(X), n_epochs=STEPS)
    assert _scale_err(lj, lt.numpy()) <= LOSS_TOL
    noise = {"a2s", "a3s", "a4s"}  # gradients of rounding size (module docstring)
    for k in pj:
        if k in noise:
            assert np.abs(np.asarray(pj[k]) - pt[k].numpy()).max() <= 10 * LR * STEPS, k
        else:
            assert _scale_err(pj[k], pt[k].numpy()) <= W_TOL, k
    assert _scale_err(zj, zt.numpy()) <= W_TOL


def _net(df):
    return sorted(zip(df["Cell1"], df["Cell2"], np.round(np.asarray(df["Distance"], float), 12)))


def test_spatial_nets_equal(stagate_case):
    aj = stagate_case.copy()
    at = adata_from_reference(aj)
    for kw in (dict(k_cutoff=6, model="KNN"), dict(rad_cutoff=1.5)):
        JG.Cal_Spatial_Net(aj, verbose=False, **kw)
        TG.Cal_Spatial_Net(at, verbose=False, device="cpu", **kw)
        assert _net(at.uns["Spatial_Net"]) == _net(aj.uns["Spatial_Net"])
    aj.obs["Section_id"] = at.obs["Section_id"] = np.where(np.arange(aj.n_obs) < aj.n_obs // 2, "S1", "S2")
    JG.Cal_Spatial_Net_3D(aj, 1.5, 2.0, section_order=["S1", "S2"], verbose=False)
    TG.Cal_Spatial_Net_3D(at, 1.5, 2.0, section_order=["S1", "S2"], verbose=False, device="cpu")
    for k in ("Spatial_Net", "Spatial_Net_2D", "Spatial_Net_Zaxis"):
        assert _net(at.uns[k]) == _net(aj.uns[k]), k
    dj, dt = JG.Transfer_pytorch_Data(aj), TG.Transfer_pytorch_Data(at)
    np.testing.assert_array_equal(dt.edge_index.numpy(), dj.edge_index.numpy())
    np.testing.assert_array_equal(dt.x.numpy(), dj.x.numpy())
    bj, bt = JG.Batch_Data(aj, 2, 3), TG.Batch_Data(at, 2, 3)
    assert [list(b.obs_names) for b in bt] == [list(b.obs_names) for b in bj]


def test_train_STAGATE_mclust_and_pystagate_end_to_end_match_jax(stagate_case):
    aj = stagate_case.copy()
    at = adata_from_reference(aj)
    JG.Cal_Spatial_Net(aj, rad_cutoff=1.5, verbose=False)
    TG.Cal_Spatial_Net(at, rad_cutoff=1.5, verbose=False, device="cpu")
    JG.train_STAGATE(aj, hidden_dims=(16, 4), n_epochs=STEPS, verbose=False, save_loss=True, save_reconstrction=True)
    TG.train_STAGATE(at, hidden_dims=(16, 4), n_epochs=STEPS, verbose=False, save_loss=True, save_reconstrction=True,
                     device="cpu")
    assert _scale_err(aj.obsm["STAGATE"], at.obsm["STAGATE"]) <= STAGATE_E2E_TOL
    assert _scale_err(aj.layers["STAGATE_ReX"], at.layers["STAGATE_ReX"]) <= STAGATE_E2E_TOL
    Z = np.asarray(aj.obsm["STAGATE"])
    at.obsm["STAGATE"] = Z
    for model in ("EEE", "VVV", "EII"):
        JG.mclust_R(aj, 2, modelNames=model)
        TG.mclust_R(at, 2, modelNames=model, device="cpu")
        np.testing.assert_array_equal(np.asarray(at.obs["mclust"]).astype(int), np.asarray(aj.obs["mclust"]).astype(int))
    bj, bt = stagate_case.copy(), adata_from_reference(stagate_case)
    for a in (bj, bt):
        a.obsm["spatial"] = np.asarray(a.obsm["spatial"]) * 100.0  # radius 200: about 6 neighbours
    pj = st.tl.pySTAGATE(bj, num_epoch=STEPS, hidden_dims=[16, 4])
    pj.train()
    pt = stt.tl.pySTAGATE(bt, num_epoch=STEPS, hidden_dims=[16, 4], device="cpu")
    pt.train()
    assert _scale_err(bj.obsm["STAGATE"], bt.obsm["STAGATE"]) <= STAGATE_E2E_TOL
    pt.predicted()
    assert (np.asarray(bt.layers["STAGATE_ReX"]) >= 0).all()


def test_gatconv_and_stagate_module_from_carried_weights(stagate_case):
    aj = stagate_case.copy()
    JG.Cal_Spatial_Net(aj, k_cutoff=5, model="KNN", verbose=False)
    d = JG.Transfer_pytorch_Data(aj)
    x, ei = d.x.numpy(), d.edge_index.numpy()
    cj, ct = JG.GATConv(20, 6, seed=4), TG.GATConv(20, 6, seed=4, device="cpu")
    oj, (_, aj_att) = cj(x, ei, return_attention_weights=True)
    with torch.no_grad():
        ot, (_, at_att) = ct(x, ei, return_attention_weights=True)
        assert _scale_err(oj, ot.numpy()) <= FWD_TOL and _scale_err(aj_att, at_att.numpy()) <= FWD_TOL
        assert _scale_err(cj(x, ei, attention=False), ct(x, ei, attention=False).numpy()) <= FWD_TOL
    mj = JG.STAGATE_Module([20, 10, 4], seed=2)
    mt = stagate_params_from_reference(mj, device="cpu")
    with torch.no_grad():
        for a, b in zip(mj(x, ei), mt(x, ei)):
            assert _scale_err(a, b.numpy()) <= FWD_TOL
    assert mt.conv1.attentions is not None and mt.conv3.attentions is None


# -- MERFISHVI -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def vi_adata():
    rng = np.random.default_rng(1)
    n, G = 120, 25
    coords = rng.uniform(0, 10, (n, 2))
    X = rng.poisson(3, (n, G)).astype(np.float32)
    X[coords[:, 0] > 5, :10] += rng.poisson(5, ((coords[:, 0] > 5).sum(), 10))
    aj = st.AnnData(X=X, var=pd.DataFrame(index=[f"g{i}" for i in range(G)]),
                    obs=pd.DataFrame({"b": np.where(np.arange(n) % 2, "x", "y"), "c": rng.normal(size=n),
                                      "pop": np.where(coords[:, 0] > 5, "A", "B")},
                                     index=[f"c{i}" for i in range(n)]))
    aj.obsm["spatial"] = coords
    aj.obsm["prot"] = rng.poisson(4, (n, 3)).astype(np.float32)
    st.SKM.init_adata_type(aj, "UMI")
    return aj


def _vae_replay(seed, n_epochs, N, L, B=0, S=0):
    """`_train_vae`'s draws, by replaying its key splits: per epoch the
    latent's normals (and the spatial head's), and the minibatch."""
    import jax

    key, noise, idx = jax.random.PRNGKey(seed), [], []
    for _ in range(n_epochs):
        key, k1, k2 = jax.random.split(key, 3)
        ep = [np.asarray(jax.random.normal(k1, (B or N, L)))]
        if S:
            ep.append(np.asarray(jax.random.normal(jax.random.fold_in(k1, 1), (N, S))))
        noise.append([torch.from_numpy(e) for e in ep])
        if B:
            idx.append(np.asarray(jax.random.choice(k2, N, (B,), replace=False)))
    return noise, (torch.from_numpy(np.array(idx)) if B else None)


VI_CASES = {
    "nb": {},
    "zinb": dict(gene_likelihood="zinb"),
    "poisson": dict(gene_likelihood="poisson"),
    "minibatch": dict(batch_size=32),
    "gene-batch": dict(batch_key="b", dispersion="gene-batch", categorical_covariate_keys=["pop"],
                       continuous_covariate_keys=["c"]),
    "protein": dict(protein_expression_obsm_key="prot"),
    "spatial-encoder": dict(spatial_encoder=True, n_spatial=4),
    "linear-decoder": dict(linear_decoder=True),
    "penalty": dict(spatial_weight=0.5),
}


@pytest.mark.parametrize("case", list(VI_CASES))
def test_train_vae_first_steps_match_jax(vi_adata, case):
    kw = VI_CASES[case]
    mj = JM.MERFISHVI(vi_adata.copy(), n_latent=4, n_hidden=16, **kw)
    mt = TM.MERFISHVI(adata_from_reference(vi_adata), n_latent=4, n_hidden=16, device="cpu", **kw)
    merfishvi_params_from_reference(mj.params, model=mt)
    noise, bi = _vae_replay(0, STEPS, vi_adata.n_obs, 4, kw.get("batch_size", 0), 4 if "spatial_encoder" in kw else 0)
    lj = mj.train(max_epochs=STEPS)
    lt = mt.train(max_epochs=STEPS, noise=noise, batch_indices=bi)
    assert _scale_err(lj, lt) <= LOSS_TOL
    fj, ft = _flat(mj.params), _flat(mt.params.to_tree())
    assert fj.keys() == ft.keys()
    for k in fj:
        assert np.abs(fj[k] - ft[k]).max() <= VAE_W_ABS, k
    assert _scale_err(mj.get_latent_representation(), mt.get_latent_representation()) <= W_TOL
    if kw.get("linear_decoder"):
        assert _scale_err(mj.get_loadings(), mt.get_loadings()) <= W_TOL
    if kw.get("spatial_encoder"):
        assert _scale_err(mj.get_spatial_representation(), mt.get_spatial_representation()) <= W_TOL


def test_merfishvi_outputs(vi_adata):
    mt = TM.MERFISHVI(adata_from_reference(vi_adata), n_latent=4, n_hidden=16, protein_expression_obsm_key="prot",
                      device="cpu")
    losses = mt.train(max_epochs=60)
    assert losses[-1] < losses[0]
    px = mt.get_normalized_expression()
    np.testing.assert_allclose(px.sum(1), 1.0, atol=1e-5)
    assert mt.get_protein_expression().shape == (vi_adata.n_obs, 3)
    elbo, rec = mt.get_elbo(), mt.get_reconstruction_error()
    assert np.isfinite(elbo) and np.isfinite(rec)
    s = mt.posterior_predictive_sample(n_samples=2)
    assert s.shape == (2, vi_adata.n_obs, 25) and (s >= 0).all()
    de = mt.differential_expression("pop", "A", "B", n_samples=5)
    np.testing.assert_allclose(de["bayes_factor"], np.log(de["proba_de"] / (1 - de["proba_de"])), rtol=1e-6)
    enc = TM.MERFISHVI(adata_from_reference(vi_adata), n_latent=4, n_hidden=16, spatial_encoder=True, n_spatial=4,
                       device="cpu")
    with pytest.raises(NotImplementedError, match="spatial_encoder training is single-device"):
        enc.train(max_epochs=1, mesh=object())
    with pytest.raises(ValueError, match="linear_decoder"):
        mt.get_loadings()
    with pytest.raises(ValueError, match="gene_likelihood"):
        TM.MERFISHVI(adata_from_reference(vi_adata), gene_likelihood="beta", device="cpu")


def test_likelihood_helpers_match_jax():
    x = np.array([0.0, 1.0, 5.0, 12.0])
    mu = np.array([2.0, 3.0, 1.0, 8.0])
    th = np.array([1.5, 2.0, 4.0, 0.7])
    pi = np.array([0.3, 0.2, 0.1, 0.05])
    pairs = [(JM.log_nb_positive(x, mu, th), TM.log_nb_positive(x, mu, th)),
             (JM.log_poisson(x, mu), TM.log_poisson(x, mu)),
             (JM.log_normal(x, mu, th), TM.log_normal(x, mu, th)),
             (JM.log_zinb_positive(x, mu, th, pi), TM.log_zinb_positive(x, mu, th, pi))]
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=LIK_TOL)
    X, M, T, P = (np.random.default_rng(0).uniform(0.1, 5, (20, 6)).astype(np.float32) for _ in range(4))
    X = np.round(X)
    for a, b in ((JM._nb_ll(X, M, T), TM._nb_ll(_t(X), _t(M), _t(T))),
                 (JM._zinb_ll(X, M, T, P - 2.5), TM._zinb_ll(_t(X), _t(M), _t(T), _t(P - 2.5))),
                 (JM._poisson_ll(X, M), TM._poisson_ll(_t(X), _t(M)))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=LIK_TOL, atol=LIK_TOL)


def _module_replay(seed, n_epochs, shapes):
    """`_optax_fit`'s draws: per epoch, the normals of `shapes` from the keys
    `shapes` names ("k" for the step key, or an index into its splits)."""
    import jax

    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_epochs):
        key, k = jax.random.split(key)
        draws = []
        for split, shape in shapes:
            kk = k if split is None else jax.random.split(k, split[0])[split[1]]
            draws.append(torch.from_numpy(np.asarray(jax.random.normal(kk, shape))))
        out.append(draws)
    return out


@pytest.fixture(scope="module")
def family_case():
    rng = np.random.default_rng(0)
    n, G = 60, 12
    X = rng.poisson(3.0, (n, G)).astype(np.float32)
    coords = rng.uniform(0, 10, (n, 2))
    return X, coords, JMM.knn_mask(coords, k=4)


@pytest.mark.parametrize("kind", ["VAE", "LDVAE", "VAE-zinb-batch", "SpatialVAE"])
def test_vae_family_matches_jax(family_case, kind):
    X, coords, mask = family_case
    n, L, S = len(X), 3, 2
    bi = np.arange(n) % 2
    if kind == "VAE":
        mj, mt = JMM.VAE(12, n_latent=L, n_hidden=8), TMM.VAE(12, n_latent=L, n_hidden=8, device="cpu")
        shapes, b = [(None, (n, L))], None
    elif kind == "LDVAE":
        mj, mt = JMM.LDVAE(12, n_latent=L, n_hidden=8), TMM.LDVAE(12, n_latent=L, n_hidden=8, device="cpu")
        shapes, b = [(None, (n, L))], None
    elif kind == "VAE-zinb-batch":
        kw = dict(n_batch=2, n_latent=L, n_hidden=8, gene_likelihood="zinb", dispersion="gene-batch")
        mj, mt = JMM.VAE(12, **kw), TMM.VAE(12, device="cpu", **kw)
        shapes, b = [(None, (n, L))], bi
    else:
        kw = dict(n_latent=L, n_spatial=S, n_hidden=8, adjacency=mask)
        mj, mt = JMM.SpatialVAE(12, **kw), TMM.SpatialVAE(12, device="cpu", **kw)
        shapes, b = [((2, 0), (n, L)), ((2, 1), (n, S))], None
    merfishvi_params_from_reference(mj.params, model=mt)
    with torch.no_grad():
        ij, it = mj.inference(X, b), mt.inference(X, b)
        for k in ij:
            assert _scale_err(ij[k], it[k].numpy()) <= FWD_TOL, k
        gj, gt = mj.generative(ij["z"], X.sum(1), b), mt.generative(it["z"], X.sum(1), b)
        for k in gj:
            assert _scale_err(gj[k], gt[k].numpy()) <= FWD_TOL, k
    lj = mj.train(X, b, n_epochs=STEPS)
    lt = mt.train(X, b, n_epochs=STEPS, noise=_module_replay(0, STEPS, shapes))
    assert _scale_err(lj, lt) <= LOSS_TOL
    fj, ft = _flat(mj.params), _flat(mt.params.to_tree())
    for k in fj:
        assert np.abs(fj[k] - ft[k]).max() <= VAE_W_ABS, k
    assert _scale_err(mj.get_loadings(), mt.get_loadings()) <= W_TOL
    if kind == "SpatialVAE":
        assert np.abs(mj.get_spatial_representation(X) - mt.get_spatial_representation(X)).max() <= VAE_W_ABS


def test_multimodal_spatial_vae_matches_jax(family_case):
    X, coords, mask = family_case
    Y = np.random.default_rng(5).poisson(2.0, (len(X), 5)).astype(np.float32)
    kw = dict(n_latent=3, n_spatial=2, n_hidden=8, adjacency=mask)
    mj, mt = JMM.MultiModalSpatialVAE(12, 5, **kw), TMM.MultiModalSpatialVAE(12, 5, device="cpu", **kw)
    merfishvi_params_from_reference(mj.params, model=mt)
    assert _scale_err(mj.get_fused_representation(X, Y), mt.get_fused_representation(X, Y)) <= FWD_TOL
    for mod, x in (("spatial", X), ("nonspatial", Y)):
        assert _scale_err(mj.get_latent_representation_by_modality(mod, x),
                          mt.get_latent_representation_by_modality(mod, x)) <= FWD_TOL
    n = len(X)
    shapes = [((3, 0), (n, 3)), ((3, 1), (n, 3)), ((3, 2), (n, 3)), ((3, 2), (n, 2))]
    lj = mj.train(X, Y, n_epochs=STEPS)
    lt = mt.train(X, Y, n_epochs=STEPS, noise=_module_replay(0, STEPS, shapes))
    assert _scale_err(lj, lt) <= LOSS_TOL
    assert _scale_err(mj.get_nonspatial_specific_features(X, Y), mt.get_nonspatial_specific_features(X, Y)) <= W_TOL


def test_spatial_encoder_and_masks(family_case):
    X, coords, mask = family_case
    np.testing.assert_array_equal(TMM.knn_mask(coords, k=4, device="cpu"), mask)
    ei = np.array([[0, 1, 2], [1, 2, 0]])
    np.testing.assert_array_equal(TMM.edge_index_to_mask(ei, 4), JMM.edge_index_to_mask(ei, 4))
    ej = JMM.SpatialEncoder(3, 2, seed=1)
    et = TMM.SpatialEncoder(3, 2, seed=1, device="cpu")
    merfishvi_params_from_reference(ej.params, model=et)
    z = np.random.default_rng(0).normal(size=(len(X), 3)).astype(np.float32)
    with torch.no_grad():
        for a, b in zip(ej(z, mask), et(z, mask)):
            assert _scale_err(a, b.numpy()) <= FWD_TOL


# -- the weights carried across, the aliases, the imports -----------------------------------


def test_bridge_round_trips():
    import jax

    from spateo_tpu.external import cast_model as JCM

    p = JC._init_params(jax.random.PRNGKey(0), 6, 5, 4)
    for k, v in cast_params_from_reference(p, "cpu").items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(p[k]))
    g = JCM.GCNII(6, 4, 2, use_encoder=True, key=jax.random.PRNGKey(1))
    gt = cast_params_from_reference(g, "cpu")
    np.testing.assert_array_equal(gt.Ws[1].detach().numpy(), g.Ws[1])
    np.testing.assert_array_equal(gt.encoder.W.detach().numpy(), g.encoder.W)
    s = JG.STAGATE(6, (5, 3), seed=2).params
    for k, v in stagate_params_from_reference(s, "cpu").items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(s[k]))
    m = JG.STAGATE_Module([6, 5, 3], seed=1)
    mt = stagate_params_from_reference(m, "cpu")
    np.testing.assert_array_equal(mt.conv4.att_dst.detach().numpy(), m.conv4.att_dst)
    v = JMM.SpatialVAE(8, n_latent=3, n_spatial=2, n_hidden=4)
    tree = merfishvi_params_from_reference(v.params, device="cpu")
    fj, ft = _flat(v.params), _flat(tree.to_tree())
    assert fj.keys() == ft.keys() and all(np.array_equal(fj[k], ft[k]) for k in fj)


def test_reference_module_paths_importable():
    from spateo_tpu_torch.external import (
        CAST_MARK, CAST_PROJECT, CAST_STACK, LDVAE, MERFISHVI, STAGATE, VAE, CCA_SSG, GATConv,
        MultiModalSpatialVAE, SpatialEncoder, SpatialVAE, SpatialVI, Transfer_pytorch_Data, get_merfishvi_requirements,
        is_merfishvi_available, lack,
    )
    from spateo_tpu_torch.external.CAST import CAST_Stack, delta_cell_cal, kmeans_plot_multiple
    from spateo_tpu_torch.external.CAST.CAST_Projection import space_project
    from spateo_tpu_torch.external.CAST.CAST_Stack import reg_total
    from spateo_tpu_torch.external.CAST.main import CAST_MARK as M1
    from spateo_tpu_torch.external.CAST.model.aug import random_aug
    from spateo_tpu_torch.external.CAST.model.model_GCNII import CCA_SSG as C1
    from spateo_tpu_torch.external.CAST.utils import coords2adjacentmat
    from spateo_tpu_torch.external.CAST.visualize import dsplot
    from spateo_tpu_torch.external.MERFISHVI import VAE as V1
    from spateo_tpu_torch.external.MERFISHVI._model import SpatialVI as S1
    from spateo_tpu_torch.external.MERFISHVI.multimodal_spatial_vae import MultiModalSpatialVAE as MM1
    from spateo_tpu_torch.external.MERFISHVI.scvi_spatial_module import SpatialEncoder as SE1
    from spateo_tpu_torch.external.STAGATE_pyG import train_STAGATE
    from spateo_tpu_torch.external.STAGATE_pyG.gat_conv import GATConv as G1
    from spateo_tpu_torch.external.STAGATE_pyG.utils import Transfer_pytorch_Data as T1

    assert M1 is CAST_MARK and C1 is CCA_SSG and V1 is VAE and S1 is SpatialVI is MERFISHVI
    assert MM1 is MultiModalSpatialVAE and SE1 is SpatialEncoder and G1 is GATConv and T1 is Transfer_pytorch_Data
    assert CAST_Stack.CAST_STACK is CAST_STACK and reg_total and space_project and CAST_PROJECT
    assert callable(random_aug) and callable(coords2adjacentmat) and callable(dsplot) and callable(train_STAGATE)
    assert delta_cell_cal and kmeans_plot_multiple and STAGATE and LDVAE and SpatialVAE and lack.logger_manager.main_info
    assert is_merfishvi_available() and get_merfishvi_requirements() == ["torch", "numpy"]


def test_external_imports_neither_sklearn_nor_jax():
    """The port's external package, its aliases and a CPU run of CAST-Mark,
    CAST-Stack, STAGATE, mclust_R and MERFISHVI load no scikit-learn, JAX or
    `spateo_tpu`, and no line of `external/` names scikit-learn."""
    code = (
        "import sys, numpy as np, pandas as pd\n"
        "import spateo_tpu_torch as stt\n"
        "import spateo_tpu_torch.external as E\n"
        "import spateo_tpu_torch.external.CAST.CAST_Stack, spateo_tpu_torch.external.MERFISHVI._module\n"
        "rng = np.random.default_rng(0)\n"
        "c = rng.uniform(0, 10, (60, 2)); X = rng.poisson(2.0, (60, 8)).astype(np.float32)\n"
        "emb = E.CAST_MARK(c, X, d_hidden=8, d_out=4, n_epochs=2, device='cpu')\n"
        "p = E.reg_params(iterations=2, iterations_bs=(2,))\n"
        "E.CAST_STACK({'q': c, 'r': c}, {'q': emb, 'r': emb}, ['q', 'r'], params_dist=p, device='cpu')\n"
        "a = stt.AnnData(X=X, obs=pd.DataFrame(index=[f'c{i}' for i in range(60)]))\n"
        "a.obsm['spatial'] = c\n"
        "E.Cal_Spatial_Net(a, rad_cutoff=2.0, verbose=False, device='cpu')\n"
        "E.train_STAGATE(a, hidden_dims=(8, 2), n_epochs=2, verbose=False, device='cpu')\n"
        "E.mclust_R(a, 2, device='cpu')\n"
        "E.MERFISHVI(a, n_latent=2, n_hidden=4, spatial_encoder=True, device='cpu').train(max_epochs=2)\n"
        "bad = sorted({k.split('.')[0] for k in sys.modules} & {'sklearn', 'jax', 'jaxlib', 'optax', 'spateo_tpu'})\n"
        "print('BAD', bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BAD []" in proc.stdout, proc.stdout[-2000:]
    hits = [f"{p.name}:{i}" for p in (REPO / "spateo_tpu_torch" / "external").glob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1) if "sklearn" in line]
    assert hits == []
