"""The port's CAST-Stack and CAST-Project (`spateo_tpu_torch.external.
cast_stack`, `cast_projection`) and the CAST model family against the JAX
package on the CPU, and the CAST slice as a whole (CAST-Mark -> CAST-Stack ->
CAST-Project) on a small planted pair.

Bars:

- `corr_dist`: 1e-6 (float32 products; measured 3.6e-7).
- `_J_points` from the same cost matrix, with and without the distance
  penalty: equal. A query point whose two nearest references lie at the same
  squared distance to rounding may take either; such a flip changes that
  point's cost, so the flips are counted as the points whose costs differ
  (0 here).
- `_affine_gd`, 50 iterations: theta to 1e-5 of scale (measured 2e-7;
  XLA's and torch's float32 cos, sin and 2-term products round apart), the
  J history to 1e-5 relative (measured 1.9e-7), flips of the final costs 0.
- `prelocate`: the same theta (a 180 degree flip and the grid's scales).
- `_bspline_gd`, 20 iterations: coordinates to 1e-5 of scale (measured
  2.1e-6), the meshes to 1e-5 of scale, J to 1e-5 relative; the scatter
  adds each node's terms in point order in both packages.
- `reg_total` / `FFD_Bspline_apply` from one saved transform: 1e-5 of scale.
- The reference-named host loops (`Affine_GD`, `BSpline_GD`, the B-spline
  helpers, `dJ_dtheta_cal`, `theta_renew`): 1e-6 relative (host numpy; the
  costs' distances are float32 on the device).
- `_project_chunk` and `physical_dist_priority_project`: indices equal
  (ties broken toward the lower index in both: `lax.top_k` and
  `math.smallest_k`), weights and distances to 5e-5 of scale (measured
  1.1e-5: both packages take the matmul form |a|^2 + |b|^2 - 2 a.b, whose
  cancellation near a match rounds apart); `space_project` /
  `CAST_PROJECT`: indices equal and projected expression to 5e-5.
- `cosine_IDW`, `group_shift`: equal to 1e-9 (float64 cosine on the device
  against scikit-learn's); `confusion_matrix` against scikit-learn's: equal.
- GCNII, GCN and CCA_SSG from weights carried over by
  `core.bridge.cast_params_from_reference`: the forwards to 1e-6 of scale.
- The slice: the JAX package's own bars in tests/test_cast_stack.py and
  tests/test_external.py (CAST-Mark embeddings finite and of their shape,
  the aligned error below 0.15 of the initial, the FFD below 0.7 of the
  warp, the projection onto the cell's own counterpart above 0.9).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import spateo_tpu as st
from spateo_tpu.external import cast_model as JCM
from spateo_tpu.external import cast_projection as JP
from spateo_tpu.external import cast_stack as JS
from spateo_tpu_torch.core.bridge import adata_from_reference, cast_params_from_reference
from spateo_tpu_torch.external import cast_model as TCM
from spateo_tpu_torch.external import cast_projection as TP
from spateo_tpu_torch.external import cast_stack as TS

CORR_TOL, THETA_TOL, J_TOL, COORD_TOL = 1e-6, 1e-5, 1e-5, 1e-5
LOOP_TOL, PROJ_TOL, FWD_TOL, COS_TOL = 1e-6, 5e-5, 1e-6, 1e-9


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _scale_err(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@pytest.fixture(scope="module")
def warped_pair():
    """tests/test_cast_stack.py's pair: a slice rotated by 25 deg and shifted,
    with spatially smooth shared embeddings."""
    rng = np.random.default_rng(0)
    n = 300
    pts_r = rng.uniform(0, 2000, (n, 2)).astype(np.float32)
    th = np.deg2rad(25.0)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    pts_q = pts_r @ R.T + np.array([300.0, -200.0], np.float32)
    W = rng.normal(0, 1.0 / 400, (2, 16)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, 16).astype(np.float32)
    E = np.c_[np.sin(pts_r @ W + phase), np.cos(pts_r @ W + phase)].astype(np.float32)
    cov = JS.max_minus_value(JS.corr_dist(E, E)).astype(np.float32)
    q = (pts_q - pts_q.mean(0)).astype(np.float32)
    r = (pts_r - pts_r.mean(0)).astype(np.float32)
    return pts_q, pts_r, E, cov, q, r


def _params(mod, **kw):
    base = dict(dataname="q", iterations=800, diff_step=25.0, alpha_basis=(1 / 300, 1 / 300, 1 / 10, 10, 10),
                iterations_bs=(60,), meshsize=(6,), alpha_basis_bs=(300.0,))
    base.update(kw)
    return mod.reg_params(**base)


def _flips(coords, r, cov, dist_penalty=0.0):
    """Points whose cost differs between the packages at the same coords."""
    Jj = np.asarray(JS._J_points(coords, r, cov, 500.0, dist_penalty))
    Jt = TS._J_points(_t(coords), _t(r), _t(cov), 500.0, dist_penalty).numpy()
    return int((Jj != Jt).sum())


# -- the similarity cost, affine GD, pre-location, FFD -------------------------------------


def test_corr_dist_matches_jax(warped_pair):
    _, _, E, *_ = warped_pair
    rng = np.random.default_rng(1)
    E2 = E + rng.normal(0, 0.1, E.shape).astype(np.float32)
    assert np.abs(TS.corr_dist(E, E2, device="cpu") - JS.corr_dist(E, E2)).max() <= CORR_TOL
    np.testing.assert_array_equal(TS.max_minus_value(JS.corr_dist(E, E2)), JS.max_minus_value(JS.corr_dist(E, E2)))


@pytest.mark.parametrize("dist_penalty", [0.0, 2.0])
def test_J_points_equal(warped_pair, dist_penalty):
    _, _, _, cov, q, r = warped_pair
    assert _flips(q, r, cov, dist_penalty) == 0
    q2 = q * 0.5  # a window that leaves references out
    assert _flips(q2, r, cov, dist_penalty) == 0


@pytest.mark.parametrize("ifrigid", [False, True])
def test_affine_gd_matches_jax(warped_pair, ifrigid):
    import jax.numpy as jnp

    _, _, _, cov, q, r = warped_pair
    ab = np.array([1 / 300, 1 / 300, 1 / 10, 10, 10], np.float32)
    th_j, J_j = JS._affine_gd(jnp.asarray(q), jnp.asarray(r), jnp.asarray(cov), 500.0, 0.0, jnp.asarray(ab), 25.0,
                              50, ifrigid)
    th_t, J_t = TS._affine_gd(_t(q), _t(r), _t(cov), 500.0, 0.0, _t(ab), 25.0, 50, ifrigid)
    assert _scale_err(th_j, th_t.numpy()) <= THETA_TOL
    assert _scale_err(J_j, J_t.numpy()) <= J_TOL
    final = np.asarray(JS._affine_trans(jnp.asarray(th_j), jnp.asarray(q)))
    assert _flips(final, r, cov) == 0


def test_prelocate_matches_jax(warped_pair):
    import jax.numpy as jnp

    _, _, _, cov, q, r = warped_pair
    for d_list in ([1.0], [2.0, 1.0, 0.5]):
        tj = JS.prelocate(jnp.asarray(-q), jnp.asarray(r), jnp.asarray(cov), 500.0, d_list=d_list)
        tt = TS.prelocate(_t(-q), _t(r), _t(cov), 500.0, d_list=d_list)
        np.testing.assert_array_equal(tt, tj)
        assert tt[2] in (180.0, 270.0)
    tj = JS.prelocate(jnp.asarray(q), jnp.asarray(r), jnp.asarray(cov), 500.0, translation_params=(0.1, 0.1, 3))
    np.testing.assert_array_equal(TS.prelocate(q, r, cov, 500.0, translation_params=(0.1, 0.1, 3), device="cpu"), tj)


def test_bspline_gd_matches_jax(warped_pair):
    import jax.numpy as jnp

    _, _, _, cov, q, r = warped_pair
    lo = q.min(0)
    qq, rr = (q - lo).astype(np.float32), (r - lo).astype(np.float32)
    mx = qq.max(0).astype(np.float32)
    cj, mj, Jj = JS._bspline_gd(jnp.asarray(qq), jnp.asarray(rr), jnp.asarray(cov), 500.0, 0.0, 300.0, 25.0,
                                jnp.asarray(mx), 20, 6)
    ct, mt, Jt = TS._bspline_gd(_t(qq), _t(rr), _t(cov), 500.0, 0.0, 300.0, 25.0, _t(mx), 20, 6)
    assert _scale_err(cj, ct.numpy()) <= COORD_TOL
    assert _scale_err(mj, mt.numpy()) <= COORD_TOL
    assert _scale_err(Jj, Jt.numpy()) <= J_TOL


def test_bspline_warp_and_basis_match_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    uv = rng.uniform(0, 1, (2, 64)).astype(np.float32)
    for k in range(4):
        kl = np.full((2, 1), k, np.int32)
        np.testing.assert_array_equal(TS._bspline_basis(_t(uv), _t(kl)).numpy(),
                                      np.asarray(JS._bspline_basis(jnp.asarray(uv), jnp.asarray(kl))))
    coords = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    mesh = rng.uniform(-10, 110, (2, 64)).astype(np.float32)
    delta = np.array([20.0, 20.0], np.float32)
    out_j = np.asarray(JS._bspline_warp(jnp.asarray(coords), jnp.asarray(mesh), jnp.asarray(delta), 8))
    assert _scale_err(out_j, TS._bspline_warp(_t(coords), _t(mesh), _t(delta), 8).numpy()) <= COORD_TOL


def test_reg_total_and_ffd_apply_replay_the_jax_transform(warped_pair):
    pts_q, pts_r, E, *_ = warped_pair
    params = _params(JS, iterations=150, iterations_bs=(20,), meshsize=(5,))
    JS.CAST_STACK({"q": pts_q, "r": pts_r}, {"q": E, "r": E}, ["q", "r"], params_dist=params)
    tp = TS.reg_params(**{k: getattr(params, k) for k in TS.reg_params.__dataclass_fields__})
    _, rj = JS.reg_total(pts_q, pts_r, params)
    _, rt = TS.reg_total(pts_q, pts_r, tp, device="cpu")
    assert _scale_err(rj, rt) <= COORD_TOL
    c = (pts_q - pts_q.min(0)).astype(np.float32)
    assert _scale_err(JS.FFD_Bspline_apply(c, params), TS.FFD_Bspline_apply(c, tp, device="cpu")) <= COORD_TOL
    assert _scale_err(JS.FFD_Bspline_apply_t(c, params), TS.FFD_Bspline_apply_t(c, tp, device="cpu")) <= COORD_TOL


def test_cast_stack_matches_jax(warped_pair):
    pts_q, pts_r, E, *_ = warped_pair
    pj = _params(JS, iterations=100, iterations_bs=(10,))
    pt = _params(TS, iterations=100, iterations_bs=(10,))
    oj = JS.CAST_STACK({"q": pts_q, "r": pts_r}, {"q": E, "r": E}, ["q", "r"], params_dist=pj)
    ot = TS.CAST_STACK({"q": pts_q, "r": pts_r}, {"q": E, "r": E}, ["q", "r"], params_dist=pt, device="cpu")
    np.testing.assert_array_equal(pt.theta_r1, pj.theta_r1)
    assert _scale_err(pj.theta_r2, pt.theta_r2) <= THETA_TOL
    assert _scale_err(oj["q"], ot["q"]) <= COORD_TOL
    np.testing.assert_array_equal(ot["r"], oj["r"])


# -- the reference-named host loops -------------------------------------------------------


def test_affine_host_loop_matches_jax(warped_pair):
    pts_q, pts_r, _, cov, *_ = warped_pair
    ab = np.reshape(np.array([1 / 300, 1 / 300, 1 / 10, 10, 10]), [5, 1])
    kw = dict(bleeding=500, dist_penalty=0, diff_step=25.0, alpha_basis=ab, iterations=20)
    sj, _, thj, _ = JS.Affine_GD(pts_q, pts_r, cov, **kw)
    stt_, _, tht, _ = TS.Affine_GD(pts_q, pts_r, cov, device="cpu", **kw)
    assert _scale_err(sj, stt_) <= LOOP_TOL
    assert _scale_err(thj[-1], tht[-1]) <= LOOP_TOL
    att = np.zeros(len(pts_q), bool)
    att[:50] = True
    for ap in ((None, 3, 1, 0), (att, 3, 2, 1)):
        a = JS.J_cal(pts_q, pts_r, cov, 500, 2.0, ap)
        b = TS.J_cal(pts_q, pts_r, cov, 500, 2.0, ap, device="cpu")
        np.testing.assert_array_equal(a, b)


def test_bspline_host_loop_matches_jax():
    rng = np.random.default_rng(3)
    pts_r = rng.uniform(0, 400, (150, 2)).astype(np.float32)
    pts_q = pts_r + rng.normal(0, 12, pts_r.shape).astype(np.float32)
    W = rng.normal(0, 1.0 / 80, (2, 12)).astype(np.float32)
    E = np.c_[np.sin(pts_r @ W), np.cos(pts_r @ W)].astype(np.float32)
    cov = JS.max_minus_value(JS.corr_dist(E, E)).astype(np.float32)
    kw = dict(iterations=8, bleeding=500, dist_penalty=0, alpha_basis=300.0, diff_step=25.0, mesh_size=6)
    cj, mj, _, sj, _ = JS.BSpline_GD(pts_q, pts_r, cov, **kw)
    ct, mt, _, s_t, _ = TS.BSpline_GD(pts_q, pts_r, cov, device="cpu", **kw)
    assert _scale_err(cj, ct) <= LOOP_TOL and _scale_err(sj, s_t) <= LOOP_TOL
    assert _scale_err(np.asarray(mj), np.asarray(mt)) <= LOOP_TOL
    uv = rng.uniform(0, 1, (2, 30))
    np.testing.assert_array_equal(TS.B_matrix(uv, TS._kls()), JS.B_matrix(uv, JS._kls()))
    xi, yi = rng.normal(size=(2, 30))
    dJ = rng.normal(size=(2, 30))
    theta = np.array([1.0, 1.0, 10.0, 0.0, 0.0]).reshape(5, 1)
    for rigid in (False, True):
        np.testing.assert_array_equal(TS.dJ_dtheta_cal(xi, yi, dJ, theta, ifrigid=rigid),
                                      JS.dJ_dtheta_cal(xi, yi, dJ, theta, ifrigid=rigid))
    np.testing.assert_array_equal(TS.theta_renew(theta, dJ[0, :5], np.ones(5)), JS.theta_renew(theta, dJ[0, :5],
                                                                                                np.ones(5)))
    np.testing.assert_array_equal(TS.alpha_init(np.ones(5), 7), JS.alpha_init(np.ones(5), 7))


def test_stack_helpers_match_jax(warped_pair):
    pts_q, pts_r, *_ = warped_pair
    np.testing.assert_array_equal(TS.CAST_STACK_rough([pts_q, pts_r])[1], JS.CAST_STACK_rough([pts_q, pts_r])[1])
    np.testing.assert_array_equal(TS.CAST_STACK_rough([pts_q, pts_r], percentile=5)[0],
                                  JS.CAST_STACK_rough([pts_q, pts_r], percentile=5)[0])
    assert TS.get_range(pts_q) == JS.get_range(pts_q)
    np.testing.assert_array_equal(TS.coords_minus_min(pts_q), JS.coords_minus_min(pts_q))
    a, fa = TS.rescale_coords({"a": pts_q, "b": pts_r}, ["a", "b"], rescale=True)
    b, fb = JS.rescale_coords({"a": pts_q, "b": pts_r}, ["a", "b"], rescale=True)
    assert fa == fb and np.array_equal(a["a"], b["a"])
    th = np.array([1.1, 0.9, 30.0, 5.0, -3.0], np.float32)
    assert _scale_err(JS.affine_trans_t(th, pts_q), TS.affine_trans_t(th, pts_q)) <= 1e-6


# -- CAST-Project -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def proj_case():
    rng = np.random.default_rng(0)
    ns, nt, F = 200, 100, 16
    coords_s = rng.uniform(0, 1000, (ns, 2)).astype(np.float32)
    coords_t = coords_s[:nt] + rng.normal(0, 5, (nt, 2)).astype(np.float32)
    feats = rng.normal(size=(ns, F)).astype(np.float32)
    feat_t = feats[:nt] + rng.normal(0, 0.05, (nt, F)).astype(np.float32)
    coords_t[:10] += 5000.0  # outside every window: the k_extend fallback
    return feat_t, feats, coords_t, coords_s, rng.poisson(3.0, (ns, 10)).astype(np.float32)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("k2", [1, 3])
def test_project_chunk_matches_jax(proj_case, metric, k2):
    import jax.numpy as jnp

    ft, fs, ct, cs, _ = proj_case
    out_j = JP._project_chunk(jnp.asarray(ft), jnp.asarray(fs), jnp.asarray(ct), jnp.asarray(cs), 100.0, k2, 5, metric)
    out_t = TP._project_chunk(_t(ft), _t(fs), _t(ct), _t(cs), 100.0, k2, 5, metric)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    for a, b in zip(out_j[1:], out_t[1:]):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= PROJ_TOL * max(np.abs(np.asarray(a)).max(), 1.0)


def test_projection_matches_jax_blocked(proj_case):
    ft, fs, ct, cs, src = proj_case
    a = JP.physical_dist_priority_project(ft, fs, ct, cs, source_feat=src, k2=2, pdist_thres=100.0, block=32)
    b = TP.physical_dist_priority_project(ft, fs, ct, cs, source_feat=src, k2=2, pdist_thres=100.0, block=32,
                                          device="cpu")
    np.testing.assert_array_equal(b[0], a[0])
    for x, y in zip(a[1:], b[1:]):
        assert np.abs(np.asarray(x) - np.asarray(y)).max() <= PROJ_TOL * max(np.abs(np.asarray(x)).max(), 1.0)


def _proj_adata(n=120, seed=2):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 500, (n, 2)).astype(np.float32)
    X = rng.poisson(2.0, (2 * n, 12)).astype(np.float32)
    feats = np.vstack([rng.normal(size=(n, 8))] * 2).astype(np.float32)
    obs = pd.DataFrame({"protocol": ["src"] * n + ["tgt"] * n, "ctype": (["A"] * (n // 2) + ["B"] * (n - n // 2)) * 2},
                       index=[f"c{i}" for i in range(2 * n)])
    aj = st.AnnData(X=X, obs=obs, var=pd.DataFrame(index=[f"g{j}" for j in range(12)]))
    aj.obsm["X_pca"] = feats
    st.SKM.init_adata_type(aj, "UMI")
    return aj, adata_from_reference(aj), coords


def test_cast_project_matches_jax():
    aj, at, coords = _proj_adata()
    kw = dict(batch_key="protocol", source_sample_ctype_col="ctype", pc_feature="X_pca", raw_layer="X")
    rj, oj = JP.CAST_PROJECT(aj, "src", "tgt", coords, coords + 1.0, **kw)
    rt, ot = TP.CAST_PROJECT(at, "src", "tgt", coords, coords + 1.0, device="cpu", **kw)
    np.testing.assert_array_equal(ot[0], oj[0])
    assert np.abs(np.asarray(rt.X) - np.asarray(rj.X)).max() <= PROJ_TOL * np.abs(np.asarray(rj.X)).max()
    assert list(rt.obs["ctype_projected"]) == list(rj.obs["ctype_projected"])
    assert (np.asarray(ot[0])[:, 0] == np.arange(len(coords))).mean() > 0.9


def test_projection_helpers_match_jax(proj_case):
    from sklearn.metrics import confusion_matrix as sk_confusion

    ft, fs, ct, cs, _ = proj_case
    rng = np.random.default_rng(4)
    d = rng.uniform(0, 2, 30)
    for k in (1, 5):
        for a, b in zip(TP.cosine_IDW(d, k2=k), JP.cosine_IDW(d, k2=k)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(TP.group_shift(ft, fs, ct, cs, device="cpu"), JP.group_shift(ft, fs, ct, cs),
                               rtol=COS_TOL, atol=COS_TOL)
    np.testing.assert_array_equal(TP.IDW(d[None]), JP.IDW(d[None]))
    assert TP.average_dist(cs) == JP.average_dist(cs)
    yt, yp = rng.choice(list("abc"), 50), rng.choice(list("abcd"), 50)
    for norm in (None, "true", "pred", "all"):
        np.testing.assert_allclose(TP.confusion_matrix(yt, yp, labels=list("abc"), normalize=norm),
                                   sk_confusion(yt, yp, labels=list("abc"), normalize=norm), rtol=1e-12)


# -- the CAST model family ----------------------------------------------------------------


def _graph(n=40, f=16, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 100, (n, 2))
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    A = np.zeros((n, n), np.float32)
    nbr = np.argsort(d2, 1)[:, 1:6]
    for i in range(n):
        A[i, nbr[i]] = 1
    return np.maximum(A, A.T), rng.normal(size=(n, f)).astype(np.float32)


@pytest.mark.parametrize("kind", ["GCNII", "GCNII-encoder", "GCN", "CCA_SSG"])
def test_cast_model_forward_from_carried_weights(kind):
    import jax

    A, X = _graph()
    if kind == "GCNII":
        mj = JCM.GCNII(16, 8, 4, alpha=[0.1, 0.2, 0.1, 0.3], lambda_=[1.0, 0.5, 2.0, 1.0], key=jax.random.PRNGKey(2))
    elif kind == "GCNII-encoder":
        mj = JCM.GCNII(16, 8, 3, use_encoder=True, key=jax.random.PRNGKey(3))
    elif kind == "GCN":
        mj = JCM.GCN(16, 8, 2, key=jax.random.PRNGKey(4))
    else:
        mj = JCM.CCA_SSG(16, 8, 3, backbone="GCNII", key=jax.random.PRNGKey(5))
    mt = cast_params_from_reference(mj, device="cpu")
    if kind == "CCA_SSG":
        for a, b in zip(mj(A, X, A, X), mt(A, X, A, X)):
            assert _scale_err(a, b.detach().numpy()) <= FWD_TOL
        assert _scale_err(mj.get_embedding(A, X), mt.get_embedding(A, X).detach().numpy()) <= FWD_TOL
    else:
        assert _scale_err(mj(A, X), mt(A, X).detach().numpy()) <= FWD_TOL
    with pytest.raises(ValueError):
        TCM.CCA_SSG(16, 8, 2, backbone="SAGE", device="cpu")
    assert TCM.Args(dataname="d").device == "cuda" and TCM.Args(dataname="d", gpu=-1).device == "cpu"


def test_standardize_matches_jax():
    X = np.random.default_rng(0).normal(size=(30, 5)).astype(np.float32)
    assert _scale_err(JCM.standardize(X), TCM.standardize(torch.from_numpy(X)).numpy()) <= FWD_TOL


# -- the slice as a whole ---------------------------------------------------------------


def test_slice_recovers_affine_warp(warped_pair):
    """tests/test_cast_stack.py's bar on the port's CAST_STACK."""
    pts_q, pts_r, E, *_ = warped_pair
    init_err = float(np.linalg.norm(pts_q - pts_r, axis=1).mean())
    out = TS.CAST_STACK({"q": pts_q, "r": pts_r}, {"q": E, "r": E}, ["q", "r"], params_dist=_params(TS), device="cpu")
    assert float(np.linalg.norm(out["q"] - pts_r, axis=1).mean()) < 0.15 * init_err


def test_slice_ffd_handles_nonrigid():
    rng = np.random.default_rng(1)
    pts_r = rng.uniform(0, 2000, (300, 2)).astype(np.float32)
    warp = np.c_[60 * np.sin(pts_r[:, 1] / 300), 60 * np.cos(pts_r[:, 0] / 300)].astype(np.float32)
    pts_q = pts_r + warp
    W = rng.normal(0, 1.0 / 400, (2, 16)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, 16).astype(np.float32)
    E = np.c_[np.sin(pts_r @ W + phase), np.cos(pts_r @ W + phase)].astype(np.float32)
    out = TS.CAST_STACK({"q": pts_q, "r": pts_r}, {"q": E, "r": E}, ["q", "r"],
                        params_dist=_params(TS, iterations=100, iterations_bs=(200,)), device="cpu")
    err = float(np.linalg.norm(out["q"] - pts_r, axis=1).mean())
    assert err < 0.7 * float(np.linalg.norm(warp, axis=1).mean())


def test_slice_mark_stack_project_on_a_planted_pair(warped_pair):
    """The three stages in a row on the pair of `warped_pair`, at the JAX
    package's bars: CAST-Mark embeds both sections' counts (drawn from the
    planted smooth programs) in one model, finite and of the right shape
    (tests/test_external.py); CAST-Stack aligns the query (below 0.15 of the
    initial error); CAST-Project sends each aligned query cell to its own
    reference cell (above 0.9), the features those of
    tests/test_cast_stack.py, and carries the reference's counts and labels."""
    import spateo_tpu_torch as stt
    from spateo_tpu_torch.external import CAST_MARK

    pts_q, pts_r, E, *_ = warped_pair
    n = len(pts_r)
    rate = 4.0 * (1.0 + E)
    Xr, Xq = (np.log1p(np.random.default_rng(s).poisson(rate)).astype(np.float32) for s in (1, 2))
    mark = CAST_MARK(np.r_[pts_r, pts_q + 10_000.0], np.r_[Xr, Xq], k=10, d_hidden=32, d_out=16, n_epochs=100,
                     device="cpu")
    assert mark.shape == (2 * n, 16) and np.isfinite(mark).all()
    init_err = float(np.linalg.norm(pts_q - pts_r, axis=1).mean())
    out = TS.CAST_STACK({"q": pts_q, "r": pts_r}, {"q": E, "r": E}, ["q", "r"], params_dist=_params(TS), device="cpu")
    assert float(np.linalg.norm(out["q"] - pts_r, axis=1).mean()) < 0.15 * init_err
    label = (pts_r[:, 1] > 1000).astype(int).astype(str)
    obs = pd.DataFrame({"protocol": ["r"] * n + ["q"] * n, "half": np.r_[label, label]},
                       index=[f"c{i}" for i in range(2 * n)])
    ad = stt.AnnData(X=np.r_[Xr, Xq], obs=obs, var=pd.DataFrame(index=[f"g{j}" for j in range(Xr.shape[1])]))
    ad.obsm["X_cast"] = mark
    ad.obsm["X_feat"] = np.r_[E, E]
    stt.SKM.init_adata_type(ad, "UMI")
    sdata, res = TP.CAST_PROJECT(ad, "r", "q", pts_r, out["q"], batch_key="protocol", raw_layer="X",
                                 source_sample_ctype_col="half", pc_feature="X_feat", device="cpu")
    own = np.asarray(res[0])[:, 0] == np.arange(n)
    assert own.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(sdata.X)[own], Xr[own])
    assert (np.asarray(sdata.obs["half_projected"]) == label).mean() > 0.9
