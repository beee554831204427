"""The port's PASTE (`stt.align.paste_*`, `center_NMF`, the mapping helpers)
and `stt.tdr.cell_directions` against the JAX package's on the CPU.

Bars:

- FGW plans to 5e-5 of scale (measured 1.1e-6 on the 120-cell pair of
  `test_paste_pairwise_align_entropic_matches_jax`). Where the entropic plan
  saturates (97-99% of its entries underflow to 0 and stay 0, log 0 being
  -inf), which entries survive is set by float32 rounding: a one-ulp change
  of one slice's coordinates moves the port's own plan by 9.7e-6-1.4e-3 of
  its scale, and the two packages' plans lie 2.7e-5-5.2e-3 apart (measured
  on the pairs of `test_paste_align_and_ref_match_jax` and
  `test_cell_directions_matches_jax`). Those plans are held to 1e-2 of
  scale, and what is computed from them (aligned coordinates, Procrustes
  mappings, the cells mapped) tightly.
- Objectives to 5e-5 of the scale of their terms, alpha sum(constC T) +
  (1 - alpha) sum(M T), not of the objective itself: on a well-aligned pair
  the objective (~2e-4) is a difference of terms ~3e4 times larger, and the
  float32 rounding of those terms moves it by 1.4e-4 relative between the
  packages (and by 4.4e-4 within the JAX package when its spatial distances
  come from the matmul expansion instead of cdist).
- The exact solver's plans to 1e-9; its objective carries constC's float32
  rounding (`test_torch_ot.py`), held like the entropic one.
- Mapping indices from ``pi == pi.max()`` are compared only on rows whose two
  largest plan values lie more than 1e-4 of the plan's scale apart: the
  plans differ by ~1e-6 of scale, so a nearer tie may flip. Elsewhere the
  chosen pi values are compared.
- The NMF (float64 multiplicative updates) equals scikit-learn's to 1e-6
  relative on W @ H, with the same iterations. The Frobenius NMF (float64
  coordinate descent, `dissimilarity != "kl"`) equals scikit-learn's to
  1e-10 of scale on W and H, with the same iterations (measured 4.9e-14).
"""

import sys

import numpy as np
import pytest
import torch

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.alignment import utils as jau
from spateo_tpu_torch.alignment import utils as tau
from spateo_tpu_torch.core.bridge import adata_from_reference

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_alignment import make_slice_pair  # noqa: E402

PLAN_TOL = 5e-5
SATURATED_PLAN_TOL = 1e-2
OBJ_TOL = 5e-5
TIE_GAP = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU among its
    workers, where torch's thread pools only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _obj_scale(A, B, pi, alpha):
    """The scale of the FGW objective's terms for the plan pi."""
    cA, cB = np.asarray(A.obsm["spatial"], float), np.asarray(B.obsm["spatial"], float)
    DA = np.sqrt(((cA[:, None] - cA[None]) ** 2).sum(-1))
    DB = np.sqrt(((cB[:, None] - cB[None]) ** 2).sum(-1))
    constC = (DA**2 @ pi.sum(1))[:, None] + (DB**2 @ pi.sum(0))[None, :]
    from spateo_tpu.alignment.methods.math import calc_distance

    [M] = calc_distance(np.asarray(A.X, np.float32), np.asarray(B.X, np.float32), metric="kl")
    return alpha * float((constC * pi).sum()) + (1 - alpha) * float(np.abs(np.asarray(M) * pi).sum())


def _pair(n, seed, **kw):
    A, B, R = make_slice_pair(n=n, seed=seed, **kw)
    return A, B, adata_from_reference(A), adata_from_reference(B), R


def _unambiguous_rows(pi):
    top2 = np.sort(pi, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > TIE_GAP * pi.max()


def test_paste_pairwise_align_entropic_matches_jax():
    A, B, At, Bt, _ = _pair(120, 8)
    pj, oj = st.align.paste_pairwise_align(A, B, alpha=0.1, numItermax=50, verbose=False)
    pt, ot_ = stt.align.paste_pairwise_align(At, Bt, alpha=0.1, numItermax=50, verbose=False, device="cpu")
    assert pt.shape == (120, 120) and pt.dtype == np.float32
    assert _scaled(pt, pj) <= PLAN_TOL
    assert abs(ot_ - oj) <= OBJ_TOL * _obj_scale(A, B, np.asarray(pj, float), 0.1)


def test_paste_pairwise_align_norm_divisor():
    """`norm=True` divides each distance matrix by its smallest positive
    entry, the nearest pair's distance from the matmul expansion, whose
    float32 rounding differs between the packages (here 1e-4 relative); the
    divided distances reach ~170 and put the FGW in the saturated regime,
    where the two plans differ entirely. Held: the divisor to 1e-3 relative
    of the exact nearest-pair distance in both packages (the port zeroes
    the self-distances, which the JAX package's jitted expansion computes as
    exactly 0), and the port's plan has the target marginal (the inner
    Sinkhorn loop ends on the column update; in the saturated regime 100
    sweeps leave the row sums far from theirs, in both packages)."""
    from spateo_tpu.alignment.methods.math import euc_dist as jeuc
    from spateo_tpu_torch.alignment.methods.math import euc_dist as teuc

    A, B, At, Bt, _ = _pair(120, 8)
    c = np.asarray(A.obsm["spatial"], np.float32)
    exact = np.sqrt(((c[:, None].astype(float) - c[None]) ** 2).sum(-1))
    dmin = exact[exact > 0].min()
    Dj = np.asarray(jeuc(c, c, squared=False))
    Dt = teuc(torch.from_numpy(c), torch.from_numpy(c), squared=False).fill_diagonal_(0).numpy()
    assert abs(Dj[Dj > 0].min() / dmin - 1) <= 1e-3 and abs(Dt[Dt > 0].min() / dmin - 1) <= 1e-3
    pt, _ = stt.align.paste_pairwise_align(At, Bt, alpha=0.1, numItermax=50, norm=True, verbose=False, device="cpu")
    np.testing.assert_allclose(pt.sum(0), np.full(120, 1 / 120), rtol=1e-3)


def test_paste_pairwise_align_exact_matches_jax():
    A, B, At, Bt, _ = _pair(60, 11)
    pj, oj = st.align.paste_pairwise_align(A, B, alpha=0.1, numItermax=30, verbose=False, method="exact")
    pt, ot_ = stt.align.paste_pairwise_align(At, Bt, alpha=0.1, numItermax=30, verbose=False, method="exact",
                                             device="cpu")
    np.testing.assert_allclose(pt, pj, atol=1e-9)
    assert abs(ot_ - oj) <= OBJ_TOL * _obj_scale(A, B, pj, 0.1)


def test_paste_align_and_ref_match_jax():
    """Serial PASTE of three slices and PASTE through 80-cell TRN references:
    aligned coordinates and the stored Procrustes mappings to 1e-4 of the
    coordinates' scale, the (saturated) plans to 1e-2 of theirs."""
    A, B, At, Bt, _ = _pair(100, 9)
    _, C, _ = make_slice_pair(n=100, angle_deg=35, shift=(1.0, 1.0), seed=9)
    Ct = adata_from_reference(C)
    mj, pj = st.align.paste_align([A.copy(), B.copy(), C.copy()], numItermax=30, verbose=False)
    mt, pt = stt.align.paste_align([At.copy(), Bt.copy(), Ct.copy()], numItermax=30, verbose=False, device="cpu")
    for a, b in zip(pt, pj):
        assert _scaled(a, b) <= SATURATED_PLAN_TOL
    scale = np.abs(np.asarray(A.obsm["spatial"])).max()
    for a, b in zip(mt, mj):
        assert _scaled(a.obsm["align_spatial"], b.obsm["align_spatial"]) <= 1e-4
        for key in ("tX", "tY"):
            np.testing.assert_allclose(a.uns["models_align"][key], b.uns["models_align"][key], atol=1e-4 * scale)
        np.testing.assert_allclose(a.uns["models_align"]["R"], b.uns["models_align"]["R"], atol=1e-4)
    rj, refj, pj = st.align.paste_align_ref([A.copy(), B.copy()], n_sampling=80, numItermax=30, verbose=False)
    rt, reft, pt = stt.align.paste_align_ref([At.copy(), Bt.copy()], n_sampling=80, numItermax=30, verbose=False,
                                             device="cpu")
    assert list(reft[1].obs_names) == list(refj[1].obs_names)
    assert _scaled(pt[0], pj[0]) <= SATURATED_PLAN_TOL
    for a, b in zip(rt, rj):
        assert _scaled(a.obsm["align_spatial"], b.obsm["align_spatial"]) <= 1e-4


def test_cell_directions_matches_jax():
    """The mapping of each A cell to its highest-probability B cell: equal
    on rows without a near-tie (all but a few), the displacement equal
    there, and the (saturated) plan to 1e-2 of scale."""
    A, B, At, Bt, _ = _pair(100, 12)
    for a in (A, B, At, Bt):
        a.obsm["align_spatial"] = np.asarray(a.obsm["spatial"]).copy()
    _, pj = st.tdr.cell_directions(A, B, numItermax=30)
    _, pt = stt.tdr.cell_directions(At, Bt, numItermax=30, device="cpu")
    assert _scaled(pt, pj) <= SATURATED_PLAN_TOL
    rows = _unambiguous_rows(np.asarray(pj))
    assert rows.mean() > 0.9
    np.testing.assert_array_equal(At.obsm["X_mapping"][rows], A.obsm["X_mapping"][rows])
    np.testing.assert_allclose(At.obsm["V_mapping"][rows], A.obsm["V_mapping"][rows], rtol=0, atol=0)


@pytest.mark.parametrize("keep_all", [False, True])
def test_mapping_helpers_match_jax(keep_all):
    """Host code on the same plan (with planted ties): equal outputs."""
    rng = np.random.default_rng(0)
    X, Y = rng.uniform(size=(30, 2)), rng.uniform(size=(25, 2))
    pi = np.round(rng.uniform(size=(30, 25)), 1)
    for a, b in zip(tau.get_optimal_mapping_relationship(X, Y, pi, keep_all),
                    jau.get_optimal_mapping_relationship(X, Y, pi, keep_all)):
        np.testing.assert_array_equal(a, b)
    for dt, dj in zip(tau.mapping_aligned_coords(X, Y, pi, keep_all), jau.mapping_aligned_coords(X, Y, pi, keep_all)):
        for k in dj:
            np.testing.assert_array_equal(dt[k], dj[k])
    mA, mB = (stt.AnnData(X=np.zeros((3, 1))) for _ in range(2))
    for m, s in ((mA, 1), (mB, 2)):
        r = np.random.default_rng(s)
        m.uns["c"] = {"raw_Y": r.uniform(size=(6, 2)), "mapping_Y": r.uniform(size=(6, 2)),
                      "pi_index": np.c_[r.permutation(6), np.arange(6)], "pi_value": r.uniform(size=6)}
    dt, dj = tau.mapping_center_coords(mA, mB, "c"), jau.mapping_center_coords(mA, mB, "c")
    for k in dj:
        np.testing.assert_array_equal(dt[k], dj[k])
    Xs, Ys, mp = stt.align.generalized_procrustes_analysis(X[:25], Y, pi[:25])
    Xj, Yj, mj = st.align.generalized_procrustes_analysis(X[:25], Y, pi[:25])
    np.testing.assert_array_equal(Ys, Yj)
    np.testing.assert_array_equal(mp["R"], mj["R"])


@pytest.mark.parametrize("shape,k,seed", [((100, 30), 6, 0), ((60, 45), 15, 3), ((120, 20), 4, 7)])
def test_klnmf_matches_sklearn(shape, k, seed):
    """`KLNMF` against scikit-learn's KL multiplicative-update NMF from the
    same random init: W, H and W @ H to 1e-6 relative, the same iterations
    (a 200-iteration run and ones that stop at the every-10 error test)."""
    from sklearn.decomposition import NMF

    rng = np.random.default_rng(seed)
    X = rng.gamma(0.5, 2.0, shape) * (rng.uniform(size=shape) > 0.3)
    m = NMF(n_components=k, solver="mu", beta_loss="kullback-leibler", init="random", random_state=seed)
    W, H = m.fit_transform(X), m.components_
    t = stt.align.methods.center_NMF(k, seed, "kl", device="cpu")
    Wt, Ht = t.fit_transform(X), t.components_
    assert t.n_iter_ == m.n_iter_
    assert _scaled(Wt @ Ht, W @ H) <= 1e-6
    assert _scaled(Wt, W) <= 1e-6 and _scaled(Ht, H) <= 1e-6


@pytest.mark.parametrize("shape,k,seed", [((120, 60), 5, 0), ((300, 200), 15, 3), ((80, 40), 8, 1), ((50, 30), 3, 2)])
def test_frobenius_nmf_matches_sklearn(shape, k, seed):
    """`FrobeniusNMF` (the center's NMF for every dissimilarity but KL)
    against ``sklearn.decomposition.NMF(k, init="random", random_state=seed)``
    (coordinate descent, Frobenius loss): W and H to 1e-10 of scale and the
    same `n_iter_`, on runs that stop at the violation test and runs of all
    200 iterations."""
    import warnings

    from sklearn.decomposition import NMF

    rng = np.random.default_rng(seed)
    X = rng.poisson(rng.gamma(0.5, 2.0, shape)).astype(float)
    m = NMF(n_components=k, init="random", random_state=seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        W, H = m.fit_transform(X), m.components_
    t = stt.align.methods.center_NMF(k, seed, "euclidean", device="cpu")
    assert isinstance(t, stt.align.methods.paste.FrobeniusNMF)
    Wt, Ht = t.fit_transform(X), t.components_
    assert t.n_iter_ == m.n_iter_
    assert _scaled(Wt, W) <= 1e-10 and _scaled(Ht, H) <= 1e-10


def test_paste_center_align_euclidean_matches_jax():
    """`paste_center_align(dissimilarity="euclidean")`: with no FGW round
    (max_iter 0) the center is the Frobenius NMF of the initial slice, W and
    H to 1e-10 of the JAX package's. With one round, euclidean expression
    costs saturate the entropic plans outright (M / eps ~ 1e3), so which entry
    of a row survives is set by rounding and the plans are not compared; the
    port's plans keep their marginals (each row sums to 1/n to 1e-3 of it)
    and the center stays finite."""
    A, B, At, Bt, _ = _pair(80, 10)
    kw = dict(n_components=6, numItermax=30, random_seed=0, verbose=False, dissimilarity="euclidean")
    cj, _ = st.align.paste_center_align(A.copy(), [B], max_iter=0, **kw)
    ct, _ = stt.align.paste_center_align(At.copy(), [Bt], max_iter=0, device="cpu", **kw)
    assert _scaled(ct.uns["paste_W"], cj.uns["paste_W"]) <= 1e-10
    assert _scaled(ct.uns["paste_H"], cj.uns["paste_H"]) <= 1e-10
    ct, pt = stt.align.paste_center_align(At.copy(), [Bt], max_iter=1, device="cpu", **kw)
    n = At.n_obs
    assert np.abs(pt[0].sum(axis=1) * n - 1).max() <= 1e-3
    assert np.isfinite(ct.X).all()


def test_paste_center_align_matches_jax():
    """The center loop (6 components, 3 iterations): the same starting
    factorization (the NMF equals scikit-learn's), the (saturated) pis to
    1e-2 of scale, the center's X = W @ H to 1e-4 of scale."""
    A, B, At, Bt, _ = _pair(80, 10)
    C, _, _ = make_slice_pair(n=80, seed=10)
    Ct = adata_from_reference(C)
    cj, pj = st.align.paste_center_align(A.copy(), [B, C], n_components=6, max_iter=3, numItermax=30, random_seed=0,
                                         verbose=False)
    ct, pt = stt.align.paste_center_align(At.copy(), [Bt, Ct], n_components=6, max_iter=3, numItermax=30,
                                          random_seed=0, verbose=False, device="cpu")
    for a, b in zip(pt, pj):
        assert _scaled(a, b) <= SATURATED_PLAN_TOL
    assert _scaled(ct.X, cj.X) <= 1e-4
    assert _scaled(ct.uns["paste_W"] @ ct.uns["paste_H"], cj.uns["paste_W"] @ cj.uns["paste_H"]) <= 1e-4


def test_exp_dissimilarity_and_empty_cache():
    rng = np.random.default_rng(0)
    XA, XB = rng.uniform(size=(20, 7)).astype(np.float32), rng.uniform(size=(15, 7)).astype(np.float32)
    D = stt.align.calc_exp_dissimilarity(XA, XB, device="cpu")
    assert _scaled(D, st.align.calc_exp_dissimilarity(XA, XB)) <= 1e-6
    stt.align.empty_cache("cpu")
    assert isinstance(torch.as_tensor(D), torch.Tensor)
