"""The Morpho slice of the port held against the JAX package on the CPU:
distances, the coarse fit, the flash E-step (dense, column-chunked, sparse
top-k, and the kernels' wrapper with its plain sweeps) and the EM from
carried-over state.

Inputs are made from a seed with numpy and handed to both packages. The JAX
Pallas E-step runs in interpret mode, as the JAX package's own tests run it.
Tolerances are relative to each output's largest magnitude unless stated;
they bound f32 sums taken in another order by XLA's CPU backend and
PyTorch's (GEMMs in other blockings, exp and log within a few ulps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spateo_tpu.alignment.methods import math as jm
from spateo_tpu.alignment.methods import morpho as jmorpho
from spateo_tpu.ops.estep_pallas import estep_pallas

from spateo_tpu_torch.alignment.methods import math as tm
from spateo_tpu_torch.alignment.methods import morpho as tmorpho
from spateo_tpu_torch.core.bridge import morpho_inputs_from_reference
from spateo_tpu_torch.ops import _build
from spateo_tpu_torch.ops import estep_cuda as ec

ESTEP_KEYS = ("K_NA", "K_NA_spatial", "K_NA_sigma2", "K_NB", "Sp", "sigma2_related", "PXB", "M1")


def T(x):
    return torch.from_numpy(np.array(x))


def _scaled_err(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return float(np.max(np.abs(ref - out)) / (np.max(np.abs(ref)) + 1e-30))


def _estep_inputs(case):
    """The two shapes the JAX package's Pallas tests use: 700 x 300, G=24,
    sigma2=0.4 (tests/test_ops.py:274), and 1600 x 600 Morton-ordered,
    G=12, sigma2=2e-4 (tests/test_ops.py:346)."""
    if case == "dense":
        rng = np.random.default_rng(0)
        NA, B, G = 700, 300, 24
        XAHat = rng.normal(size=(NA, 2)).astype(np.float32)
        coordsA = rng.normal(size=(NA, 2)).astype(np.float32)
        coordsB = rng.normal(size=(B, 2)).astype(np.float32)
        XA, XB = rng.poisson(2.0, (NA, G)).astype(np.float32), rng.poisson(2.0, (B, G)).astype(np.float32)
        mm = rng.uniform(0.5, 1, NA).astype(np.float32)
        scal = dict(sigma2=0.4, gamma=0.7, samples_s=3.0, sigma2_variance=1.5)
    else:
        rng = np.random.default_rng(1)
        NA, B, G = 1600, 600, 12
        pts = rng.uniform(0, 1, (NA, 2)).astype(np.float32)
        XAHat = pts[np.argsort(jm.morton_code(pts))]
        coordsA = XAHat.copy()
        ptsB = rng.uniform(0, 1, (B, 2)).astype(np.float32)
        coordsB = ptsB[np.argsort(jm.morton_code(ptsB))]
        XA, XB = rng.poisson(2.0, (NA, G)).astype(np.float32), rng.poisson(2.0, (B, G)).astype(np.float32)
        mm = rng.uniform(0.5, 1, NA).astype(np.float32)
        scal = dict(sigma2=2e-4, gamma=0.7, samples_s=1.0, sigma2_variance=2.0)
    return XAHat, coordsA, coordsB, XA, XB, mm, scal


@pytest.mark.parametrize("case", ["dense", "morton"])
def test_estep_reference_matches_jax(case):
    """`estep_reference` (the kernels' plain version, prologue and epilogue
    included) against the JAX Pallas E-step in interpret mode and the JAX
    dense `estep_reduced`: every reduction within 5e-4 of its scale, the
    JAX package's own bar between those two (tests/test_ops.py:297)."""
    XAHat, coordsA, coordsB, XA, XB, mm, s = _estep_inputs(case)
    a, b, A, Bf = jm.factorize_distance(XA, XB, "kl")
    J = jnp.asarray
    ref_dense = jm.estep_reduced(
        2.0, J(XAHat), J(coordsA), J(coordsB), (a,), (b,), (A,), (Bf,), J(s["sigma2"]), J(mm), J(s["gamma"]),
        J(s["samples_s"]), J(s["sigma2_variance"]), ["gauss"], [J(0.3)], n_chunks=1,
    )
    ref_pallas = estep_pallas(
        J(XAHat), J(coordsA), J(coordsB), a, b, A, Bf, J(mm), J(s["sigma2"]), J(s["gamma"]), J(s["samples_s"]),
        J(s["sigma2_variance"]), J(0.3), interpret=True,
    )
    ta, tb, tA, tB = tm.factorize_distance(XA, XB, "kl")
    out = ec.estep_reference(
        T(XAHat), T(coordsA), T(coordsB), ta, tb, tA, tB, T(mm), s["sigma2"], s["gamma"], s["samples_s"],
        s["sigma2_variance"], 0.3,
    )
    assert set(out) == set(ESTEP_KEYS)
    for k in ESTEP_KEYS:
        assert _scaled_err(ref_dense[k], out[k].numpy()) < 5e-4, k
        assert _scaled_err(ref_pallas[k], out[k].numpy()) < 5e-4, k
        assert out[k].shape == tuple(np.shape(ref_dense[k])), k


def test_estep_cuda_on_cpu_runs_the_plain_sweeps():
    """On CPU tensors the wrapper runs `colnorm_reference` and
    `rowred_reference`: bit-identical to `estep_reference`, and no launch
    is counted."""
    XAHat, coordsA, coordsB, XA, XB, mm, s = _estep_inputs("dense")
    args = (T(XAHat), T(coordsA), T(coordsB), *tm.factorize_distance(XA, XB, "kl"), T(mm),
            s["sigma2"], s["gamma"], s["samples_s"], s["sigma2_variance"], 0.3)
    before = (ec.colnorm.launches, ec.rowred.launches)
    out, ref = ec.estep_cuda(*args), ec.estep_reference(*args)
    assert (ec.colnorm.launches, ec.rowred.launches) == before
    for k in ESTEP_KEYS:
        assert torch.equal(out[k], ref[k]), k


def test_tile_skip_mask_is_conservative(monkeypatch):
    """The bounding-box prescreen flags a 64 x 64 tile only when every pair
    in it has d > _SKIP_MULT * sigma2 (checked against the dense distance
    matrix, ragged last tiles included); on Morton-ordered rows at a small
    sigma2 it flags most tiles; the constant is read at call time."""
    rng = np.random.default_rng(3)
    NA, B = 1500, 700
    pts = rng.uniform(0, 1, (NA, 2)).astype(np.float32)
    xa = T(pts[np.argsort(tm.morton_code(pts))])
    ptsB = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    cb = T(ptsB[np.argsort(tm.morton_code(ptsB))])
    sigma2 = torch.tensor(2e-4)
    skip = ec.tile_skip_mask(xa, cb, sigma2)
    n_ta, n_tb = -(-NA // ec.TM), -(-B // ec.TN)
    assert skip.dtype == torch.uint8 and skip.shape == (n_ta * n_tb,)
    d = tm.euc_dist(xa, cb)
    tile_min = torch.full((n_ta, n_tb), float("inf"))
    for i in range(n_ta):
        for j in range(n_tb):
            tile_min[i, j] = d[i * ec.TM:(i + 1) * ec.TM, j * ec.TN:(j + 1) * ec.TN].min()
    flagged = skip.reshape(n_ta, n_tb).bool()
    # 1e-6: the gap is exact, d has the expansion's rounding
    assert bool((tile_min[flagged] > ec._SKIP_MULT * 2e-4 - 1e-6).all())
    assert flagged.float().mean() > 0.3
    monkeypatch.setattr(ec, "_SKIP_MULT", 1e30)
    assert int(ec.tile_skip_mask(xa, cb, sigma2).sum()) == 0


def _layer_case(layers):
    """Factorised expression layers for `estep_reduced`, built by both
    packages from the same numpy inputs (tests/test_alignment.py:434-528,
    :630 use one kl layer; the others cover each metric and the label
    prior)."""
    rng = np.random.default_rng(7)
    NA, B, G = 157, 60, 8
    lt = rng.uniform(0.1, 1.0, (4, 5)).astype(np.float32)
    jf, tf, ptype, pparams = [], [], [], []
    for metric in layers:
        if metric == "label":
            X, Y = rng.integers(0, 4, (NA, 1)).astype(np.int32), rng.integers(0, 5, (B, 1)).astype(np.int32)
            ptype.append("prob")
            pparams.append(0.0)
        else:
            X, Y = rng.poisson(2.0, (NA, G)).astype(np.float32), rng.poisson(2.0, (B, G)).astype(np.float32)
            ptype.append("gauss" if metric != "cos" else "cos")
            pparams.append(0.3 if metric != "euc" else 8.0)
        jf.append(jm.factorize_distance(X, Y, metric, jnp.asarray(lt) if metric == "label" else None))
        tf.append(tm.factorize_distance(X, Y, metric, lt if metric == "label" else None))
    geo = dict(
        XAHat=rng.normal(size=(NA, 2)).astype(np.float32),
        coordsA=rng.normal(size=(NA, 2)).astype(np.float32),
        coordsB=rng.normal(size=(B, 2)).astype(np.float32),
        mm=rng.uniform(0.5, 1, NA).astype(np.float32),
    )
    return geo, jf, tf, ptype, pparams


@pytest.mark.parametrize("layers", [("kl",), ("euc", "kl"), ("cos",), ("kl", "label"), ("sym_kl",)])
@pytest.mark.parametrize("n_chunks,top_k", [(1, 0), (3, 0), (1, 12), (5, 12)])
def test_estep_reduced_matches_jax(layers, n_chunks, top_k):
    """The port's dense, column-chunked and sparse top-k E-step against the
    JAX package's, on CPU tensors: every reduction within 2e-4 of its scale
    (the bar of tests/test_alignment.py:476)."""
    geo, jf, tf, ptype, pparams = _layer_case(layers)
    J = jnp.asarray
    scal = dict(sigma2=0.4, gamma=0.7, samples_s=3.0, sigma2_variance=1.5)
    ref = jm.estep_reduced(
        2.0, J(geo["XAHat"]), J(geo["coordsA"]), J(geo["coordsB"]),
        tuple(f[0] for f in jf), tuple(f[1] for f in jf), tuple(f[2] for f in jf), tuple(f[3] for f in jf),
        J(scal["sigma2"]), J(geo["mm"]), J(scal["gamma"]), J(scal["samples_s"]), J(scal["sigma2_variance"]),
        list(ptype), [J(p) for p in pparams], n_chunks=n_chunks, sparse_top_k=top_k,
    )
    out = tm.estep_reduced(
        2.0, T(geo["XAHat"]), T(geo["coordsA"]), T(geo["coordsB"]),
        tuple(f[0] for f in tf), tuple(f[1] for f in tf), tuple(f[2] for f in tf), tuple(f[3] for f in tf),
        torch.tensor(scal["sigma2"]), T(geo["mm"]), torch.tensor(scal["gamma"]), torch.tensor(scal["samples_s"]),
        torch.tensor(scal["sigma2_variance"]), list(ptype), [torch.tensor(p) for p in pparams],
        n_chunks=n_chunks, sparse_top_k=top_k,
    )
    for k in ESTEP_KEYS:
        assert out[k].shape == tuple(np.shape(ref[k])), k
        assert _scaled_err(ref[k], out[k].numpy()) < 2e-4, (k, _scaled_err(ref[k], out[k].numpy()))


@pytest.mark.parametrize("metric", ["euc", "kl", "sym_kl", "cos", "label"])
def test_factorize_and_calc_distance_match_jax(metric):
    """`factorize_distance` factors (rtol 1e-5: elementwise f32), the
    distance it reconstructs, and `calc_distance` against the JAX package
    (5e-5 of scale: one GEMM in another blocking)."""
    rng = np.random.default_rng(11)
    lt = rng.uniform(0.1, 1.0, (3, 4)).astype(np.float32)
    if metric == "label":
        X, Y = rng.integers(0, 3, (40, 1)).astype(np.int32), rng.integers(0, 4, (30, 1)).astype(np.int32)
    else:
        X, Y = rng.poisson(2.0, (40, 9)).astype(np.float32), rng.poisson(2.0, (30, 9)).astype(np.float32)
    jl, tl = (jnp.asarray(lt), lt) if metric == "label" else (None, None)
    jfac = jm.factorize_distance(X, Y, metric, jl)
    tfac = tm.factorize_distance(X, Y, metric, tl)
    for a, b in zip(jfac, tfac):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    recon = tfac[0][:, None] + tfac[1][None, :] + tfac[2] @ tfac[3].T
    if metric == "label":
        X, Y = X.ravel(), Y.ravel()
    [dj] = jm.calc_distance(X, Y, metric, jl)
    [dt] = tm.calc_distance(X, Y, metric, tl)
    assert _scaled_err(dj, dt.numpy()) < 5e-5
    assert _scaled_err(dj, recon.numpy()) < 5e-5


@pytest.mark.parametrize("metric", ["square_euc", "cosine"])
def test_calc_distance_other_metrics(metric):
    rng = np.random.default_rng(12)
    X, Y = rng.normal(size=(25, 6)).astype(np.float32), rng.normal(size=(17, 6)).astype(np.float32)
    [dj] = jm.calc_distance(X, Y, metric)
    [dt] = tm.calc_distance(X, Y, metric)
    assert _scaled_err(dj, dt.numpy()) < 5e-5


@pytest.mark.parametrize("D", [2, 3])
def test_procrustes_rotation_matches_jax(D):
    """Closed form (D=2) and SVD with the det correction (D=3): the same
    rotation to 1e-5, and a proper rotation."""
    A = np.random.default_rng(D).normal(size=(D, D)).astype(np.float32)
    Rj = np.asarray(jm.procrustes_rotation(jnp.asarray(A)))
    Rt = tm.procrustes_rotation(T(A)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(Rt @ Rt.T, np.eye(D), atol=1e-5)
    assert np.linalg.det(Rt) > 0


def test_inlier_from_NN_kernel_matches_jax():
    """The 100-iteration robust rigid fit, the case of tests/test_ops.py:307
    (1900 valid rows padded to 2048, a third of them outliers): R atol 2e-5,
    t 2e-4, P 1e-3, weights 1e-5, sigma2 and gamma 1e-3 relative (the bars
    that test holds its Pallas variant to); the planted rotation is
    recovered."""
    rng = np.random.default_rng(0)
    n, N = 1900, 2048
    th = 0.4
    R_true = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    tx = rng.uniform(0, 5, (N, 2)).astype(np.float32)
    ty = (tx @ R_true.T + np.array([1.0, -2.0], np.float32)).astype(np.float32)
    ty[: n // 3] += rng.normal(0, 2.0, (n // 3, 2)).astype(np.float32)
    dist = rng.uniform(0, 3, (N, 1)).astype(np.float32)
    tx[n:], ty[n:], dist[n:] = tx[0], ty[0], dist[0]
    mask = np.zeros((N, 1), np.float32)
    mask[:n] = 1.0
    ref = jm._inlier_from_NN_kernel(jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(dist), jnp.asarray(mask),
                                    jnp.asarray(float(n)))
    P, R, t, w, s2, g = tm._inlier_from_NN_kernel(T(tx), T(ty), T(dist), T(mask), float(n))
    np.testing.assert_allclose(R.numpy(), np.asarray(ref[1]), atol=2e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(ref[2]), atol=2e-4)
    np.testing.assert_allclose(P.numpy().ravel(), np.asarray(ref[0]).ravel(), atol=1e-3)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref[3]), atol=1e-5)
    assert abs(float(s2) - float(ref[4])) < 1e-3 * max(float(ref[4]), 1e-3)
    assert abs(float(g) - float(ref[5])) < 1e-3
    np.testing.assert_allclose(R.numpy(), R_true, atol=0.05)


def test_inlier_fit_on_cpu_is_the_plain_loop():
    """On CPU tensors the kernel's wrapper runs `inlier_reference`, which
    `math._inlier_from_NN_kernel` also takes there: the same bits, no
    launch counted."""
    from spateo_tpu_torch.ops import inlier_cuda

    rng = np.random.default_rng(1)
    tx = rng.uniform(0, 5, (300, 2)).astype(np.float32)
    ty = (tx + np.array([0.5, -1.0], np.float32) + rng.normal(0, 0.1, (300, 2))).astype(np.float32)
    dist = rng.uniform(0, 3, (300, 1)).astype(np.float32)
    mask = np.ones((300, 1), np.float32)
    before = inlier_cuda.inlier_fit.launches
    a = inlier_cuda.inlier_fit(T(tx), T(ty), T(dist), T(mask), 300.0)
    b = tm._inlier_from_NN_kernel(T(tx), T(ty), T(dist), T(mask), 300.0)
    assert inlier_cuda.inlier_fit.launches == before
    for u, v in zip(a, b):
        assert bool(torch.isfinite(u).all()) and torch.equal(u, v)


def test_smallest_k_breaks_ties_like_jax_top_k():
    """Ties go to the lower index, as jax.lax.top_k(-D) breaks them."""
    D = np.array([[3.0, 1.0, 1.0, 2.0, 1.0], [0.5, 0.5, 0.5, 0.5, 0.1]], np.float32)
    nv, ni = jax.lax.top_k(-jnp.asarray(D), 3)
    v, i = tm.smallest_k(T(D), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ni))
    np.testing.assert_array_equal(v.numpy(), -np.asarray(nv))


@pytest.mark.parametrize("allow_flip", [False, True])
def test_coarse_match_fit_matches_jax(allow_flip):
    """The coarse-init chain on voxelised slices with padded rows: the same
    NN pairs exactly (voxel-averaged distances tie, ties resolved the same
    way), R and t within 1e-4, the inlier posterior within 1e-3."""
    rng = np.random.default_rng(5)
    n = 900
    pts = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    freqs = np.linspace(0.3, 2.0, 12)
    X = np.abs(np.stack([np.sin(pts[:, 0] * f) + np.cos(pts[:, 1] * f) for f in freqs], 1) + 2).astype(np.float32)
    th = 0.5
    R0 = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    ptsA = pts @ R0.T + np.array([1.0, -0.5], np.float32)
    cA, XA = tm.voxel_data(ptsA, X, voxel_num=100)
    cB, XB = tm.voxel_data(pts, X, voxel_num=100)
    n1, n2 = XA.shape[0], XB.shape[0]
    pad = lambda a: tm.pad_rows_bucket(a.astype(np.float32), 256)
    kw = dict(top_k=min(10, n1 - 1, n2 - 1), metric="kl", allow_flip=allow_flip)
    ref = jmorpho._coarse_match_fit(*(jnp.asarray(pad(a)) for a in (XA, XB, cA, cB)), jnp.asarray(n1),
                                    jnp.asarray(n2), **kw)
    out = tmorpho._coarse_match_fit(*(T(pad(a)) for a in (XA, XB, cA, cB)), n1, n2, **kw)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), atol=1e-3)
    np.testing.assert_allclose(out[3].numpy(), np.asarray(ref[3]), atol=1e-4)
    np.testing.assert_allclose(out[4].numpy(), np.asarray(ref[4]), atol=1e-4)
    assert bool(out[5]) == bool(ref[5])


def test_host_helpers_match_jax():
    """morton_code, pad_rows_bucket, voxel_data and normalize_coords are the
    JAX package's numpy code: identical results."""
    rng = np.random.default_rng(9)
    c = rng.uniform(-3, 7, (300, 2)).astype(np.float32)
    e = rng.poisson(2.0, (300, 5)).astype(np.float32)
    np.testing.assert_array_equal(tm.morton_code(c), jm.morton_code(c))
    np.testing.assert_array_equal(tm.pad_rows_bucket(c, 256), jm.pad_rows_bucket(c, 256))
    for a, b in zip(tm.voxel_data(c, e, voxel_num=40), jm.voxel_data(c, e, voxel_num=40)):
        np.testing.assert_array_equal(a, b)
    (ct, st, mt), (cj, sj, mj) = tm.normalize_coords([c, c[:100]]), jm.normalize_coords([c, c[:100]])
    for a, b in zip(ct + [st, mt], cj + [sj, mj]):
        np.testing.assert_array_equal(a, b)


def test_init_guess_sigma2_and_order_stat_match_jax():
    rng = np.random.default_rng(4)
    XA, XB = rng.normal(size=(300, 2)).astype(np.float32), rng.normal(size=(250, 2)).astype(np.float32)
    np.testing.assert_allclose(float(tm.init_guess_sigma2_dev(XA, XB, device="cpu")),
                               float(jm.init_guess_sigma2_dev(XA, XB)), rtol=1e-5)
    EA, EB = rng.poisson(2.0, (120, 7)).astype(np.float32), rng.poisson(2.0, (90, 7)).astype(np.float32)
    np.testing.assert_allclose(float(tm.min_dist_order_stat(T(EA), T(EB), 6)),
                               float(jm.min_dist_order_stat(jnp.asarray(EA), jnp.asarray(EB), 6)), rtol=1e-5)


def test_estep_chunks_cpu_matches_jax():
    """On the CPU both packages budget 16 GB, so they pick the same path."""
    for NA, B in ((20000, 2000), (200000, 20000), (800, 800)):
        assert tmorpho._estep_chunks(NA, B) == jmorpho._estep_chunks(NA, B)


def test_mesh_is_not_ported():
    """`mesh=` is ported (ROADMAP item 13; `tests/test_torch_parallel_morpho.py`
    holds it against JAX): what is not a `DeviceMesh` raises."""
    from bench import _mk_adata
    import spateo_tpu_torch as stt

    rng = np.random.default_rng(0)
    a = _mk_adata(stt, rng.uniform(0, 1, (30, 2)).astype(np.float32), rng.poisson(2.0, (30, 4)).astype(np.float32))
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmorpho.Morpho_pairwise(a, a, device="cpu", mesh=object())


def _slice_pair(n, g, seed, angle=0.3):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    freqs = np.linspace(0.3, 2.0, g)
    X = np.abs(np.stack([np.sin(pts[:, 0] * f) + np.cos(pts[:, 1] * f) for f in freqs], 1) + 2.0)
    X = (X + rng.uniform(0, 0.1, X.shape)).astype(np.float32)
    R = np.array([[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]], np.float32)
    ptsA = pts @ R.T + np.array([1.5, -0.8], np.float32)
    return pts, ptsA, X


@pytest.fixture(scope="module")
def jax_em_run():
    """One JAX solve (800 cells, batch 400, 50 iterations, non-rigid from
    iteration 20) with its `_morpho_em` call recorded."""
    import spateo_tpu as st
    from bench import _mk_adata

    pts, ptsA, X = _slice_pair(800, 15, 21)
    m = jmorpho.Morpho_pairwise(_mk_adata(st, ptsA, X), _mk_adata(st, pts, X), spatial_key="spatial",
                                key_added="align", max_iter=50, nonrigid_start_iter=20, batch_size=400,
                                verbose=False, seed=3)
    calls = []
    real = jmorpho._morpho_em

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    jmorpho._morpho_em = record
    try:
        m.run()
    finally:
        jmorpho._morpho_em = real
    [(args, kwargs, out)] = calls
    return m, args, kwargs, out


def test_morpho_em_from_reference_state(jax_em_run):
    """The port's `_morpho_em` from the JAX solver's own EM inputs, carried
    over by `morpho_inputs_from_reference`: R within 1e-4, t 1e-4, sigma2
    and gamma 1e-3 relative, XAHat within 1e-4 of the coordinate scale
    (which is 1 after normalisation). This separates the EM's parity from
    the coarse init's."""
    m, args, kwargs, (s_j, Ro_j, to_j, RnA_j) = jax_em_run
    carried = morpho_inputs_from_reference(m, args, kwargs)
    assert carried["static"]["use_kernel_estep"] is False  # the JAX package ran without Pallas on the CPU

    def tens(v):
        return tuple(tens(x) for x in v) if isinstance(v, tuple) else torch.from_numpy(v)

    inputs = {k: tens(v) for k, v in carried["args"].items()}
    s, Ro, to, RnA = tmorpho._morpho_em(**inputs, **carried["static"])
    np.testing.assert_allclose(s["R"].numpy(), np.asarray(s_j["R"]), atol=1e-4)
    np.testing.assert_allclose(s["t"].numpy(), np.asarray(s_j["t"]), atol=1e-4)
    np.testing.assert_allclose(float(s["sigma2"]), float(s_j["sigma2"]), rtol=1e-3)
    np.testing.assert_allclose(float(s["gamma"]), float(s_j["gamma"]), rtol=1e-3)
    np.testing.assert_allclose(s["XAHat"].numpy(), np.asarray(s_j["XAHat"]), atol=1e-4)
    np.testing.assert_allclose(Ro.numpy(), np.asarray(Ro_j), atol=1e-4)
    np.testing.assert_allclose(RnA.numpy(), np.asarray(RnA_j), atol=1e-4)
    np.testing.assert_array_equal(s["batch_idx"].numpy(), np.asarray(s_j["batch_idx"]))
    assert carried["invA"].shape == (800,)


def test_build_hash_covers_included_headers(tmp_path):
    """An edited header included with quotes (directly or through another
    header) changes the library's hash, so a stale library is never
    loaded; an unchanged tree keeps it."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include "cuda_fp16.h"\n__global__ void k() {}\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#define X 1\n")
    first = _build.source_digest(tmp_path / "k.cu")
    assert _build.source_digest(tmp_path / "k.cu") == first
    (tmp_path / "b.cuh").write_text("#define X 2\n")
    second = _build.source_digest(tmp_path / "k.cu")
    assert second != first
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n// edited\n')
    assert _build.source_digest(tmp_path / "k.cu") != second
    assert _build.source_digest(tmp_path / "k.cu", flags=("-O2",)) != _build.source_digest(tmp_path / "k.cu")
    with pytest.raises(FileNotFoundError):
        _build.source_digest(tmp_path / "missing.cu")


# -- the 3xTF32 arithmetic the E-step kernels were measured with, and the card defaults


def test_tf32_split_rounds_to_nearest_away_and_keeps_f32():
    """`tf32_split` is cvt.rna.tf32 twice: hi keeps 10 mantissa bits (low 13
    bits zero), a tie rounds away from zero, and hi + lo is x to 2^-21 of
    |x| (lo keeps 11 of the 13 dropped bits)."""
    ties = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 3 * 2**-11, 2.0 + 2**-10], dtype=torch.float32)
    hi, lo = ec.tf32_split(ties)
    np.testing.assert_array_equal(hi.numpy(), np.array([1 + 2**-10, -(1 + 2**-10), 1 + 2**-9, 2.0 + 2**-9], np.float32))
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 10, 10000).astype(np.float32))
    hi, lo = ec.tf32_split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0**-21 * x.double().abs()).all())


@pytest.mark.parametrize("G", [18, 50, 100])
def test_dot_3xtf32_matches_f64_dot(G):
    """The expression dot in 3xTF32 with round-to-nearest sums
    (`dot_3xtf32`) on the E-step's kl factors of Poisson counts, G + 1 =
    19, 51, 101 features with the a-row appended: within 2e-6 of the f64
    dot's scale (sum_g |fat| |fbt|), as close as the f32 dot itself, so the
    split loses nothing; plain TF32 (hi.hi alone) misses by more than 1e-4
    of the scale."""
    rng = np.random.default_rng(G)
    XA, XB = rng.poisson(2.0, (300, G)).astype(np.float32), rng.poisson(2.0, (130, G)).astype(np.float32)
    a, b, A, Bf = tm.factorize_distance(T(XA), T(XB), "kl")
    fat = torch.cat([A.T, a[None]])
    fbt = torch.cat([Bf.T, torch.ones((1, 130))])
    exact = fat.double().T @ fbt.double()
    scale = float((fat.double().abs().T @ fbt.double().abs()).max())
    e3 = ec.dot_3xtf32(fat.T, fbt)
    err3 = float((e3.double() - exact).abs().max()) / scale
    err32 = float(((fat.T @ fbt).double() - exact).abs().max()) / scale
    (ah, _), (bh, _) = ec.tf32_split(fat.T), ec.tf32_split(fbt)
    err_tf32 = float(((ah @ bh).double() - exact).abs().max()) / scale
    assert err3 < 2e-6 and err3 < 4 * err32 + 1e-7, (err3, err32)
    assert err_tf32 > 1e-4, err_tf32


def test_inlier_from_NN_on_cpu_matches_jax():
    """The host-facing coarse fit with device="cpu" against the JAX
    package's `inlier_from_NN` (1,500 matches, padded to 2,048 by both): the
    bars of the kernel-level test."""
    rng = np.random.default_rng(5)
    n = 1500
    th = 0.4
    R_true = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    tx = rng.uniform(0, 5, (n, 2)).astype(np.float32)
    ty = (tx @ R_true.T + np.array([1.0, -2.0], np.float32)).astype(np.float32)
    ty[: n // 3] += rng.normal(0, 2.0, (n // 3, 2)).astype(np.float32)
    dist = rng.uniform(0, 3, (n, 1)).astype(np.float32)
    P, R, t, w, s2, g = tm.inlier_from_NN(tx, ty, dist, device="cpu")
    Pj, Rj, tj, wj, s2j, gj = jm.inlier_from_NN(tx, ty, dist)
    assert P.shape == np.shape(Pj) and w.shape == np.shape(wj)
    np.testing.assert_allclose(R, np.asarray(Rj), atol=2e-5)
    np.testing.assert_allclose(t, np.asarray(tj), atol=2e-4)
    np.testing.assert_allclose(P, np.asarray(Pj), atol=1e-3)
    np.testing.assert_allclose(w, np.asarray(wj), atol=1e-5)
    assert abs(s2 - float(s2j)) < 1e-3 * max(float(s2j), 1e-3) and abs(g - float(gj)) < 1e-3
    np.testing.assert_allclose(R, R_true, atol=0.05)


def test_entry_points_default_to_the_card(monkeypatch):
    """`inlier_from_NN` and `init_guess_sigma2` run on the card unless the
    caller asks for the CPU, as every entry point of the port does; a
    tensor argument keeps its own device."""
    import inspect

    assert inspect.signature(tm.inlier_from_NN).parameters["device"].default == "cuda"

    class Stop(Exception):
        pass

    seen = []

    def record(x, device=None):
        seen.append(torch.device(device))
        raise Stop

    monkeypatch.setattr(tm, "as_tensor", record)
    XA = np.zeros((5, 2), np.float32)
    for call in (tm.init_guess_sigma2, tm.init_guess_sigma2_dev):
        with pytest.raises(Stop):
            call(XA, XA)
    with pytest.raises(Stop):
        tm.init_guess_sigma2_dev(torch.from_numpy(XA), XA)
    assert [d.type for d in seen] == ["cuda", "cuda", "cpu"]
