"""The port's mesh correction (`stt.align.Mesh_correction`, its batched cost
tables, ICP and sections, `native.fastpd`), coarse alignment
(`stt.tl.procrustes`, `align_slices_pca`) and the alpha-shape hull against
the JAX package's, on the CPU.

Bars:

- ICP: gamma equal, R, t and the aligned points to 1e-12 (measured 4.4e-15
  over the pairs of `test_icp_matches_jax`).
- Sections of a transformed mesh: equal, point for point, in order.
- Cost tables: equal, entry for entry, except where one of an entry's ICPs
  meets a degenerate cross-covariance: every inlier matched to one contour
  point, so the centred targets are rounding noise and the 2x2 SVD's
  rotation is set by that noise (numpy's BLAS and torch round it
  differently). `test_cost_tables_match_jax` replays each differing entry's
  ICPs with the reference loop and requires one of them to be degenerate;
  on the end-to-end case 1 of 250 entries is.
- The MRF labels: equal (the same C++ source).
- The end-to-end case (tests/test_mesh_correction.py:92): best loss and
  transformation equal, corrected coordinates to 1e-12.
"""

import itertools

import numpy as np
import pytest
import torch
from scipy.spatial import ConvexHull, cKDTree

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.alignment.methods import mesh_correction as J
from spateo_tpu_torch.alignment.methods import mesh_correction as T
from spateo_tpu_torch.core.bridge import adata_from_reference

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU among its
    workers, where torch's thread pools only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring_pair(rng):
    n1, n2 = rng.integers(20, 700, 2)
    th = rng.uniform(0, 2 * np.pi, n1)
    a = np.c_[np.cos(th), np.sin(th)] * rng.uniform(0.5, 2)
    th2 = rng.uniform(0, 2 * np.pi, n2)
    b = np.c_[np.cos(th2), 0.8 * np.sin(th2)] + rng.normal(0, 0.1, 2)
    return a, b


@pytest.mark.parametrize("allow_rotation", [True, False])
@pytest.mark.parametrize("subsample, max_iter", [(200, 10), (500, 20)])
def test_icp_matches_jax(allow_rotation, subsample, max_iter):
    """60 random pairs through the port's `ICP` (one batch each) and the JAX
    package's."""
    rng = np.random.default_rng(0)
    for _ in range(60):
        a, b = _ring_pair(rng)
        rj = J.ICP(a, b, allow_rotation=allow_rotation, subsample=subsample, max_iter=max_iter)
        rt = T.ICP(a, b, allow_rotation=allow_rotation, subsample=subsample, max_iter=max_iter, device="cpu")
        assert rt[0] == rj[0]
        for k in (2, 4, 5):
            np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=TOL)
        np.testing.assert_array_equal(rt[3], rj[3])


def test_icp_batch_equals_a_loop_of_single_icps():
    """One [B, N, 2] batch of 50 ragged problems gives each member's own
    answer: padding and per-member stops never reach another member."""
    rng = np.random.default_rng(1)
    pairs = [_ring_pair(rng) for _ in range(50)]
    c1, c2 = [], []
    for a, b in pairs:
        i1, i2 = T._subsample_draws(len(a), len(b), 200)
        c1.append(a if i1 is None else a[i1])
        c2.append(b if i2 is None else b[i2])
    gamma, t, aligned, R = T._icp_batch(*T._padded(c1, "cpu"), *T._padded(c2, "cpu"), max_iter=10, allow_rotation=True)
    for k, (a, b) in enumerate(pairs):
        rj = J.ICP(a, b, allow_rotation=True, subsample=200, max_iter=10)
        assert float(gamma[k]) == rj[0]
        np.testing.assert_allclose(t[k].numpy(), rj[2], rtol=0, atol=TOL)
        np.testing.assert_allclose(R[k].numpy(), rj[5], rtol=0, atol=TOL)
        np.testing.assert_allclose(aligned[k, : len(c2[k])].numpy(), rj[4], rtol=0, atol=TOL)


def _ellipsoid_mesh(mod, n=400, seed=0):
    rng = np.random.default_rng(seed)
    sp = rng.normal(size=(n, 3))
    sp /= np.linalg.norm(sp, axis=1, keepdims=True)
    sp = sp * np.array([1.0, 0.8, 0.6])
    return mod.tdr.models.mesh_core.Mesh(sp, ConvexHull(sp).simplices) if mod is st else \
        stt.tdr.models.mesh_core.Mesh(sp, ConvexHull(sp).simplices)


def test_transforms_and_sections_match_jax():
    mesh = _ellipsoid_mesh(st)
    rng = np.random.default_rng(3)
    z = np.linspace(-0.45, 0.45, 6)
    for _ in range(8):
        rot, tr, sc = rng.uniform(-30, 30, 3), rng.uniform(-0.2, 0.2), rng.uniform(0.8, 1.2)
        pj = J._transform_points(mesh.points, rot, tr, sc)
        np.testing.assert_array_equal(T._transform_points(mesh.points, rot, tr, sc), pj)
        sj, okj = J._extract_contours_from_mesh(pj, mesh.faces, z)
        s_t, okt = T._extract_contours_from_mesh(pj, mesh.faces, z, device="cpu")
        assert okt == okj
        for a, b in zip(s_t, sj):
            np.testing.assert_array_equal(a, b)
        # the batched transform agrees with the host one to rounding
        params = np.r_[rot, tr, sc][None]
        R = torch.as_tensor(np.stack([T._rotation(p[:3]) for p in params]))
        P = torch.as_tensor(mesh.points)
        f64 = lambda v: torch.tensor([v], dtype=torch.float64)  # noqa: E731
        tp = T._transform_batch(P, torch.as_tensor(mesh.points.mean(0)), R, f64(tr), f64(sc))
        np.testing.assert_allclose(tp[0].numpy(), pj, rtol=0, atol=TOL)
    _, ok = T._extract_contours_from_mesh(mesh.points, mesh.faces, [2.0], device="cpu")
    assert not ok


def _slices(mod, seed=0):
    """tests/test_mesh_correction.py:92's four drifted ellipse sections."""
    rng = np.random.default_rng(seed)
    rng.normal(size=(400, 3))  # the mesh's draw
    z_heights = np.linspace(-0.45, 0.45, 4)
    slices, shifts = [], []
    for z in z_heights:
        a = np.sqrt(max(1 - (z / 0.6) ** 2, 1e-6))
        th = rng.uniform(0, 2 * np.pi, 400)
        rr = np.sqrt(rng.uniform(0, 1, 400))
        pts = np.stack([a * rr * np.cos(th), 0.8 * a * rr * np.sin(th)], 1)
        shift = rng.uniform(-0.15, 0.15, 2)
        shifts.append(shift)
        ad = mod.AnnData(X=np.ones((400, 2), np.float32))
        mod.SKM.init_adata_type(ad, "UMI")
        ad.obsm["spatial"] = pts + shift
        slices.append(ad)
    return slices, z_heights, shifts


def _mesh_correction(mod, **extra):
    slices, z_heights, shifts = _slices(mod)
    kw = dict(label_num=5, fastpd_iter=30, max_iter=2, max_rotation_angle=15, max_translation_scale=0.2,
              max_scaling=1.15, **extra)
    mc = mod.align.Mesh_correction(slices, z_heights, _ellipsoid_mesh(mod), **kw)
    mc.extract_contours(alpha_shape_kwargs={"alpha": 2.0})
    return mc, shifts


def _icp_meets_degenerate_covariance(c1, c2, subsample=200, max_iter=10):
    """Replay the reference ICP loop (mesh_correction.py:142-207 in the JAX
    package) and report whether an iteration matched every inlier to one
    data point."""
    i1, i2 = T._subsample_draws(len(c1), len(c2), subsample)
    c1 = c1 if i1 is None else c1[i1]
    c2 = c2 if i2 is None else c2[i2]
    m1, m2 = (c1.max(0) + c1.min(0)) / 2, (c2.max(0) + c2.min(0)) / 2
    c1d, c2d = c1 - m1, c2 - m2
    scale = max((np.sqrt((c1d**2).sum() / len(c1d)) + np.sqrt((c2d**2).sum() / len(c2d))) / 2, 1e-12)
    c1d, T2 = c1d / scale, c2d / scale
    tree, prev = cKDTree(c1d), np.inf
    for _ in range(max_iter):
        dist, idx = tree.query(T2)
        inl = dist < 0.1
        if inl.sum() < 3:
            return False
        if len(np.unique(idx[inl])) == 1:
            return True
        src, dst = T2[inl], c1d[idx[inl]]
        sm, dm = src.mean(0), dst.mean(0)
        U, _, Vt = np.linalg.svd((src - sm).T @ (dst - dm))
        R = Vt.T @ U.T
        if np.linalg.det(R) < 0:
            Vt[-1] *= -1
            R = Vt.T @ U.T
        T2 = T2 @ R.T + dm - R @ sm
        err = dist[inl].mean()
        if abs(prev - err) < 1e-6:
            return False
        prev = err
    return False


def test_cost_tables_match_jax():
    mj, _ = _mesh_correction(st)
    mt, _ = _mesh_correction(stt, device="cpu")
    for a, b in zip(mt.contours, mj.contours):
        np.testing.assert_array_equal(a, b)
    mj.max_translation = mj.max_translation_scale * mj.slices_scale
    mj.best_transformation = {"rotation": np.zeros(3), "translation": 0.0, "scaling": 1.0}
    labels = mj.generate_labels()
    mt.contours_subsample, mt.z_heights_subsample = mt.contours, mt.z_heights
    pairs = J._make_pairs()
    tables = mt.binary_tables(labels, pairs)
    L = len(labels)
    n_diff = 0
    for pair, got in zip(pairs, tables):
        ref = J._get_binary_values(mj.contours, mj.mesh_points, mj.mesh_faces, mj.z_heights, pair, labels)
        assert got.dtype == np.float32 and got.shape == (L, L)
        for a, b in zip(*np.nonzero(got != ref)):
            n_diff += 1
            p = T._pair_params(labels, pair)[a * L + b]
            tp = J._transform_points(mj.mesh_points, p[:3], p[3], p[4])
            secs, _ = J._extract_contours_from_mesh(tp, mj.mesh_faces, mj.z_heights)
            assert any(_icp_meets_degenerate_covariance(c, s) for c, s in zip(mj.contours, secs)), (pair, a, b)
    assert n_diff <= 0.01 * len(pairs) * L * L
    one = T._get_binary_values(mt.contours, mt.mesh_points, mt.mesh_faces, mt.z_heights, pairs[0], labels, "cpu")
    np.testing.assert_array_equal(one, tables[0])


def test_losses_of_a_transform_missing_a_plane_are_1e6():
    mt, _ = _mesh_correction(stt, device="cpu")
    params = np.array([[0, 0, 0, 5.0, 1.0], [0, 0, 0, 0.0, 1.0]])
    losses = T._losses(mt.contours, mt.mesh_points, mt.mesh_faces, mt.z_heights, params, "cpu").numpy()
    assert losses[0] == 1e6 and 0 <= losses[1] < 1
    ref = J._calculate_loss(mt.contours, mt.mesh_points, mt.mesh_faces, params[1], mt.z_heights)
    assert T._calculate_loss(mt.contours, mt.mesh_points, mt.mesh_faces, params[1], mt.z_heights,
                             device="cpu") == ref


def test_end_to_end_matches_jax():
    """tests/test_mesh_correction.py:92 through both packages."""
    mj, shifts = _mesh_correction(st)
    mt, _ = _mesh_correction(stt, device="cpu")
    mj.run_discrete_optimization()
    mt.run_discrete_optimization()
    assert mt.best_loss == mj.best_loss and mt.losses == mj.losses
    for k in ("rotation", "translation", "scaling"):
        np.testing.assert_array_equal(mt.best_transformation[k], mj.best_transformation[k])
    assert len(mt.step_stats) == 2 and all(s["icps"] == 10 * 25 * 4 for s in mt.step_stats)
    oj, ot = mj.perform_correction(), mt.perform_correction()
    for a, b in zip(ot, oj):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    resid = np.mean([np.linalg.norm(np.asarray(o)[:, :2].mean(0)) for o in ot])
    assert resid < np.mean([np.linalg.norm(s) for s in shifts])


def test_validation_errors():
    rng = np.random.default_rng(0)
    sp = rng.normal(size=(50, 3))
    mesh = stt.tdr.Mesh(sp, ConvexHull(sp).simplices)
    ad = stt.AnnData(X=np.ones((5, 2), np.float32))
    stt.SKM.init_adata_type(ad, "UMI")
    ad.obsm["spatial"] = np.zeros((5, 2))
    with pytest.raises(ValueError, match="unique"):
        stt.align.Mesh_correction([ad, ad], [1.0, 1.0], mesh, device="cpu")
    with pytest.raises(ValueError, match="same length"):
        stt.align.Mesh_correction([ad, ad], [1.0, 2.0, 3.0], mesh, device="cpu")


@pytest.mark.parametrize("L, N, seed", [(5, 4, 0), (4, 3, 1), (15, 5, 2)])
def test_fastpd_matches_jax(L, N, seed):
    from spateo_tpu.native import fastpd as jfastpd
    from spateo_tpu_torch.native import fastpd as tfastpd

    rng = np.random.default_rng(seed)
    pairs = np.array(list(itertools.combinations(range(N), 2)), np.int32)
    u = rng.uniform(0, 1, (L, N)).astype(np.float32)
    b = rng.uniform(0, 1, (len(pairs), L, L)).astype(np.float32)
    np.testing.assert_array_equal(tfastpd(u, list(b), pairs, 100), jfastpd(u, list(b), pairs, 100))
    with pytest.raises(ValueError, match="binaries"):
        tfastpd(u, list(b[:-1]), pairs)


def test_alpha_shape_matches_jax():
    rng = np.random.default_rng(4)
    th = rng.uniform(0, 2 * np.pi, 500)
    rr = np.sqrt(rng.uniform(0, 1, 500))
    x, y = rr * np.cos(th), 0.7 * rr * np.sin(th)
    for alpha in (0.5, 2.0, 50.0):
        rj, ej = st.io.alpha_shape(x, y, alpha=alpha)
        rt, et = stt.io.alpha_shape(x, y, alpha=alpha)
        assert len(rt) == len(rj)
        for a, b in zip(rt, rj):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(et, ej)


def test_procrustes_matches_jax():
    """test_tools.py::TestMisc::test_procrustes through both packages, and
    the reflection, no-scaling and lower-dimension branches."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 2))
    th = 0.6
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    Y = 0.5 * X @ R.T + np.array([2.0, -1.0])
    for kw in ({}, {"scaling": False}, {"reflection": False}, {"reflection": True}):
        dj, Zj, tj = st.tl.procrustes(X, Y, **kw)
        dt, Zt, tt = stt.tl.procrustes(X, Y, **kw)
        assert dt == pytest.approx(dj, abs=1e-12)
        np.testing.assert_allclose(Zt, Zj, rtol=0, atol=1e-12)
        for k in ("rotation", "translation"):
            np.testing.assert_allclose(tt[k], tj[k], rtol=0, atol=1e-12)
    d, Z, _ = stt.tl.procrustes(X, Y)
    assert d < 1e-10 and np.allclose(Z, X, atol=1e-8)
    X3 = rng.normal(size=(30, 3))
    dj, Zj, _ = st.tl.procrustes(X3, X3[:, :2] * 2)
    dt, Zt, _ = stt.tl.procrustes(X3, X3[:, :2] * 2)
    np.testing.assert_allclose(Zt, Zj, rtol=0, atol=1e-12)


def test_align_slices_pca_and_affine_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(300, 2)) * np.array([3.0, 1.0])
    th = 0.9
    pts = pts @ np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]).T + 5
    a = st.AnnData(X=np.ones((300, 2), np.float32))
    st.SKM.init_adata_type(a, "UMI")
    a.obsm["spatial"] = pts
    b = adata_from_reference(a)
    oj = st.tl.align_slices_pca(a)
    ot = stt.tl.align_slices_pca(b)
    np.testing.assert_array_equal(ot.obsm["spatial_pca"], oj.obsm["spatial_pca"])
    np.testing.assert_array_equal(ot.uns["pca_align_R"], oj.uns["pca_align_R"])
    assert "spatial_pca" not in b.obsm
    stt.tl.align_slices_pca(b, inplace=True, result_key="aligned")
    np.testing.assert_array_equal(b.obsm["aligned"], oj.obsm["spatial_pca"])
    for got, ref in zip(stt.tl.AffineTrans(pts[:, 0], pts[:, 1], 5.0, 5.0, theta=0.3),
                        st.tl.AffineTrans(pts[:, 0], pts[:, 1], 5.0, 5.0, theta=0.3)):
        np.testing.assert_array_equal(got, ref)


def test_chip_smoke_mesh_correction_helpers_on_the_cpu():
    """`chip_smoke.py` phase 20's stack and run at a tiny size: the drift
    falls after the correction, and the step's stats are all there."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    mc, shifts, seconds, resid, drift = chip_smoke.mesh_correction_run("cpu", 3, 300, 3, 1, n_surface=300)
    assert len(shifts) == 3 and len(seconds) == 3 and resid < drift
    assert set(mc.step_stats[0]) == {"sections_s", "icps", "tables_s", "fastpd_s", "loss_s", "step_s"}
    assert mc.step_stats[0]["icps"] == 10 * 9 * 3
