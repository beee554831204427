"""The port's morphofield layer (`stt.tdr`) and the Morpho field transforms
(`stt.align.BA_transform`, `get_P_chunk`, `morpho_align_ref`) against the
JAX package on the CPU.

Fields are learned once by the JAX package and carried over with
`core.bridge.vfc_from_reference` / `vecfld_from_reference`, so both packages
evaluate the same field: Jacobians (forward-mode autodiff and central
differences) agree to 1e-4 of their scale, field transforms to 1e-5. The
whole `morpho_align_ref` chain is held to `test_torch_align.py`'s bar, 2e-3
on a 10-unit box.
"""

import numpy as np
import pandas as pd
import pytest

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.alignment.methods.morpho import Morpho_pairwise as JMorpho
from spateo_tpu.tdr.morphometrics.morphofield.gaussian_process import morphofield_gp as j_morphofield_gp
from spateo_tpu.tdr.morphometrics.morphofield_dg.GPVectorField import GPVectorField as JGPVectorField
from spateo_tpu_torch.core.bridge import vecfld_from_reference, vfc_from_reference
from spateo_tpu_torch.tdr.morphometrics.morphofield_dg.GPVectorField import GPVectorField as TGPVectorField

JAC_TOL = 1e-4  # of the Jacobian's scale
FIELD_TOL = 1e-5
COORD_TOL = 2e-3


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _adata(pkg, X, V=None, spatial_key="align_spatial", expr=None, genes=None):
    n = len(X)
    expr = np.ones((n, 3), np.float32) if expr is None else expr
    genes = genes or [f"g{j}" for j in range(expr.shape[1])]
    a = pkg.AnnData(X=expr.copy(), obs=pd.DataFrame(index=[f"c{i}" for i in range(n)]),
                    var=pd.DataFrame(index=genes))
    pkg.SKM.init_adata_type(a, "UMI")
    a.obsm[spatial_key] = X.copy()
    if V is not None:
        a.obsm["V_mapping"] = V.copy()
    return a


@pytest.fixture(scope="module")
def rotation():
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    V = np.cross(np.broadcast_to([0.0, 0.0, 1.0], X.shape), X).astype(np.float32)
    return X, V


@pytest.fixture(scope="module")
def sparsevfc_pair(rotation):
    """A JAX-learned SparseVFC morphofield on the rotation data, stored in a
    JAX AnnData and carried over into a port AnnData."""
    X, V = rotation
    aj = _adata(st, X, V)
    st.tdr.morphofield_sparsevfc(aj, NX=X[:10], M=80, lambda_=0.1, restart_num=2, min_vel_corr=0.5)
    at = _adata(stt, X, V)
    at.uns["VecFld_morpho"] = vfc_from_reference(aj.uns["VecFld_morpho"])
    return aj, at


def test_vfc_from_reference_carries_the_field(sparsevfc_pair):
    aj, at = sparsevfc_pair
    vj, vt = aj.uns["VecFld_morpho"], at.uns["VecFld_morpho"]
    assert "_device" not in vt and set(vt) == set(vj) - {"_device"}
    for k in ("X", "V", "C", "X_ctrl", "P"):
        assert isinstance(vt[k], np.ndarray)
        np.testing.assert_array_equal(vt[k], np.asarray(vj[k]))
    assert vt["beta"] == vj["beta"] and vt["method"] == "sparsevfc"


@pytest.mark.parametrize("method", ["analytical", "numerical"])
def test_gpvectorfield_jacobians_match_jax(sparsevfc_pair, method):
    aj, at = sparsevfc_pair
    vj, vt = JGPVectorField(), TGPVectorField(device="cpu")
    vj.from_adata(aj, vf_key="VecFld_morpho")
    vt.from_adata(at, vf_key="VecFld_morpho")
    X = vj.get_X()[:100]
    Jj, Jt = vj.get_Jacobian(method=method)(X), vt.get_Jacobian(method=method)(X)
    assert Jt.shape == (100, 3, 3)
    assert _scaled(Jt, Jj) <= JAC_TOL
    assert _scaled(vt.compute_velocity(X), vj.compute_velocity(X)) <= FIELD_TOL
    assert _scaled(vt.compute_sensitivity(X, method=method), vj.compute_sensitivity(X, method=method)) <= 1e-3


def test_numerical_matches_analytical(sparsevfc_pair):
    """The JAX tests' cross-check of the two schemes (tests/test_tdr.py:185)."""
    _, at = sparsevfc_pair
    vf = TGPVectorField(device="cpu")
    vf.from_adata(at, vf_key="VecFld_morpho")
    X = vf.get_X()[:50]
    np.testing.assert_allclose(vf.get_Jacobian("numerical")(X), vf.get_Jacobian("analytical")(X), rtol=0.05, atol=5e-3)


WRAPPERS = {
    "velocity": (lambda pkg, a, **k: pkg.tdr.morphofield_velocity(a, **k), [("obsm", "velocity")]),
    "acceleration": (lambda pkg, a, **k: pkg.tdr.morphofield_acceleration(a, **k),
                     [("obsm", "acceleration"), ("obs", "acceleration")]),
    "curvature": (lambda pkg, a, **k: pkg.tdr.morphofield_curvature(a, **k),
                  [("obsm", "curvature"), ("obs", "curvature")]),
    "curl": (lambda pkg, a, **k: pkg.tdr.morphofield_curl(a, **k), [("obsm", "curl"), ("obs", "curl")]),
    "torsion": (lambda pkg, a, **k: pkg.tdr.morphofield_torsion(a, **k), [("uns", "torsion"), ("obs", "torsion")]),
    "divergence": (lambda pkg, a, **k: pkg.tdr.morphofield_divergence(a, **k), [("obs", "divergence")]),
    "jacobian": (lambda pkg, a, **k: pkg.tdr.morphofield_jacobian(a, **k),
                 [("uns", "jacobian"), ("obs", "jacobian_det")]),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_match_jax(sparsevfc_pair, name):
    """Each of the seven `morphofield_*` wrappers on the carried-over field:
    every output within 1e-4 of its scale (curvature and torsion, which
    divide by |v|^2 and |v x a|^2 near the rotation axis, within 1e-3)."""
    aj, at = sparsevfc_pair
    aj, at = aj.copy(), at.copy()
    fn, outs = WRAPPERS[name]
    fn(st, aj)
    fn(stt, at, device="cpu")
    tol = 1e-3 if name in ("curvature", "torsion") else JAC_TOL
    for field, key in outs:
        got = np.asarray(getattr(at, field)[key], np.float64)
        ref = np.asarray(getattr(aj, field)[key], np.float64)
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert _scaled(got, ref) <= tol, (field, key, _scaled(got, ref))


def test_rotation_constants_through_the_wrappers(rotation):
    """The JAX tests' bars (tests/test_tdr.py:148-220) on the port alone:
    for v = omega x r, curl = 2 omega and div ~ 0; `morphopath` keeps the
    radius from the z axis."""
    X, V = rotation
    a = _adata(stt, X, V)
    stt.tdr.morphofield_sparsevfc(a, NX=X[:10], M=80, lambda_=0.1, restart_num=2, min_vel_corr=0.5, device="cpu")
    assert "_device" not in a.uns["VecFld_morpho"]
    stt.tdr.morphofield_curl(a, device="cpu")
    stt.tdr.morphofield_divergence(a, device="cpu")
    np.testing.assert_allclose(np.asarray(a.obsm["curl"]).mean(axis=0), [0, 0, 2], atol=0.3)
    div = np.asarray(a.obs["divergence"])
    assert np.abs(div).mean() < 0.8 and np.median(np.abs(div)) < 0.6
    stt.tdr.morphopath(a, interpolation_num=50, device="cpu")
    traj0 = np.asarray(a.uns["fate_morpho"]["prediction"][0]).T
    assert traj0.shape[0] == 51
    r0, r_end = np.linalg.norm(traj0[0, :2]), np.linalg.norm(traj0[-1, :2])
    assert abs(r_end - r0) / (r0 + 1e-9) < 0.3


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_morphopath_matches_jax(sparsevfc_pair, direction):
    """50 RK4 steps through the carried-over field, every cell."""
    aj, at = sparsevfc_pair
    aj, at = aj.copy(), at.copy()
    st.tdr.morphopath(aj, interpolation_num=50, direction=direction, average=True)
    stt.tdr.morphopath(at, interpolation_num=50, direction=direction, average=True, device="cpu")
    fj, ft = aj.uns["fate_morpho"], at.uns["fate_morpho"]
    np.testing.assert_allclose(ft["t"], fj["t"], rtol=1e-6)
    pj, pt = np.stack(fj["prediction"]), np.stack(ft["prediction"])
    assert pt.shape == pj.shape == (400, 3, 51)
    assert _scaled(pt, pj) <= 1e-4
    assert _scaled(ft["average"], fj["average"]) <= 1e-4


def test_sparsevfc_morphofield_matches_jax(rotation):
    """`morphofield_sparsevfc` (restarts gated by the cosine correlation) on
    both packages: the same seed wins, the fields agree to 1e-3 of max|V|
    (measured 4.7e-4; the default ecr 1e-5 sits at the f32 rounding of the
    energy's relative change, so the two packages stop some iterations apart
    on a field that has already converged)."""
    X, V = rotation
    aj, at = _adata(st, X, V), _adata(stt, X, V)
    kw = dict(NX=X[:10], M=80, lambda_=0.1, restart_num=3, min_vel_corr=0.5)
    st.tdr.morphofield_sparsevfc(aj, **kw)
    stt.tdr.morphofield_sparsevfc(at, device="cpu", **kw)
    vj, vt = aj.uns["VecFld_morpho"], at.uns["VecFld_morpho"]
    np.testing.assert_array_equal(vt["ctrl_idx"], vj["ctrl_idx"])
    assert vt["method"] == "sparsevfc" and vt["grid_V"].shape == (10, 3)
    cos = np.sum(vt["V"] * V, 1) / (np.linalg.norm(vt["V"], axis=1) * np.linalg.norm(V, axis=1) + 1e-12)
    assert np.mean(cos) > 0.95
    assert _scaled(vt["V"], vj["V"]) <= 1e-3


def test_sparsevfc_batch_wrapper_matches_jax():
    """`morphofield_sparsevfc_batch` on 3 slices of unequal size (the JAX
    test's input, tests/test_tdr.py:937): the same subsets, keys, div/curl."""
    rng = np.random.default_rng(0)
    aj, at = [], []
    for t in range(3):
        n = 400 + t * 13
        X = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        V = np.stack([-X[:, 1], X[:, 0]], 1).astype(np.float32) + rng.normal(0, 0.05, (n, 2)).astype(np.float32)
        aj.append(_adata(st, X, V))
        at.append(_adata(stt, X, V))
    st.tdr.morphofield_sparsevfc_batch(aj, M=40, MaxIter=30, ecr=0.0, seed=0)
    stt.tdr.morphofield_sparsevfc_batch(at, M=40, MaxIter=30, ecr=0.0, seed=0, device="cpu")
    for a, b in zip(aj, at):
        vj, vt = a.uns["VecFld_morpho"], b.uns["VecFld_morpho"]
        assert set(vt) == set(vj)
        np.testing.assert_array_equal(vt["subset_idx"], vj["subset_idx"])
        assert vt["V"].shape == (400, 2) and _scaled(vt["V"], vj["V"]) <= 1e-3
        d, c = np.asarray(b.obs["divergence"], float), np.asarray(b.obs["curl"], float)
        assert np.isfinite(d).sum() == 400
        np.testing.assert_allclose(d, np.asarray(a.obs["divergence"], float), atol=1e-2)
        np.testing.assert_allclose(c, np.asarray(a.obs["curl"], float), atol=1e-2)
        assert abs(np.nanmean(c) - 2.0) < 0.4 and abs(np.nanmean(d)) < 0.5


def test_kernel_interpolation_matches_jax():
    """Interpolated expression of values in [0, 1] within 5e-4 of the JAX
    package's (measured 1.4e-4)."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (400, 3))
    expr = np.c_[np.sin(4 * X[:, 0]), X[:, 1] ** 2].astype(np.float32)
    target = np.random.default_rng(2).uniform(0.2, 0.8, (40, 3))
    aj = _adata(st, X, spatial_key="spatial", expr=expr, genes=["gA", "gB"])
    at = _adata(stt, X, spatial_key="spatial", expr=expr, genes=["gA", "gB"])
    oj = st.tdr.kernel_interpolation(aj, genes=["gA", "gB"], NX=target, M=60)
    ot = stt.tdr.kernel_interpolation(at, genes=["gA", "gB"], NX=target, M=60, device="cpu")
    assert ot.shape == oj.shape == (40, 2)
    assert np.abs(np.asarray(ot.X)[:, 0] - np.sin(4 * target[:, 0])).mean() < 0.3
    np.testing.assert_allclose(np.asarray(ot.X), np.asarray(oj.X), atol=5e-4)
    np.testing.assert_array_equal(ot.obsm["spatial"], target)


def test_get_X_Y_grid_matches_jax(rotation):
    X, V = rotation
    for a, b in zip(st.tdr.get_X_Y_grid(X=X, Y=V, grid_num=[6, 7, 8]), stt.tdr.get_X_Y_grid(X=X, Y=V, grid_num=[6, 7, 8])):
        np.testing.assert_array_equal(b, a)


def _pair(n=300, seed=0, shift=(0.3, -0.2), theta=0.15):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    freqs = np.linspace(0.3, 2.0, 12)
    expr = (np.abs(np.stack([np.sin(pts[:, 0] * f) + np.cos(pts[:, 1] * f) for f in freqs], 1)) + 1.0)
    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]], np.float32)
    moved = (pts @ R.T + np.asarray(shift, np.float32)).astype(np.float32)
    return pts, moved, expr.astype(np.float32)


@pytest.fixture(scope="module")
def morpho_field():
    """A JAX Morpho solve (moving onto fixed) and its vecfld, carried over."""
    pts, moved, expr = _pair()
    A = _adata(st, moved, spatial_key="spatial", expr=expr)
    B = _adata(st, pts, spatial_key="spatial", expr=expr)
    m = JMorpho(sampleA=A, sampleB=B, spatial_key="spatial", key_added="align_spatial",
                vecfld_key_added="VecFld_morpho", max_iter=40, verbose=False)
    m.run()
    return m, vecfld_from_reference(m.vecfld), (pts, moved, expr)


def test_vecfld_from_reference(morpho_field):
    m, vf, _ = morpho_field
    for k in ("R", "t", "Coff", "inducing_variables", "init_R", "init_t", "optimal_R", "optimal_t"):
        assert isinstance(vf[k], np.ndarray)
        np.testing.assert_array_equal(vf[k], np.asarray(m.vecfld[k]))
    assert set(vf["norm_dict"]) == set(m.vecfld["norm_dict"])


def test_ba_transform_matches_jax(morpho_field):
    _, vf, (pts, moved, expr) = morpho_field
    query = np.random.default_rng(5).uniform(0, 10, (257, 2)).astype(np.float32)
    for scale in (1.0, 0.5):
        out_j = st.align.BA_transform(vf, query, deformation_scale=scale)
        out_t = stt.align.BA_transform(vf, query, deformation_scale=scale, device="cpu")
        for a, b in zip(out_t, out_j):
            np.testing.assert_allclose(a, np.asarray(b), atol=FIELD_TOL)


def test_get_P_chunk_and_assignment_match_jax(morpho_field):
    _, vf, (pts, moved, expr) = morpho_field
    rng = np.random.default_rng(6)
    XnA = rng.uniform(-1, 1, (120, 2)).astype(np.float32)
    XnB = rng.uniform(-1, 1, (90, 2)).astype(np.float32)
    XA, XB = expr[:120], expr[:90] + 0.5
    # the euclidean expression term exp(-d / (2 * 0.05)) scales a rounding
    # difference in d by 10, hence its bar of 5e-5 (measured 1.9e-5)
    cases = ((dict(), FIELD_TOL), (dict(beta2=0.3, outlier_variance=2.0, chunk_size=40), FIELD_TOL),
             (dict(dissimilarity="euc", gamma=0.8), 5e-5))
    for kw, tol in cases:
        Pj = st.align.get_P_chunk(XnA, XnB, XA, XB, 0.05, **kw)
        Pt = stt.align.get_P_chunk(XnA, XnB, XA, XB, 0.05, device="cpu", **kw)
        assert Pt.shape == (120, 90)
        assert _scaled(Pt, Pj) <= tol
    samples_j = [_adata(st, moved, spatial_key="spatial", expr=expr), _adata(st, pts, spatial_key="spatial", expr=expr)]
    samples_t = [_adata(stt, moved, spatial_key="spatial", expr=expr),
                 _adata(stt, pts, spatial_key="spatial", expr=expr)]
    out_j = st.align.BA_transform_and_assignment(samples_j, vf)
    out_t = stt.align.BA_transform_and_assignment(samples_t, vf, device="cpu")
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(a, np.asarray(b), atol=FIELD_TOL)
    # P at the solve's final sigma2 (~1e-3 on the unit-scaled frame) turns
    # the coordinates' 1e-6 rounding into ~1e-5 of P (measured 1.4e-5)
    assert out_t[3].shape == (300, 300) and _scaled(out_t[3], out_j[3]) <= 5e-5


def test_morpho_align_ref_matches_jax():
    """Two 600-cell slices aligned through 250-cell references (40
    iterations), the full slices warped by the learned field: every
    coordinate set within 2e-3 on the 10-unit box, the same subsample."""
    pts, moved, expr = _pair(600, seed=1)
    kw = dict(n_sampling=250, spatial_key="spatial", key_added="align", max_iter=40, nonrigid_start_iter=20,
              verbose=False)
    mk = lambda pkg: [_adata(pkg, pts, spatial_key="spatial", expr=expr),
                      _adata(pkg, moved, spatial_key="spatial", expr=expr)]
    aj, rj, pj, prj = st.align.morpho_align_ref(mk(st), **kw)
    at, rt, pt, prt = stt.align.morpho_align_ref(mk(stt), device="cpu", **kw)
    assert len(at) == len(rt) == 2 and len(pt) == len(prt) == 1
    for mj, mt in zip(rj, rt):
        np.testing.assert_array_equal(mt.obs_names, mj.obs_names)
    for group_j, group_t in ((aj, at), (rj, rt)):
        for mj, mt in zip(group_j, group_t):
            for key in ("align", "align_rigid", "align_nonrigid"):
                np.testing.assert_allclose(mt.obsm[key], mj.obsm[key], atol=COORD_TOL)
    assert at[1].obsm["align"].shape == (600, 2)
    rms = float(np.sqrt(((at[1].obsm["align"] - pts) ** 2).sum(1).mean()))
    assert rms < 0.1


def test_downsampling_matches_jax():
    pts, _, expr = _pair(500)
    for method in ("random", "lhs"):
        dj = st.align.downsampling([_adata(st, pts, spatial_key="spatial", expr=expr)], n_sampling=100,
                                   sampling_method=method)
        dt = stt.align.downsampling([_adata(stt, pts, spatial_key="spatial", expr=expr)], n_sampling=100,
                                    sampling_method=method)
        np.testing.assert_array_equal(dt[0].obs_names, dj[0].obs_names)


def test_paste_transform_matches_jax():
    pts, _, expr = _pair(50)
    R = np.array([[0.0, -1.0], [1.0, 0.0]])
    mapping = {"tX": np.array([1.0, 2.0]), "tY": np.array([0.5, 0.5]), "R": R}
    outs = []
    for pkg in (st, stt):
        a, ref = _adata(pkg, pts, spatial_key="spatial", expr=expr), _adata(pkg, pts, spatial_key="spatial", expr=expr)
        ref.uns["models_align"] = mapping
        outs.append(pkg.align.paste_transform(a, ref).obsm["align_spatial"])
    np.testing.assert_array_equal(outs[1], outs[0])


def test_gaussian_process_field_matches_jax(morpho_field):
    """The GP flavour: `morphofield_gp` on a carried-over Morpho vecfld (host
    float64, equal to the JAX package's), then `GPVectorField` Jacobians of
    that field in both packages to 1e-4 of their scale. With the rigid part
    the field is x' - x at |x| ~ 10 over 1e4, so central differences of step
    1e-2 in f32 are rounding noise at 3-6% of the Jacobian in either package;
    there each package's numerical Jacobian is held to its analytical one
    within 0.1 of scale instead."""
    m, vf, (pts, moved, expr) = morpho_field
    aj = _adata(st, np.asarray(m.XAHat), expr=expr)
    at = _adata(stt, np.asarray(m.XAHat), expr=expr)
    aj.uns["VecFld_morpho"] = m.vecfld
    at.uns["VecFld_morpho"] = vf
    j_morphofield_gp(aj, grid_num=[6, 6])
    stt.tdr.morphofield_gp(at, grid_num=[6, 6])
    np.testing.assert_allclose(at.obsm["V_align_spatial"], aj.obsm["V_align_spatial"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(at.uns["VecFld_morpho"]["grid_V"], aj.uns["VecFld_morpho"]["grid_V"], rtol=1e-6,
                               atol=1e-9)
    for nonrigid_only in (False, True):
        gj, gt = JGPVectorField(), TGPVectorField(device="cpu")
        gj.from_adata(aj, vf_key="VecFld_morpho", nonrigid_only=nonrigid_only)
        gt.from_adata(at, vf_key="VecFld_morpho", nonrigid_only=nonrigid_only)
        X = gj.get_X()[:80]
        J_an = gt.get_Jacobian("analytical")(X)
        assert _scaled(J_an, gj.get_Jacobian("analytical")(X)) <= JAC_TOL
        J_num, J_num_ref = gt.get_Jacobian("numerical")(X), gj.get_Jacobian("numerical")(X)
        if nonrigid_only:
            assert _scaled(J_num, J_num_ref) <= JAC_TOL
        else:
            assert _scaled(J_num, J_an) <= 0.1 and _scaled(J_num_ref, J_an) <= 0.1
        assert _scaled(gt.compute_velocity(X), gj.compute_velocity(X)) <= FIELD_TOL


def test_unported_paths_raise():
    """`mesh=` that is not a `DeviceMesh` raises (the sharded SparseVFC is
    `tests/test_torch_parallel.py`'s). The euclidean center NMF, which raised
    until item 10b was ported, is now `FrobeniusNMF` (held against
    scikit-learn in `test_torch_paste.py`)."""
    from spateo_tpu_torch.alignment.methods.paste import FrobeniusNMF

    assert isinstance(stt.align.methods.center_NMF(5, 0, dissimilarity="euclidean", device="cpu"), FrobeniusNMF)
    with pytest.raises(TypeError, match="DeviceMesh"):
        stt.tdr.morphofield_sparsevfc(_adata(stt, *[np.random.default_rng(0).uniform(size=(50, 2))] * 2), NX=None,
                                      grid_num=[3, 3], M=10, restart_num=0, mesh=object(), device="cpu")


def test_tdr_and_align_surface():
    """`stt.tdr` exports the ported morphofield surface, `stt.align` the
    field transforms (the no-JAX import is pinned in test_torch_starro.py)."""
    for name in ("morphofield_sparsevfc", "morphofield_sparsevfc_batch", "morphofield_gp", "GPVectorField",
                 "morphofield_velocity", "morphofield_acceleration", "morphofield_curvature", "morphofield_curl",
                 "morphofield_torsion", "morphofield_divergence", "morphofield_jacobian", "morphopath",
                 "kernel_interpolation", "get_X_Y_grid", "cell_directions"):
        assert callable(getattr(stt.tdr, name))
    for name in ("morpho_align_ref", "BA_transform", "BA_transform_and_assignment", "paste_transform",
                 "downsampling", "get_P_chunk"):
        assert callable(getattr(stt.align, name))
