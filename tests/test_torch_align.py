"""The whole Morpho slice of the port against the JAX package on the CPU:
`stt.align.morpho_align` on a slice chain, `Morpho_pairwise.run` under its
options, and the transformation functions.

Both packages draw from `np.random.default_rng(seed)` in the same order, so
they use the same inducing points, samples and minibatch schedule, and the
solves can be held tightly: aligned coordinates within 2e-3 on a 10-unit
box and rotations within 1e-4 (measured differences are 1e-6 to 1e-5; the
bars leave room for f32 sums taken in another order over 40-60 EM
iterations).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.alignment.methods import morpho as jmorpho
from spateo_tpu_torch.alignment.methods import morpho as tmorpho

COORD_TOL = 2e-3
ROT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch and for numpy's and scikit-learn's
    pools: the tier-1 run shares the CPU among its workers, where those
    pools only contend."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _slices(n_slices, n, g, seed):
    """A chain of rotated, shifted copies of one synthetic slice with smooth
    expression gradients and a categorical 'region' label."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    freqs = np.linspace(0.3, 2.0, g)
    X = np.abs(np.stack([np.sin(pts[:, 0] * f) + np.cos(pts[:, 1] * f) for f in freqs], 1) + 2.0)
    region = np.where(pts[:, 0] < 5, "left", "right")
    out = []
    for k in range(n_slices):
        th = 0.2 * k
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
        p = pts @ R.T + np.array([0.7 * k, -0.4 * k], np.float32)
        Xk = (X + rng.uniform(0, 0.1, X.shape)).astype(np.float32)
        out.append((p.astype(np.float32), Xk, region))
    return pts, out


def _adata(pkg, p, X, region):
    a = pkg.AnnData(
        X=X.copy(),
        obs=pd.DataFrame({"region": region}, index=[f"c{i}" for i in range(len(p))]),
        var=pd.DataFrame(index=[f"g{j}" for j in range(X.shape[1])]),
    )
    a.obsm["spatial"] = p.copy()
    a.uns["__type"] = "UMI"
    return a


def test_morpho_align_chain_matches_jax():
    """A 3-slice chain (700 cells, SVI batches of 300, 60 iterations):
    aligned coordinates (rigid, non-rigid, chosen), the vecfld entries and
    the assignments against `st.align.morpho_align`."""
    truth, chain = _slices(3, 700, 20, seed=2)
    kw = dict(spatial_key="spatial", key_added="align", max_iter=60, nonrigid_start_iter=30, batch_size=300,
              verbose=False)
    out_j, pis_j = st.align.morpho_align([_adata(st, *c) for c in chain], **kw)
    out_t, pis_t = stt.align.morpho_align([_adata(stt, *c) for c in chain], device="cpu", **kw)
    assert len(out_t) == 3 and len(pis_t) == 2
    for mj, mt in zip(out_j, out_t):
        for key in ("align", "align_rigid", "align_nonrigid"):
            np.testing.assert_allclose(mt.obsm[key], mj.obsm[key], atol=COORD_TOL)
    for mj, mt in zip(out_j[1:], out_t[1:]):
        vj, vt = mj.uns["VecFld_morpho"], mt.uns["VecFld_morpho"]
        assert set(vt) == set(vj)
        for key in ("R", "optimal_R", "init_R"):
            np.testing.assert_allclose(vt[key], vj[key], atol=ROT_TOL)
        for key in ("t", "optimal_t", "init_t", "inducing_variables", "Coff"):
            np.testing.assert_allclose(vt[key], vj[key], atol=COORD_TOL)
        # slice 2 is normalised from slice 1's aligned coordinates, which
        # each package computed: equal to a few ulps
        np.testing.assert_allclose(vt["normalize_scales"], vj["normalize_scales"], rtol=1e-5)
        np.testing.assert_allclose(vt["normalize_means"], vj["normalize_means"], atol=COORD_TOL)
        np.testing.assert_allclose(vt["sigma2"], vj["sigma2"], rtol=1e-3)
        np.testing.assert_allclose(vt["gamma"], vj["gamma"], rtol=1e-3)
        assert vt["dissimilarity"] == vj["dissimilarity"] and vt["NA"] == vj["NA"]
    for pj, pt in zip(pis_j, pis_t):
        assert isinstance(pt, torch.Tensor) and tuple(pt.shape) == np.shape(pj)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    # each slice lands on the first one's frame
    for mt in out_t[1:]:
        assert np.sqrt(((mt.obsm["align"] - truth) ** 2).sum(1).mean()) < 0.05


def test_morpho_pairwise_recovers_rotation():
    """The port alone, as tests/test_alignment.py:36 holds the JAX package:
    a 20-degree rotation with noise is undone to 5% of the point spread."""
    rng = np.random.default_rng(3)
    n, g = 400, 30
    cA = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    th = np.deg2rad(20.0)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    cB = cA @ R.T + np.array([2.0, -1.0], np.float32) + rng.normal(0, 0.03, (n, 2)).astype(np.float32)
    f1, f2 = np.linspace(0.3, 2.0, g), np.linspace(0.2, 1.5, g)
    e = np.stack([np.sin(cA[:, 0] * a) + np.cos(cA[:, 1] * b) for a, b in zip(f1, f2)], 1)
    e = np.abs(e - e.min() + 0.1).astype(np.float32)
    A = _adata(stt, cA, e + np.abs(rng.normal(0, 0.02, (n, g))).astype(np.float32), np.array(["x"] * n))
    B = _adata(stt, cB, e + np.abs(rng.normal(0, 0.02, (n, g))).astype(np.float32), np.array(["x"] * n))
    m = tmorpho.Morpho_pairwise(A, B, max_iter=80, nonrigid_start_iter=40, batch_size=200, verbose=False, seed=1,
                                device="cpu")
    m.run()
    err = np.sqrt(((m.XAHat - cB) ** 2).sum(1)).mean()
    spread = np.sqrt(((cB - cB.mean(0)) ** 2).sum(1)).mean()
    assert err / spread < 0.05


def _guidance(chain):
    (pB, _, _), (pA, _, _) = chain[0], chain[1]
    return [pB[:15], pA[:15]]


CONFIGS = {
    "full_batch_no_nn_init": dict(SVI_mode=False, nn_init=False),
    "flip_hypothesis": dict(allow_flip=True),
    "guidance_both": dict(guidance_effect="both"),
    "label_prior": dict(rep_layer=["X", "region"], rep_field=["layer", "obs"], dissimilarity=["kl", "label"]),
    "geodesic_kernel": dict(kernel_type="geodist"),
    "sparse_mode": dict(sparse_calculation_mode=True, sparse_top_k=40),
    "mapping_and_traces": dict(return_mapping=True, iter_key_added="iter", dissimilarity="euc"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_morpho_pairwise_options_match_jax(name):
    """`Morpho_pairwise.run` under each option against the JAX package (400
    cells, 40 iterations, non-rigid from iteration 15): XAHat, the rigid
    result, R, t, sigma2, gamma, RnA, VnA and P."""
    _, chain = _slices(2, 400, 12, seed=5)
    kw = dict(spatial_key="spatial", key_added="align", max_iter=40, nonrigid_start_iter=15, batch_size=150,
              verbose=False, seed=4, **CONFIGS[name])
    if name == "guidance_both":
        kw["guidance_pair"] = _guidance(chain)
    mj = jmorpho.Morpho_pairwise(_adata(st, *chain[1]), _adata(st, *chain[0]), **kw)
    mt = tmorpho.Morpho_pairwise(_adata(stt, *chain[1]), _adata(stt, *chain[0]), device="cpu", **kw)
    Pj, Pt = mj.run(), mt.run()
    np.testing.assert_allclose(mt.XAHat, mj.XAHat, atol=COORD_TOL)
    np.testing.assert_allclose(mt.optimal_RnA, mj.optimal_RnA, atol=COORD_TOL)
    np.testing.assert_allclose(mt.RnA, mj.RnA, atol=COORD_TOL)
    np.testing.assert_allclose(mt.VnA, mj.VnA, atol=COORD_TOL)
    np.testing.assert_allclose(mt.R, mj.R, atol=ROT_TOL)
    np.testing.assert_allclose(mt.optimal_R, mj.optimal_R, atol=ROT_TOL)
    np.testing.assert_allclose(mt.t, mj.t, atol=COORD_TOL)
    np.testing.assert_allclose(mt.sigma2, mj.sigma2, rtol=1e-3)
    np.testing.assert_allclose(mt.gamma, mj.gamma, rtol=1e-3)
    if name == "sparse_mode":
        assert Pt.format == "csr" and Pt.shape == Pj.shape
        Pt, Pj = Pt.toarray(), Pj.toarray()
    else:
        Pt, Pj = (Pt.numpy() if isinstance(Pt, torch.Tensor) else Pt), np.asarray(Pj)
    assert Pt.shape == Pj.shape
    # P is sharply peaked at the final sigma2: an entry moves by about
    # d / sigma2 times a coordinate difference, so its bar is 1e-3
    np.testing.assert_allclose(Pt, Pj, atol=1e-3)
    if name == "mapping_and_traces":
        assert Pt.shape == (400, 400)
        tj, tt = mj.sampleA.uns["iter"], mt.sampleA.uns["iter"]
        assert set(tt["align"]) == set(tj["align"]) == set(range(40))
        np.testing.assert_allclose(tt["align"][39], tj["align"][39], atol=COORD_TOL)
        np.testing.assert_allclose(tt["sigma2"][20], tj["sigma2"][20], rtol=1e-3)
    if name == "geodesic_kernel":
        kj, kt = mj.vecfld["kernel_dict"], mt.vecfld["kernel_dict"]
        np.testing.assert_array_equal(kt["first_node_idx"], kj["first_node_idx"])
        np.testing.assert_allclose(kt["X"], kj["X"], atol=1e-5)


def test_transformation_functions_match_jax(tmp_path):
    """`morpho_align_transformation` (checkpointed, then resumed) and
    `morpho_align_apply_transformation` against the JAX package's."""
    _, chain = _slices(3, 300, 10, seed=8)
    kw = dict(spatial_key="spatial", max_iter=30, nonrigid_start_iter=15, verbose=False)
    tj = st.align.morpho_align_transformation([_adata(st, *c) for c in chain], **kw)
    path = str(tmp_path / "tf")
    models = [_adata(stt, *c) for c in chain]
    tt = stt.align.morpho_align_transformation(models, save_transformation=True, transformation_path=path,
                                               device="cpu", **kw)
    resumed = stt.align.morpho_align_transformation(models, save_transformation=True, transformation_path=path,
                                                    resume=True, device="cpu", **kw)
    assert len(tt) == len(tj) == len(resumed) == 2
    for a, b, c in zip(tt, tj, resumed):
        np.testing.assert_allclose(a["Rotation"], b["Rotation"], atol=ROT_TOL)
        np.testing.assert_allclose(a["Translation"], b["Translation"], atol=COORD_TOL)
        np.testing.assert_array_equal(c["Rotation"], a["Rotation"])
    applied_t = stt.align.morpho_align_apply_transformation(models, transformation=tt, spatial_key="spatial",
                                                            verbose=False)
    applied_j = st.align.morpho_align_apply_transformation([_adata(st, *c) for c in chain], transformation=tj,
                                                           spatial_key="spatial", verbose=False)
    for a, b in zip(applied_t, applied_j):
        np.testing.assert_allclose(a.obsm["align_spatial"], b.obsm["align_spatial"], atol=COORD_TOL)
    from_disk = stt.align.morpho_align_apply_transformation(models, transformation_path=path, spatial_key="spatial",
                                                            verbose=False)
    np.testing.assert_array_equal(from_disk[2].obsm["align_spatial"], applied_t[2].obsm["align_spatial"])


# ---------------------------------------------------------------------------
# The rest of alignment: utilities, deformation grids, deprecated shims
# ---------------------------------------------------------------------------




def _pair_adatas(n=200, seed=3):
    from spateo_tpu_torch.core.bridge import adata_from_reference

    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 10, (n, 3))
    a = st.AnnData(
        X=rng.poisson(2.0, (n, 6)).astype(np.float32),
        obs=pd.DataFrame({"ct": rng.choice(["A", "B", "C"], n)}, index=[f"c{i}" for i in range(n)]),
        var=pd.DataFrame(index=[f"g{j}" for j in range(6)]),
    )
    a.obsm["spatial"] = pts
    st.SKM.init_adata_type(a, "UMI")
    return a, adata_from_reference(a)


def test_alignment_utilities_match_jax():
    """`rigid_transformation`, `tps_deformation`, `split_slice`,
    `generate_label_transfer_prior`, `get_labels_based_on_coords` and
    `align_preprocess`: copies of the JAX package's host code, equal."""
    a, b = _pair_adatas()
    a2d, b2d = _pair_adatas(seed=4)
    for m in (a2d, b2d):
        m.obsm["spatial"] = np.asarray(m.obsm["spatial"])[:, :2]
    st.align.rigid_transformation(a2d, "spatial", "rigid", theta=0.4, translation=np.array([1.0, 2.0]))
    stt.align.rigid_transformation(b2d, "spatial", "rigid", theta=0.4, translation=np.array([1.0, 2.0]))
    np.testing.assert_array_equal(b2d.obsm["rigid"], a2d.obsm["rigid"])
    st.align.tps_deformation(a2d, "spatial", "tps", tps_noise_scale=0.5, seed=2)
    out = stt.align.tps_deformation(b2d, "spatial", "tps", tps_noise_scale=0.5, seed=2, inplace=False)
    np.testing.assert_array_equal(out.obsm["tps"], a2d.obsm["tps"])
    assert "tps" not in b2d.obsm
    sj, s_t = st.align.split_slice(a, "spatial", split_num=4), stt.align.split_slice(b, "spatial", split_num=4)
    assert [list(x.obs_names) for x in s_t] == [list(x.obs_names) for x in sj]
    assert [list(x.obs["slice"]) for x in s_t] == [list(x.obs["slice"]) for x in sj]
    for kw in ({}, {"positive_pairs": [{"left": ["A"], "right": ["B"], "value": 5.0}]},
               {"negative_pairs": [{"left": ["A"], "right": ["A"], "value": 0.1}]}):
        assert stt.align.generate_label_transfer_prior(["A", "B"], ["A", "B", "C"], **kw) == \
            st.align.generate_label_transfer_prior(["A", "B"], ["A", "B", "C"], **kw)
    q = np.random.default_rng(0).uniform(0, 10, (30, 3))
    pd.testing.assert_frame_equal(stt.align.get_labels_based_on_coords(b, q, "ct", spatial_key="spatial"),
                                  st.align.get_labels_based_on_coords(a, q, "ct", spatial_key="spatial"))
    for kw in ({}, {"normalize_c": True, "normalize_g": True, "genes": ["g1", "g3", "g4"]}):
        rj = st.align.align_preprocess([a, a2d], **kw)
        rt = stt.align.align_preprocess([b, b2d], **kw)
        assert rt[6] == rj[6]
        for k in (2, 3):
            for x, y in zip(rt[k], rj[k]):
                np.testing.assert_array_equal(x, y)
        if kw:
            np.testing.assert_array_equal(rt[4], rj[4])


def test_kmeans_downsampling_matches_jax():
    """`downsampling(sampling_method="kmeans")` (the port's MiniBatchKMeans,
    `morpho_align_ref`'s and `paste_align_ref`'s sampler) keeps the JAX
    package's cells."""
    a, b = _pair_adatas(n=800, seed=5)
    [dj] = st.align.downsampling([a], n_sampling=120, sampling_method="kmeans")
    [dt] = stt.align.downsampling([b], n_sampling=120, sampling_method="kmeans", device="cpu")
    assert list(dt.obs_names) == list(dj.obs_names)


def test_grid_deformation_matches_jax():
    """One saved Morpho field warps the grid through both packages: the same
    lines, warped points to 1e-5 (float32 `BA_transform`), the velocity
    scalar on the deformed grid only."""
    from spateo_tpu_torch.core.bridge import adata_from_reference, vecfld_from_reference

    _, chain = _slices(2, 250, 10, seed=12)
    models, _ = st.align.morpho_align([_adata(st, *c) for c in chain], max_iter=30, batch_size=150, verbose=False)
    mj = models[1]
    mj.uns["VecFld_morpho"]["Coff"] = np.asarray(mj.uns["VecFld_morpho"]["Coff"]) + 0.05
    mt = adata_from_reference(mj)
    mt.uns["VecFld_morpho"] = vecfld_from_reference(mj.uns["VecFld_morpho"])
    gj, dj = st.align.grid_deformation(mj, spatial_key="align_spatial", grid_num=[5, 5], grid_density=20)
    gt, dt = stt.align.grid_deformation(mt, spatial_key="align_spatial", grid_num=[5, 5], grid_density=20,
                                        device="cpu")
    np.testing.assert_array_equal(gt.points, gj.points)
    np.testing.assert_array_equal(gt.lines, gj.lines)
    np.testing.assert_allclose(dt.points, dj.points, rtol=0, atol=1e-5)
    assert np.all(np.asarray(gt.point_data["deformation"]) == 0)
    np.testing.assert_allclose(dt.point_data["deformation"], dj.point_data["deformation"], rtol=0, atol=1e-5)
    assert len(mt.uns["deformation"]["grid_lines"]) == 10


def test_deprecated_shims_match_jax():
    """test_deprecated_api.py's cases through both packages: `BA_align`
    writes the same keys and the same rigid and non-rigid coordinates
    (to COORD_TOL), `P` comes back on the host as [B, A]; `BA_align_sparse`
    runs the sparse mode from its own module path."""
    from spateo_tpu.alignment.methods.deprecated_morpho import BA_align as jBA
    from spateo_tpu_torch.alignment.methods.deprecated_morpho import BA_align as tBA
    from spateo_tpu_torch.alignment.methods.deprecated_morpho_sparse import BA_align_sparse

    rng = np.random.default_rng(0)
    n = 120
    pts = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    X = rng.poisson(2.0, (n, 10)).astype(np.float32)
    th = 0.25
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    moved = pts @ R.T + np.array([1.0, -0.5], np.float32)
    region = np.array(["r"] * n)
    (_, Bj), Pj = jBA(sampleA=_adata(st, pts, X, region), sampleB=_adata(st, moved, X, region), max_iter=30,
                      vecfld_key_added="VecFld", verbose=False)
    (_, Bt), Pt = tBA(sampleA=_adata(stt, pts, X, region), sampleB=_adata(stt, moved, X, region), max_iter=30,
                      vecfld_key_added="VecFld", verbose=False, device="cpu")
    assert isinstance(Pt, np.ndarray) and Pt.shape == Pj.shape == (n, n)
    np.testing.assert_allclose(Pt, np.asarray(Pj), rtol=0, atol=COORD_TOL * float(np.asarray(Pj).max()))
    for k in ("align_spatial_rigid", "align_spatial_nonrigid"):
        np.testing.assert_allclose(Bt.obsm[k], np.asarray(Bj.obsm[k]), atol=COORD_TOL)
    assert "VecFld" in Bt.uns
    (_, Bs), Ps = BA_align_sparse(sampleA=_adata(stt, pts, X, region), sampleB=_adata(stt, moved, X, region),
                                  max_iter=20, verbose=False, device="cpu")
    assert "align_spatial_rigid" in Bs.obsm and Ps.shape == (n, n)


def test_methods_utils_copy_matches_jax():
    """The `check_*` helpers, `construct_knn_graph`, `normalize_exps` and
    `torch_like_split` of `alignment.methods.utils`."""
    from spateo_tpu.alignment.methods import utils as ju
    from spateo_tpu_torch.alignment.methods import utils as tu

    a, b = _pair_adatas(n=80, seed=6)
    np.testing.assert_array_equal(tu.check_spatial_coords(b), ju.check_spatial_coords(a))
    np.testing.assert_array_equal(tu.check_exp(b), ju.check_exp(a))
    assert tu.check_rep_layer([b], ["X", "ct"], ["layer", "obs"]) and tu.check_obs(["X", "ct"], ["layer", "obs"]) == "ct"
    np.testing.assert_array_equal(tu.check_label_transfer(None, None, b, b, "ct"),
                                  ju.check_label_transfer(None, None, a, a, "ct"))
    coords = np.asarray(a.obsm["spatial"])
    assert (tu.construct_knn_graph(coords, 5) != ju.construct_knn_graph(coords, 5)).nnz == 0
    E = [np.random.default_rng(k).uniform(0, 3, (20, 4)) for k in range(2)]
    for x, y in zip(tu.normalize_exps(E, verbose=False), ju.normalize_exps(E, verbose=False)):
        np.testing.assert_array_equal(x, y)
    assert (tu.sparse_tensor_to_scipy(torch.eye(3)) != ju.sparse_tensor_to_scipy(np.eye(3))).nnz == 0
    assert [x.tolist() for x in tu.torch_like_split(np.arange(7), 3)] == [[0, 1, 2], [3, 4, 5], [6]]
    with pytest.raises(KeyError):
        tu.check_spatial_coords(b, "nope")
