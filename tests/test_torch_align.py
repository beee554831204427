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
