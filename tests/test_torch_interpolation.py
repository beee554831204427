"""The port's interpolation engines (`stt.tdr.vtk_interpolation`,
`gp_interpolation`, `deep_intepretation` and their building blocks) against
the JAX package on the CPU, and a rehearsal of `chip_smoke.py`'s phases 26-27
at a tiny size.

Bars:

- VTK-style engine (float32 matmul-form distances in both): 1e-4 of scale
  for the three kernels (measured 1.1e-5 for Shepard, whose weights 1/d^2
  amplify the distance's rounding near a source; 3.6e-7 otherwise).
- SGPR: the port runs float64 where the JAX package runs float32 (its fit
  is NaN when 512 inducing points crowd a 3D tissue). The bound at the JAX
  init to 1e-5 of N x D, the scale of its log-determinant, quadratic and
  trace terms, which nearly cancel (measured 1.9e-6: float32's rounding in
  the JAX package); the losses of the first 10 Adam steps to 1e-4 relative
  (measured 2.4e-6) and the parameters after them to 1e-3 (measured
  2.7e-5); the prediction from the JAX package's fitted parameters to 3e-2
  of scale (measured 1.1e-2: the JAX package's float32 solve of
  Kuu + Kuf Kuf^T / noise, whose condition float32 barely holds). Trained
  (100 steps, 64 inducing points) on tests/test_tdr.py's field: the mean
  error against the planted field below its 0.3 (the JAX package's is
  printed beside it in the assertion).
- SIREN: the forward from weights carried over by
  `core.bridge.siren_from_reference` to 1e-6; the first 10 Adam steps on
  the JAX package's batches: losses to 1e-5 relative and weights to 1e-5
  (measured 1e-7 and 4e-8; torch and optax Adam round differently); trained
  400 steps on tests/test_tdr.py's field, the error below its 0.35.
- Building blocks, loss factories, `DataSampler`, `subset_best_samples`,
  the exact GP: 1e-6 (float32) or equal (host code).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.tdr.interpolations import interpolation_dl as JDL
from spateo_tpu.tdr.interpolations import interpolation_gp as JG
from spateo_tpu_torch.core.bridge import adata_from_reference, sgpr_params_from_reference, siren_from_reference
from spateo_tpu_torch.tdr.interpolations import interpolation_dl as TDL
from spateo_tpu_torch.tdr.interpolations import interpolation_gp as TG

VTK_TOL = 1e-4
SGPR_BOUND_TOL, SGPR_LOSS_TOL, SGPR_PARAM_TOL, SGPR_PRED_TOL = 1e-5, 1e-4, 1e-3, 3e-2
SIREN_FWD_TOL, SIREN_LOSS_TOL, SIREN_W_TOL = 1e-6, 1e-5, 1e-5
BLOCK_TOL = 1e-6


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


@pytest.fixture(scope="module")
def field():
    """tests/test_tdr.py's field: 400 cells in the unit cube, gA = sin(4 x),
    gB = y^2, an obs column; the JAX package's AnnData and the port's."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (400, 3))
    expr = np.c_[np.sin(4 * X[:, 0]), X[:, 1] ** 2].astype(np.float32)
    aj = st.AnnData(X=expr, var=pd.DataFrame(index=["gA", "gB"]), obs=pd.DataFrame({"z": X[:, 2]}))
    st.SKM.init_adata_type(aj, "UMI")
    aj.obsm["spatial"] = X
    return aj, adata_from_reference(aj)


def _truth(target):
    return np.sin(4 * target[:, 0])


@pytest.mark.parametrize("kernel", ["shepard", "gaussian", "linear"])
def test_vtk_interpolation_matches_jax(field, kernel):
    aj, at = field
    target = np.random.default_rng(1).uniform(0.2, 0.8, (50, 3))
    oj = st.tdr.vtk_interpolation(aj, target_points=target, keys=["gA", "gB", "z"], kernel=kernel)
    ot = stt.tdr.vtk_interpolation(at, target_points=target, keys=["gA", "gB", "z"], kernel=kernel, device="cpu",
                                   block=16)
    assert np.abs(np.asarray(ot.X) - np.asarray(oj.X)).max() <= VTK_TOL * np.abs(oj.X).max()
    assert np.abs(ot.obs["z"].values - oj.obs["z"].values).max() <= VTK_TOL
    assert list(ot.var_names) == list(oj.var_names) and list(ot.obs_names) == list(oj.obs_names)
    np.testing.assert_array_equal(ot.obsm["spatial"], oj.obsm["spatial"])
    if kernel == "shepard":
        assert np.abs(np.asarray(ot.X)[:, 0] - _truth(target)).mean() < 0.25


def test_vtk_nearest_fill_beyond_the_radius(field):
    """A target with no source within the radius takes its nearest
    source's values in both packages."""
    aj, at = field
    target = np.array([[3.0, 3.0, 3.0], [0.5, 0.5, 0.5]])
    oj = st.tdr.vtk_interpolation(aj, target_points=target, keys=["gA"], radius=0.05)
    ot = stt.tdr.vtk_interpolation(at, target_points=target, keys=["gA"], radius=0.05, device="cpu")
    assert np.abs(np.asarray(ot.X) - np.asarray(oj.X)).max() <= VTK_TOL


def _sgpr_inputs(aj, m=32):
    X = np.asarray(aj.obsm["spatial"], np.float32)
    Xn = ((X - X.mean(0)) / (X.std(0) + 1e-8)).astype(np.float32)
    Y = np.asarray(aj.X, np.float32)[:, :1]
    Yn = ((Y - Y.mean(0)) / (Y.std(0) + 1e-8)).astype(np.float32)
    return Xn, Yn, Xn[np.random.default_rng(0).choice(len(Xn), m, replace=False)]


def test_sgpr_bound_and_first_steps_match_jax(field):
    import jax
    import jax.numpy as jnp

    aj, _ = field
    Xn, Yn, Z0 = _sgpr_inputs(aj)
    init = {"log_ls": 0.0, "log_noise": -2.0, "log_amp": 0.0, "Z": Z0}
    p = sgpr_params_from_reference(init, device="cpu")
    with torch.no_grad():
        bound = float(TG.sgpr_neg_mll(p, torch.from_numpy(Xn).double(), torch.from_numpy(Yn).double()))
    for n in (1, 10):
        pj, lj = JG._fit_sgpr(jnp.asarray(Xn), jnp.asarray(Yn), jnp.asarray(Z0), jax.random.PRNGKey(0), n_epochs=n)
        pt, lt = TG._fit_sgpr(Xn, Yn, Z0, n_epochs=n, device="cpu")
        lj = np.asarray(lj)
        assert abs(bound - lj[0]) <= SGPR_BOUND_TOL * Yn.size
        assert np.abs(lt - lj).max() <= SGPR_LOSS_TOL * np.abs(lj).max()
        for k in ("log_ls", "log_noise", "log_amp", "Z"):
            a, b = getattr(pt, k).detach().numpy(), np.asarray(pj[k])
            assert np.abs(a - b).max() <= SGPR_PARAM_TOL * max(np.abs(b).max(), 1.0), (n, k)
    # the prediction from the JAX package's fitted parameters
    q = np.random.default_rng(2).normal(size=(30, 3)).astype(np.float32)
    ref = np.asarray(JG._sgpr_predict(pj, jnp.asarray(Xn), jnp.asarray(Yn), jnp.asarray(q)))
    pt = sgpr_params_from_reference({k: np.asarray(v) for k, v in pj.items()}, device="cpu")
    out = TG._sgpr_predict(pt, *(torch.from_numpy(a).double() for a in (Xn, Yn, q))).numpy()
    assert np.abs(out - ref).max() <= SGPR_PRED_TOL * np.abs(ref).max()


def test_gp_interpolation_field_error_beside_jax(field):
    aj, at = field
    target = np.random.default_rng(3).uniform(0.2, 0.8, (40, 3))
    reads = TG._fit_sgpr.host_reads
    ot = stt.tdr.gp_interpolation(at, target_points=target, keys=["gA"], training_iter=100, inducing_num=64,
                                  device="cpu")
    assert TG._fit_sgpr.host_reads == reads + 1
    oj = st.tdr.gp_interpolation(aj, target_points=target, keys=["gA"], training_iter=100, inducing_num=64)
    et = np.abs(np.asarray(ot.X)[:, 0] - _truth(target)).mean()
    ej = np.abs(np.asarray(oj.X)[:, 0] - _truth(target)).mean()
    assert et < 0.3, (et, ej)
    assert ot.X.dtype == np.float32 and list(ot.var_names) == ["gA"]


def test_gp_model_shims(field):
    """`Exact_GPModel` (host) equals the JAX package's; `Approx_GPModel`,
    `gp_train` and `Imputation_GPR` run the SGPR and predict finite
    values of the right shape."""
    from spateo_tpu.tdr.interpolations.interpolation_gaussianprocess import Exact_GPModel as JE
    from spateo_tpu_torch.tdr.interpolations.interpolation_gaussianprocess import (
        Approx_GPModel,
        Exact_GPModel,
        gp_train,
    )

    aj, at = field
    X, Y = np.asarray(aj.obsm["spatial"])[:100], np.asarray(aj.X)[:100, 0]
    q = X[:7] + 0.01
    np.testing.assert_array_equal(Exact_GPModel(X, Y).predict(q), JE(X, Y).predict(q))
    m = gp_train(Approx_GPModel(X[:16], device="cpu"), (X, Y[:, None]), train_epochs=20)
    assert m.predict(q).shape == (7, 1) and np.isfinite(m.predict(q)).all()
    imp = TG.Imputation_GPR(at, target_points=q, keys=["gA"], device="cpu", inducing_num=16)
    out = imp.train().interpolate()
    assert out.X.shape == (7, 1) and np.isfinite(out.X).all()


def test_siren_forward_and_first_steps_match_jax(field):
    import jax
    import jax.numpy as jnp

    aj, _ = field
    X = np.asarray(aj.obsm["spatial"], np.float32)
    Y = np.asarray(aj.X, np.float32)
    sizes = [3, 32, 32, 2]
    params = JDL._init_siren(jax.random.PRNGKey(0), sizes)
    model = siren_from_reference(params, device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(X)).numpy()
    assert np.abs(out - np.asarray(JDL._siren_forward(params, jnp.asarray(X)))).max() <= SIREN_FWD_TOL
    # 10 steps: the JAX package's trainer from seed 0, its batches replayed here
    mj = JDL.DeepInterpolation(hidden=32, depth=2, seed=0)
    lj = mj.train(X, Y, max_iter=10, lr=1e-3, batch_size=64)
    key, batches = jax.random.PRNGKey(0), []
    for _ in range(10):
        key, sub = jax.random.split(key)
        batches.append(np.asarray(jax.random.randint(sub, (64,), 0, len(X))))
    mt = TDL.DeepInterpolation(model=siren_from_reference(params, device="cpu"), hidden=32, depth=2, device="cpu")
    reads = TDL._fit_siren.host_reads
    lt = mt.train(X, Y, max_iter=10, lr=1e-3, batch_size=64, batch_indices=np.stack(batches))
    assert TDL._fit_siren.host_reads == reads + 1
    assert np.abs(lt - lj).max() <= SIREN_LOSS_TOL * np.abs(lj).max()
    for i, p in enumerate(mj.params):
        assert np.abs(mt.model.W[i].detach().numpy() - np.asarray(p["W"])).max() <= SIREN_W_TOL
        assert np.abs(mt.model.b[i].detach().numpy() - np.asarray(p["b"])).max() <= SIREN_W_TOL
    np.testing.assert_allclose(mt.predict(X[:5]), mj.predict(X[:5]), atol=1e-4)


def test_deep_intepretation_field_error_and_init_bounds(field):
    aj, at = field
    target = np.random.default_rng(4).uniform(0.2, 0.8, (40, 3))
    ot = stt.tdr.deep_intepretation(at, target_points=target, keys=["gA"], max_iter=400, device="cpu")
    oj = st.tdr.deep_intepretation(aj, target_points=target, keys=["gA"], max_iter=400)
    et = np.abs(np.asarray(ot.X)[:, 0] - _truth(target)).mean()
    ej = np.abs(np.asarray(oj.X)[:, 0] - _truth(target)).mean()
    assert et < 0.35, (et, ej)
    m = TDL.SIREN([3, 64, 64, 2], seed=5, device="cpu")
    assert m.W[0].abs().max() <= 1 / 3 and m.W[1].abs().max() <= np.sqrt(6 / 64) / 5
    assert torch.equal(TDL.SIREN([3, 64, 64, 2], seed=5, device="cpu").W[1], m.W[1])
    assert all(float(b.abs().max()) == 0 for b in m.b)


def test_building_blocks_match_jax():
    """Each block given the port's weights: the JAX package's forward of the
    same weights equals the port's to 1e-6."""
    import jax.numpy as jnp

    x = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    sl = TDL.SineLayer(3, 16, is_first=True, seed=1, device="cpu")
    js = JDL.SineLayer(3, 16, is_first=True, seed=1)
    ref = js(x, params={"W": jnp.asarray(sl.W.detach().numpy()), "b": jnp.asarray(sl.b.detach().numpy())})
    assert np.abs(sl(xt).detach().numpy() - np.asarray(ref)).max() <= BLOCK_TOL
    for cls in (TDL.A, TDL.B):
        blk = cls(4, 3, hidden_features=8, seed=2, device="cpu")
        jb = getattr(JDL, cls.__name__)(4, 3, hidden_features=8, seed=2)
        p = [{"W": jnp.asarray(W.detach().numpy()), "b": jnp.asarray(b.detach().numpy())} for W, b in zip(blk.W, blk.b)]
        inp = x if cls is TDL.A else np.random.default_rng(1).normal(size=(20, 4)).astype(np.float32)
        assert np.abs(blk(torch.from_numpy(inp)).detach().numpy() - np.asarray(jb(inp, params=p))).max() <= BLOCK_TOL
    hs = TDL.h(3, 2, hidden_features=16, hidden_layers=2, sirens=True, device="cpu")
    hm = TDL.h(3, 2, hidden_features=16, hidden_layers=2, sirens=False, device="cpu")
    flow = TDL.MainFlow(hs, A=None, B=TDL.B(2, 2, hidden_features=8, device="cpu"))
    assert hs(xt).shape == hm(xt).shape == (20, 2) and flow(x=xt).shape == (20, 2)
    assert len(list(hs.parameters())) == 2 * 3 + 2 and len(list(flow.parameters())) > len(list(hs.parameters()))


def test_loss_factories_sampler_and_subset_match_jax():
    rng = np.random.default_rng(0)
    a, b, w = rng.normal(size=(30, 4)), rng.normal(size=(30, 4)), rng.uniform(size=30)
    for name in ("mad", "mse", "cosine_distance"):
        assert float(getattr(TDL, name)()(a, b)) == pytest.approx(float(getattr(JDL, name)()(a, b)), rel=1e-6)
    # weights per row for the row-wise losses, per entry for the absolute difference
    for name, ws in (("weighted_mad", rng.uniform(size=(30, 4))), ("weighted_mse", w),
                     ("weighted_cosine_distance", w)):
        for ww in (ws, None):
            assert float(getattr(TDL, name)()(a, b, ww)) == pytest.approx(float(getattr(JDL, name)()(a, b, ww)),
                                                                        rel=1e-6)
    np.testing.assert_array_equal(TDL.subset_best_samples(0.5, a, b, TDL.mse()),
                                  JDL.subset_best_samples(0.5, a, b, JDL.mse()))
    data = {"X": a, "Y": b}
    for x, y in zip(TDL.DataSampler(data=data, normalize_data=True, seed=3).generate_batch(10),
                    JDL.DataSampler(data=data, normalize_data=True, seed=3).generate_batch(10)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="equal rows"):
        TDL.DataSampler(data={"X": a, "Y": b[:5]})


def test_tdr_interpolation_exports_match_jax():
    from spateo_tpu.tdr import interpolations as JI
    from spateo_tpu_torch.tdr import interpolations as TI

    assert {n for n in dir(JI) if not n.startswith("_")} - {n for n in dir(TI) if not n.startswith("_")} <= {
        "interpolation_deeplearn"}


# -- a rehearsal of chip_smoke.py's phases 26-27 at a tiny size ----------------------------------------


def test_chip_smoke_phase_26_27_helpers_on_cpu():
    """The phase 26-27 helpers of chip_smoke.py on the CPU at a tiny size:
    the three engines' fields are finite with errors below the JAX tests'
    bars, the clusterings find the planted bands, the CCI test its pair,
    `backbone_scc` clusters, and every card-vs-CPU comparison (CPU against
    itself here) is 0."""
    import chip_smoke as cs

    cells = cs.e95_cloud()
    sub = cells[np.random.default_rng(0).choice(len(cells), 1500, replace=False)]
    res = cs.interp_engines(stt, cs.interp_source(stt, sub, 4), cs.ellipsoid_grid(1500), device="cpu", gp_genes=2,
                            dl_iter=400, profile=False)
    assert res["vtk"]["err"] < 0.25 and res["gp"]["err"] < 0.3 and res["dl"]["err"] < 0.35
    sec = cs.cluster_section(stt, 1200, 150, device="cpu")
    out = cs.cluster_stages(stt, sec, device="cpu", profile=False, num=20)
    assert out["scc"]["ari"] > 0.5 and out["mclust"]["ari"] > 0.5 and out["kmeans"]["ari"] > 0.5
    assert out["cci"]["pvalue"] == 1 / 21 and out["umap"]["host_reads"] == 1
    bb, _, _ = stt.tdr.construct_backbone(stt.tdr.PointCloud(sub), rd_method="ElPiGraph", num_nodes=6, device="cpu")
    k, _ = cs.backbone_scc_stage(stt, cells, bb, device="cpu", n=600, profile=False)
    assert k >= 2
    cvc = cs.interp_cluster_cuda_vs_cpu(stt, card="cpu", n=300)
    assert all(v == 0 for v, _ in cvc.values()), cvc
    assert abs(cs.ari(np.r_[np.zeros(5), np.ones(5)], np.r_[np.ones(5), np.zeros(5)]) - 1.0) < 1e-12
