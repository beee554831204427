"""The port's SparseVFC (`spateo_tpu_torch.ops.vfc`) against the JAX
package's on the CPU.

Both packages draw control points and the bandwidth subsample from
`np.random.default_rng(seed)` in the same order, so those are equal index for
index. Given the same beta and control points, the EMs agree to 1e-3 of
max|V| (measured 2e-4 to 6e-4: f32 sums in another order) with equal
iteration counts. The fields of the early-stopping batch stop at ecr 1e-3
(lambda 3), where each field's energy change falls through the bar cleanly;
on noiseless data the change hovers around small bars and the stopping
iteration is set by rounding in either package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spateo_tpu.ops import vfc as jvfc
from spateo_tpu_torch.ops import vfc as tvfc

V_TOL = 1e-3  # of max|V|
BETA_RTOL = 2e-4
GEO_TOL = 1e-2


def _rotation(n=400, seed=0, noise=0.0, dim=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    if dim == 3:
        V = np.cross(np.broadcast_to([0.0, 0.0, 1.0], X.shape), X).astype(np.float32)
    else:
        V = np.stack([-X[:, 1], X[:, 0]], 1).astype(np.float32)
    if noise:
        V = V + rng.normal(0, noise, V.shape).astype(np.float32)
    return X, V


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("n", [400, 399, 2000])
@pytest.mark.parametrize("dim", [2, 3])
def test_median_positive_sqdist_matches_jax(n, dim):
    """The bandwidth heuristic on an even and an odd point count."""
    X = np.random.default_rng(n + dim).uniform(-1, 1, (n, dim)).astype(np.float32)
    hj = float(jvfc._median_positive_sqdist(jnp.asarray(X)))
    ht = float(tvfc._median_positive_sqdist(torch.from_numpy(X)))
    assert abs(ht - hj) <= BETA_RTOL * hj


def test_median_averages_the_two_middle_values():
    """An even count of positive distances takes their mean, as
    `jnp.nanmedian` does (`torch.nanmedian` would take the lower); the
    batched form computes each batch's own."""
    sub = torch.tensor([[0.0], [1.0], [3.0]])  # d2: 1, 9, 4 twice each -> 1,1,4,4,9,9
    assert float(tvfc._median_positive_sqdist(sub)) == 4.0
    sub = torch.tensor([[0.0], [1.0], [2.0], [4.0]])  # 1,4,16,1,9,4 twice -> median (4+4)/2
    assert float(tvfc._median_positive_sqdist(sub)) == 4.0
    sub = torch.tensor([[0.0], [1.0], [3.0], [7.0]])  # 1,9,49,4,36,16 -> (9+16)/2
    assert float(tvfc._median_positive_sqdist(sub)) == 12.5
    both = torch.stack([torch.tensor([[0.0], [1.0], [3.0], [7.0]]), torch.zeros((4, 1))])
    out = tvfc._median_positive_sqdist(both)
    assert float(out[0]) == 12.5 and bool(torch.isnan(out[1]))


@pytest.mark.parametrize("M", [80, 30])
def test_control_points_and_subsample_equal_jax(M):
    """`_select_ctrl` and the batch's subsample draws equal the JAX package's
    index for index, and so do the batch's betas to rtol 2e-4."""
    X, V = _rotation()
    Xs = np.stack([X, X * 0.9, X * 1.1]).astype(np.float32)
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(tvfc._select_ctrl(X, M, rng_t), jvfc._select_ctrl(X, M, rng_j))
    idx, ctrls, subs = tvfc._batch_ctrl_draws(Xs, M, 0, True)
    rng = np.random.default_rng(0)
    ref_idx = [jvfc._select_ctrl(Xs[f], M, rng) for f in range(3)]
    ref_subs = np.stack([Xs[f][rng.choice(len(X), min(len(X), 2000), replace=False)] for f in range(3)])
    for a, b in zip(idx, ref_idx):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(subs, ref_subs)
    res_j = jvfc.SparseVFC_batch(Xs, np.stack([V] * 3), M=M, MaxIter=2, ecr=0.0, seed=0)
    res_t = tvfc.SparseVFC_batch(Xs, np.stack([V] * 3), M=M, MaxIter=2, ecr=0.0, seed=0, device="cpu")
    for rj, rt in zip(res_j, res_t):
        np.testing.assert_array_equal(rt["ctrl_idx"], rj["ctrl_idx"])
        np.testing.assert_array_equal(rt["X_ctrl"], rj["X_ctrl"])
        assert abs(rt["beta"] - rj["beta"]) <= BETA_RTOL * rj["beta"]


def test_ctrl_dedup_on_duplicate_heavy_data():
    """Binned coordinates: the global dedup fallback draws the same rows as
    the JAX package and delivers M distinct control points."""
    rng = np.random.default_rng(0)
    Xd = np.repeat(rng.uniform(-1, 1, (40, 2)).astype(np.float32), 10, axis=0)
    Vd = np.stack([-Xd[:, 1], Xd[:, 0]], 1).astype(np.float32)
    rt = tvfc.SparseVFC(Xd, Vd, M=30, MaxIter=5, seed=0, device="cpu")
    rj = jvfc.SparseVFC(Xd, Vd, M=30, MaxIter=5, seed=0)
    np.testing.assert_array_equal(rt["ctrl_idx"], rj["ctrl_idx"])
    assert len({tuple(r) for r in rt["X_ctrl"].tolist()}) == 30


@pytest.mark.parametrize("max_iter", [5, 60])
@pytest.mark.parametrize("setting", ["benchmark", "tests"])
def test_sparsevfc_em_matches_jax(max_iter, setting):
    """SparseVFC with the JAX fit's beta passed in (the control points are
    drawn equal): V within 1e-3 of max|V|, equal iterations, and the other
    outputs close. 'benchmark': 2,000 noisy points, M 100, lambda 3, ecr 0;
    'tests': the JAX tests' 400 points, M 80, lambda 0.1, ecr 0."""
    if setting == "benchmark":
        X, V = _rotation(2000, seed=1, noise=0.05)
        kw = dict(M=100, lambda_=3.0)
    else:
        X, V = _rotation()
        kw = dict(M=80, lambda_=0.1)
    rj = jvfc.SparseVFC(X, V, Grid=X[:20], MaxIter=max_iter, ecr=0.0, seed=0, **kw)
    rt = tvfc.SparseVFC(X, V, Grid=X[:20], MaxIter=max_iter, ecr=0.0, seed=0, beta=rj["beta"], device="cpu", **kw)
    np.testing.assert_array_equal(rt["ctrl_idx"], rj["ctrl_idx"])
    assert rt["iteration"] == rj["iteration"] == max_iter
    assert _rel(rt["V"], rj["V"]) <= V_TOL
    assert _rel(rt["grid_V"], rj["grid_V"]) <= V_TOL
    np.testing.assert_allclose(rt["P"], rj["P"], atol=1e-2)  # posteriors on the steep part move most
    np.testing.assert_allclose(rt["sigma2"], rj["sigma2"], rtol=1e-2)
    np.testing.assert_allclose(rt["gamma"], rj["gamma"], rtol=1e-3)
    np.testing.assert_allclose(rt["E_traj"], rj["E_traj"], rtol=1e-3)
    assert np.isnan(rt["tecr_traj"]).all()  # ecr 0: the energy change is not tracked
    assert set(rt) == set(rj)
    d = rt["_device"]
    V_dev = (tvfc.con_K(d["X"], d["ctrl"], d["beta"]) @ d["C"]) * d["y_rescale"]
    np.testing.assert_allclose(V_dev.numpy(), rt["V"], rtol=1e-4, atol=1e-5)


def test_sparsevfc_default_beta_and_energy_stop():
    """The whole public call with its own beta and the default ecr (energy
    tracked): beta to 2e-4 and a field that recovers the rotation."""
    X, V = _rotation(noise=0.05)
    rj = jvfc.SparseVFC(X, V, M=80, lambda_=3.0, ecr=1e-3, seed=0)
    rt = tvfc.SparseVFC(X, V, M=80, lambda_=3.0, ecr=1e-3, seed=0, device="cpu")
    assert abs(rt["beta"] - rj["beta"]) <= BETA_RTOL * rj["beta"]
    assert rt["iteration"] == rj["iteration"] < 500
    assert _rel(rt["V"], rj["V"]) <= V_TOL
    assert np.isfinite(rt["tecr_traj"]).all() and float(rt["tecr_traj"][0]) <= 1e-3


def _batch_inputs():
    X, V = _rotation()
    rng = np.random.default_rng(3)
    Xs = np.stack([X, X * 0.9, X * 1.1]).astype(np.float32)
    Vs = np.stack([V + rng.normal(0, s, V.shape).astype(np.float32) for s in (0.05, 0.2, 0.1)])
    _, ctrls, subs = tvfc._batch_ctrl_draws(Xs, 80, 0, True)
    betas = np.asarray([1.0 / float(jvfc._median_positive_sqdist(jnp.asarray(s))) for s in subs], np.float32)
    return Xs, Vs, ctrls, betas


@pytest.mark.parametrize("max_iter,ecr", [(5, 0.0), (60, 0.0), (60, 1e-3)])
def test_em_batch_matches_jax(max_iter, ecr):
    """`_sparsevfc_em_batch` on 3 fields from the same control points and
    betas: V within 1e-3 of max|V| and div/curl within 1e-2 per field, equal
    iteration counts. With ecr 1e-3 the fields stop at 8, 17 and 8 of 60
    iterations; the frozen fields equal the JAX `while_loop`'s."""
    Xs, Vs, ctrls, betas = _batch_inputs()
    oj = jvfc._sparsevfc_em_batch(jnp.asarray(Xs), jnp.asarray(Vs), jnp.asarray(ctrls), jnp.asarray(betas), 0.9, 5.0,
                                  3.0, ecr, 1e-5, max_iter, compute_energy=ecr > 0, with_morphometrics=True)
    ot = tvfc._sparsevfc_em_batch(torch.from_numpy(Xs), torch.from_numpy(Vs), torch.from_numpy(ctrls),
                                  torch.from_numpy(betas), 0.9, 5.0, 3.0, ecr, 1e-5, max_iter,
                                  compute_energy=ecr > 0, with_morphometrics=True)
    it_j, it_t = np.asarray(oj["i"]), ot["i"].numpy()
    np.testing.assert_array_equal(it_t, it_j)
    if ecr > 0:
        assert it_t.min() < it_t.max() < max_iter
    for f in range(3):
        assert _rel(ot["V"][f].numpy(), np.asarray(oj["V"][f])) <= V_TOL
        np.testing.assert_allclose(ot["div"][f].numpy(), np.asarray(oj["div"][f]), atol=GEO_TOL)
        np.testing.assert_allclose(ot["curl"][f].numpy(), np.asarray(oj["curl"][f]), atol=GEO_TOL)
        np.testing.assert_allclose(ot["gamma"][f].numpy(), np.asarray(oj["gamma"][f]), rtol=1e-3)


def test_em_reads_the_host_once_per_block():
    """60 iterations in blocks of CHECK_EVERY: one read of the stop mask per
    block boundary before the last, one of the factorisations' status."""
    Xs, Vs, ctrls, betas = _batch_inputs()
    before = tvfc._run_em.host_reads
    tvfc._sparsevfc_em_batch(torch.from_numpy(Xs), torch.from_numpy(Vs), torch.from_numpy(ctrls),
                             torch.from_numpy(betas), 0.9, 5.0, 3.0, 0.0, 1e-5, 60)
    reads = tvfc._run_em.host_reads - before
    assert reads == -(-60 // tvfc.CHECK_EVERY) - 1 + 1
    before = tvfc._run_em.host_reads
    out = tvfc._sparsevfc_em_batch(torch.from_numpy(Xs), torch.from_numpy(Vs), torch.from_numpy(ctrls),
                                   torch.from_numpy(betas), 0.9, 5.0, 3.0, 1e-3, 1e-5, 60, compute_energy=True)
    # every field stops early: the loop ends at the first block boundary
    # after the last one stops
    last = int(out["i"].max())
    assert last < 50
    assert tvfc._run_em.host_reads - before == -(-last // tvfc.CHECK_EVERY) + 1


def test_batch_public_call_matches_jax():
    """`SparseVFC_batch` end to end (its own betas, ecr 0, 40 iterations) on
    the JAX tests' 3-field input: ctrl, beta, V, div, curl and the keys."""
    X, V = _rotation()
    rng = np.random.default_rng(3)
    fields = np.stack([V + rng.normal(0, 0.05, V.shape).astype(np.float32) for _ in range(3)])
    kw = dict(M=80, lambda_=0.1, MaxIter=40, ecr=0.0, seed=0)
    res_j = jvfc.SparseVFC_batch(np.stack([X] * 3), fields, **kw)
    res_t = tvfc.SparseVFC_batch(np.stack([X] * 3), fields, device="cpu", **kw)
    for rj, rt in zip(res_j, res_t):
        assert set(rt) == set(rj)
        assert rt["iteration"] == rj["iteration"] == 40
        assert abs(rt["beta"] - rj["beta"]) <= BETA_RTOL * rj["beta"]
        assert _rel(rt["V"], rj["V"]) <= V_TOL
        np.testing.assert_allclose(rt["div"], rj["div"], atol=GEO_TOL)
        np.testing.assert_allclose(rt["curl"], rj["curl"], atol=GEO_TOL)
        assert rt["C"].shape == (80, 3) and rt["P"].shape == (len(X),) and rt["gamma"] > 0.06


def test_batch_recovers_rotation_constants():
    """The JAX tests' bars (tests/test_tdr.py:104-145): the fused curl of
    v = omega x r is [0, 0, 2] within 0.3, mean |div| < 0.8; the 2-D curl is
    the scalar 2 within 0.3; the fused div/curl equal those of torch.func's
    Jacobian of the learned field to 1e-2."""
    X, V = _rotation()
    r = tvfc.SparseVFC_batch(X[None], V[None], M=80, lambda_=0.1, MaxIter=60, ecr=0.0, seed=0, device="cpu")[0]
    assert r["div"].shape == (len(X),) and r["curl"].shape == (len(X), 3)
    np.testing.assert_allclose(r["curl"].mean(axis=0), [0, 0, 2], atol=0.3)
    assert np.abs(r["div"]).mean() < 0.8
    ctrl, C = torch.from_numpy(r["X_ctrl"]), torch.from_numpy(r["C"])
    J = torch.func.vmap(torch.func.jacfwd(lambda x: tvfc.vector_field_function_torch(x, ctrl, C, r["beta"])))(
        torch.from_numpy(X[:50])).numpy()
    np.testing.assert_allclose(r["div"][:50], np.trace(J, axis1=1, axis2=2), atol=GEO_TOL)
    curl_ref = np.stack([J[:, 2, 1] - J[:, 1, 2], J[:, 0, 2] - J[:, 2, 0], J[:, 1, 0] - J[:, 0, 1]], axis=1)
    np.testing.assert_allclose(r["curl"][:50], curl_ref, atol=GEO_TOL)

    X2, V2 = _rotation(300, seed=5, dim=2)
    r2 = tvfc.SparseVFC_batch(X2[None], V2[None], M=60, lambda_=0.1, MaxIter=60, ecr=0.0, seed=0, device="cpu")[0]
    assert r2["curl"].shape == (300,)
    np.testing.assert_allclose(r2["curl"].mean(), 2.0, atol=0.3)


def test_field_jacobian_matches_jax():
    """`_field_jacobian` on the same field: J, div and the 2-D scalar curl."""
    rng = np.random.default_rng(0)
    for D in (2, 3):
        pts = rng.uniform(-1, 1, (50, D)).astype(np.float32)
        ctrl = rng.uniform(-1, 1, (20, D)).astype(np.float32)
        C = rng.normal(0, 1, (20, D)).astype(np.float32)
        Jj, dj, cj = jvfc._field_jacobian(jnp.asarray(pts), jnp.asarray(ctrl), jnp.asarray(C), 0.7, 1.3)
        Jt, dt, ct = tvfc._field_jacobian(torch.from_numpy(pts), torch.from_numpy(ctrl), torch.from_numpy(C), 0.7, 1.3)
        np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-5)
        assert ct.shape == ((50,) if D == 2 else (50, 3))


def test_vector_field_function_matches_jax():
    X, V = _rotation()
    res = jvfc.SparseVFC(X, V, M=80, lambda_=0.1, MaxIter=20, seed=0)
    vf = {k: np.asarray(res[k]) for k in ("X_ctrl", "C", "beta")}
    np.testing.assert_allclose(tvfc.vector_field_function(X[:30], vf, device="cpu"),
                               np.asarray(jvfc.vector_field_function(X[:30], vf)), rtol=1e-5, atol=1e-5)


def test_all_outlier_retry_keeps_the_better_fit():
    """A field whose first fit ends with gamma at its floor is fit again from
    Y scaled by 0.1, as in the JAX package: both packages end at the same
    gamma and iteration count on pure noise."""
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, (300, 2)).astype(np.float32)
    V = (rng.standard_cauchy((300, 2)) * 50).astype(np.float32)
    kw = dict(M=30, lambda_=3.0, a=1e4, MaxIter=30, ecr=0.0, seed=0)
    rj = jvfc.SparseVFC(X, V, **kw)
    rt = tvfc.SparseVFC(X, V, beta=rj["beta"], device="cpu", **kw)
    assert rt["iteration"] == rj["iteration"]
    np.testing.assert_allclose(rt["gamma"], rj["gamma"], rtol=1e-3)


def test_float64_input_narrowed_and_mesh_raises():
    X, V = _rotation(200)
    rt = tvfc.SparseVFC(X.astype(np.float64), V.astype(np.float64), M=20, MaxIter=5, seed=0, device="cpu")
    assert rt["V"].dtype == np.float32 and rt["X"].dtype == np.float32
    with pytest.raises(TypeError, match="DeviceMesh"):
        tvfc.SparseVFC(X, V, M=20, MaxIter=5, mesh=object(), device="cpu")


def test_cholesky_failure_raises():
    """A non-SPD M-step system (NaN kernel features) raises after the loop
    instead of carrying NaNs on."""
    K = torch.full((1, 10, 4), float("nan"))
    U = torch.eye(4)[None]
    Y = torch.ones((1, 10, 2))
    with pytest.raises(torch.linalg.LinAlgError):
        tvfc._run_em(K, U, Y, torch.ones(1), 3.0, 0.9, 5.0, 0.0, 1e-5, 3, False, torch.ones(1))


def test_em_row_chunks_match_jax():
    """5,001 rows: the M-step's products over 5 chunks of 1,001 rows (four
    padded rows of weight 0) against the JAX package's single products: V
    within 1e-3 of max|V| per field (measured 2.4e-4 to 2.7e-4; each is
    within 2.9e-4 of an f64 EM), equal iterations, div/curl within 1e-2."""
    rng = np.random.default_rng(4)
    Xs = rng.uniform(-1, 1, (3, 5001, 3)).astype(np.float32)
    Vs = np.cross(np.broadcast_to([0.0, 0.0, 1.0], Xs.shape), Xs).astype(np.float32)
    Vs = (Vs + rng.normal(0, 0.05, Vs.shape)).astype(np.float32)
    assert tvfc._row_chunks(5001) == 5
    _, ctrls, subs = tvfc._batch_ctrl_draws(Xs, 100, 1, True)
    betas = np.asarray(jnp.stack([jvfc._median_positive_sqdist(jnp.asarray(s)) for s in subs]))
    betas = (1.0 / betas).astype(np.float32)
    oj = jvfc._sparsevfc_em_batch(jnp.asarray(Xs), jnp.asarray(Vs), jnp.asarray(ctrls), jnp.asarray(betas), 0.9, 5.0,
                                  3.0, 0.0, 1e-5, 60)
    ot = tvfc._sparsevfc_em_batch(torch.from_numpy(Xs), torch.from_numpy(Vs), torch.from_numpy(ctrls),
                                  torch.from_numpy(betas), 0.9, 5.0, 3.0, 0.0, 1e-5, 60)
    assert ot["V"].shape == (3, 5001, 3) and ot["P"].shape == (3, 5001)
    np.testing.assert_array_equal(ot["i"].numpy(), np.asarray(oj["i"]))
    for f in range(3):
        assert _rel(ot["V"][f].numpy(), np.asarray(oj["V"][f])) <= V_TOL
        np.testing.assert_allclose(ot["div"][f].numpy(), np.asarray(oj["div"][f]), atol=GEO_TOL)
        np.testing.assert_allclose(ot["curl"][f].numpy(), np.asarray(oj["curl"][f]), atol=GEO_TOL)


@pytest.mark.parametrize("N,n_chunks", [(4096, 4), (6001, 6), (1024, 1)])
def test_tmm_chunks_and_padding(N, n_chunks):
    """The chunked A^T B over N rows, padded with fewer than `n_chunks` zero
    rows as `_run_em` pads them, equals one product over the N rows to f32
    rounding; `_run_em` returns V = K C and P over the N rows alone."""
    rng = np.random.default_rng(N)
    X = torch.from_numpy(rng.uniform(-1, 1, (2, N, 3)).astype(np.float32))
    Y = torch.from_numpy(rng.normal(size=(2, N, 3)).astype(np.float32))
    assert tvfc._row_chunks(N) == n_chunks
    pad = -(-N // n_chunks) * n_chunks - N
    assert pad < n_chunks
    A = torch.exp(-X.abs())
    Ap, Yp = (torch.cat([t, t.new_zeros((2, pad, 3))], 1) for t in (A, Y))
    ref = torch.bmm(A.double().transpose(1, 2), Y.double())
    np.testing.assert_allclose(tvfc._tmm(Ap, Yp).double().numpy(), ref.numpy(), rtol=1e-4, atol=1e-3)
    ctrl = X[:, :8]
    K, U = tvfc.con_K(X, ctrl, torch.ones(2)), tvfc.con_K(ctrl, ctrl, torch.ones(2))
    y_scale = torch.sqrt((Y * Y).mean((1, 2)))
    s = tvfc._run_em(K, U, Y, y_scale, 3.0, 0.9, 5.0, 0.0, 1e-5, 3, False, torch.ones(2))
    assert s["V"].shape == (2, N, 3) and s["P"].shape == (2, N) and bool(torch.isfinite(s["V"]).all())
    torch.testing.assert_close(s["V"], torch.bmm(K, s["C"]))
