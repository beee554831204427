"""The sharded paths beyond the main path: `iwls_batch_sharded`,
`cal_wass_dis_batch_sharded`, `MERFISHVI.train(mesh=)` and Morpho's sparse
calculation mode under `mesh=`, held against the unsharded port and the JAX
package on the CPU.

The port's ranks are gloo groups of 4 and of 3 ranks on the CPU
(`_torch_ranks.run_groups`), every rank returning the same bits; the JAX
side runs in the pytest process on the 8-device CPU mesh that
`tests/conftest.py` forces.

Bars:

- `iwls_batch_sharded` at the JAX package's own test shape
  (`tests/test_tools.py:630-650`: n 200, k 3, q 200 and q 37), gaussian,
  poisson and nb: betas within 1e-5 and hats within 1e-6 of the port's
  `iwls_batch`, and of the JAX package's `iwls_batch_sharded`.
- `cal_wass_dis_batch_sharded` at the JAX package's test shape
  (`tests/test_svg.py:170-177`: N 48, G 13): rtol 1e-4, atol 1e-6 against
  the port's `cal_wass_dis_batch` and the JAX package's sharded scan; with a
  larger eps (0.1 of the largest cost), where the ranks' own blocks would
  stop at other sweeps, and with a zero bin in the target (the stop test
  NaN): the same sweeps as one unchunked batch on one rank, and the same
  distances (rtol 1e-4, atol 1e-6; the JAX package's too at that eps).
- `MERFISHVI.train(mesh=)` from the JAX package's weights with its draws
  replayed: full batch at n 60, g 12 (the JAX package pads to 64 on its 8
  devices) and a minibatch at n 48: losses within 2e-4 of the unsharded
  port and of the JAX package's `train(mesh=create_mesh((8,), ("data",)))`;
  at n 62 the port's own padding (64 and 63 rows) within 2e-4 of the
  unsharded port. The smoothness penalty is dropped under a mesh (the same
  bits as a model without it), and the spatial encoder refuses a mesh, as
  in the JAX package.
- Morpho's sparse calculation mode (`sparse_top_k` 100 on the 256-cell pair
  of `test_torch_parallel_morpho.py`, 40 iterations): coordinates within
  1e-4 of the unsharded port and within `COORD_TOL` = 2e-3 of the JAX
  package's `morpho_align(mesh=)`; the E-step on the 1,600 x 600 case at
  sigma2 2e-2, where a column top-k of 64 or 500 moves every reduction by
  more than 1e-3 of its scale (500 is more rows than a rank of 4 holds),
  dense and chunked: every reduction within 1e-5 of scale of the unsharded
  port's and within 5e-4 of the JAX package's dense one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spateo_tpu as st
import spateo_tpu_torch as stt
from _torch_ranks import run_groups, same_bits
from spateo_tpu.alignment.methods import math as jm
from spateo_tpu.external import merfishvi as JM
from spateo_tpu.parallel.mesh import create_mesh as jax_mesh
from spateo_tpu.svg import utils as jsu
from spateo_tpu.tools.CCI_effects_modeling import regression_utils as jru
from spateo_tpu_torch.alignment.methods import math as tm
from spateo_tpu_torch.core.bridge import adata_from_reference, merfishvi_params_from_reference
from spateo_tpu_torch.external import merfishvi as TM
from spateo_tpu_torch.svg import utils as tsu
from spateo_tpu_torch.tools.CCI_effects_modeling import regression_utils as tru

WORLDS = (4, 3)
DISTRS = ("gaussian", "poisson", "nb")
QS = (200, 37)
LOSS_TOL = 2e-4
COORD_TOL = 2e-3
EPOCHS = 8
MORPHO_KW = dict(max_iter=40, sparse_calculation_mode=True, sparse_top_k=100)
SHIFT = 0.4
ESTEP_KS = (64, 500)
ESTEP_SIGMA2 = 2e-2
ESTEP_ROUTES = ("dense", "chunked")
WASS_CASES = ("default", "eps", "zero bin")
ESTEP_KEYS = ("K_NA", "K_NA_spatial", "K_NA_sigma2", "K_NB", "Sp", "sigma2_related", "PXB", "M1")


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


def _scaled_err(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return float(np.max(np.abs(ref - out)) / (np.max(np.abs(ref)) + 1e-30))


# -- the cases -----------------------------------------------------------------------------------------------


def _iwls_case(distr):
    """n 200, k 3: the JAX package's sharded test's X and W; y a linear
    response (gaussian) or counts of a log-linear rate."""
    rng = np.random.default_rng(0)
    n, k = 200, 3
    X = rng.normal(size=(n, k)).astype(np.float32)
    beta = np.array([1.0, -2.0, 0.5], np.float32)
    if distr == "gaussian":
        y = (X @ beta + 0.01 * rng.normal(size=n)).astype(np.float32)
    else:
        y = rng.poisson(np.exp(np.clip(0.3 * (X @ beta), -3, 3))).astype(np.float32)
    pos = np.linspace(0, 1, n)
    W = np.exp(-(((pos[:, None] - pos[None, :]) / 0.1) ** 2)).astype(np.float32)
    return y, X, W


def _wass_case(case="default"):
    """(M, A, b, eps): N 48, G 13; "eps" stops after 60 sweeps, "zero bin"
    after 20 (its stop test is NaN)."""
    rng = np.random.default_rng(0)
    N, G = 48, 13
    pts = rng.uniform(0, 1, (N, 2))
    M = np.sqrt(((pts[:, None] - pts[None, :]) ** 2).sum(-1)).astype(np.float32)
    A = rng.dirichlet(np.ones(N), G).astype(np.float32)
    b, eps = None, None
    if case == "eps":
        eps = float(M.max() * 0.1)
    if case == "zero bin":
        b = np.ones(N, np.float32) / (N - 1)
        b[5] = 0.0
    return M, A, b, eps


def _vi_adata(n, seed=0, coords=False):
    rng = np.random.default_rng(seed)
    g = 12
    X = rng.poisson(3.0, (n, g)).astype(np.float32)
    a = st.AnnData(X=X, obs=pd.DataFrame(index=[f"c{i}" for i in range(n)]),
                   var=pd.DataFrame(index=[f"g{j}" for j in range(g)]))
    if coords:
        a.obsm["spatial"] = rng.uniform(0, 10, (n, 2))
    st.SKM.init_adata_type(a, "UMI")
    return a


def _jax_draws(seed, epochs, rows, L, n_pick=0, B=0):
    """`_train_vae`'s draws in the JAX package, by replaying its key splits:
    each epoch's latent normals over `rows` rows (the padded cells, or the
    batch), and with `B` the minibatch drawn from `n_pick` rows."""
    key, noise, idx = jax.random.PRNGKey(seed), [], []
    for _ in range(epochs):
        key, k1, k2 = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(k1, (rows, L))))
        if B:
            idx.append(np.asarray(jax.random.choice(k2, n_pick, (B,), replace=False)))
    return np.stack(noise), (np.array(idx) if B else None)


#: MERFISHVI cases: (cells, constructor keywords, cells the JAX package
#: pads to on 8 devices, minibatch).
VI_CASES = {
    "full": (60, {}, 64, 0),
    "minibatch": (48, dict(batch_size=16), 48, 16),
    "penalty": (60, dict(spatial_weight=0.5), 64, 0),
}
VI_SEED = 3


def _vi_inputs(case):
    n, kw, n_jax, B = VI_CASES[case]
    a = _vi_adata(n, coords=True)
    mj = JM.MERFISHVI(a.copy(), n_latent=4, n_hidden=16, seed=VI_SEED, **kw)
    params = jax.tree_util.tree_map(np.asarray, mj.params)
    noise, idx = _jax_draws(VI_SEED, EPOCHS, B or n_jax, 4, n_jax, B)
    # the port pads nothing at 60 or 48 cells on 4 or 3 ranks: the real rows' draws
    return a, kw, params, (noise if B else noise[:, :n]), idx


def _padded_vi_inputs():
    """n 62: the port pads to 64 on 4 ranks and to 63 on 3; each run takes
    the first rows of one [epochs, 64, 4] draw, and the weights are the
    port's own (`seed`)."""
    a = _vi_adata(62, seed=1)
    noise = np.random.default_rng(2).normal(size=(EPOCHS, 64, 4)).astype(np.float32)
    return a, noise


def _estep_case():
    rng = np.random.default_rng(1)
    NA, B, G = 1600, 600, 12
    pts = rng.uniform(0, 1, (NA, 2)).astype(np.float32)
    XAHat = pts[np.argsort(jm.morton_code(pts))]
    ptsB = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    coordsB = ptsB[np.argsort(jm.morton_code(ptsB))]
    XA, XB = rng.poisson(2.0, (NA, G)).astype(np.float32), rng.poisson(2.0, (B, G)).astype(np.float32)
    a, b, A, Bf = (x.numpy() for x in tm.factorize_distance(XA, XB, "kl"))
    f = np.float32
    return dict(XAHat=XAHat, coordsA=XAHat.copy(), coordsB=coordsB, a_rows=a, b_cols=b, A_feats=A, B_feats=Bf,
                model_mul_vec=rng.uniform(0.5, 1, NA).astype(np.float32), sigma2=f(2e-4), gamma=f(0.7),
                samples_s=f(1.0), sigma2_variance=f(2.0), p=f(0.3))


def _pair():
    rng = np.random.default_rng(0)
    n = 256
    pts = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    X = rng.poisson(2.0, (n, 10)).astype(np.float32)
    return pts, X


def _slice(pkg, p, X):
    n, g = X.shape
    a = pkg.AnnData(X=X.copy(), obs=pd.DataFrame(index=[f"c{i}" for i in range(n)]),
                    var=pd.DataFrame(index=[f"g{j}" for j in range(g)]))
    a.obsm["spatial"] = p.copy()
    pkg.SKM.init_adata_type(a, "UMI")
    return a


# -- the ranks -----------------------------------------------------------------------------------------------


def _vi_job(case):
    a, kw, params, noise, idx = _vi_inputs(case)
    return ("merfishvi", dict(X=np.asarray(a.X), params=params, epochs=EPOCHS, kw=kw, noise=noise,
                              batch_indices=idx, coords=np.asarray(a.obsm["spatial"])))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    names, common = [], []
    for distr in DISTRS:
        y, X, W = _iwls_case(distr)
        for q in QS:
            names.append(("iwls", distr, q))
            common.append(("iwls", dict(y=y, X=X, W=W[:q], distr=distr)))
    for c in WASS_CASES:
        M, A, b, eps = _wass_case(c)
        names.append(("wass", c))
        common.append(("wass", dict(M=M, A=A, b=b, eps=eps)))
    for case in VI_CASES:
        names.append(("vi", case))
        common.append(_vi_job(case))
    pts, X = _pair()
    names.append(("morpho",))
    common.append(("morpho", dict(pts=pts, X=X, shift=SHIFT, kw=MORPHO_KW)))
    case = dict(_estep_case(), sigma2=np.float32(ESTEP_SIGMA2))
    for r in ESTEP_ROUTES:
        for k in ESTEP_KS:
            names.append(("estep", r, k))
            common.append(("estep", dict(args=case, route=r, sparse_top_k=k)))
    a, noise = _padded_vi_inputs()
    groups = {}
    for w in WORLDS:
        rows = -(-62 // w) * w
        groups[w] = common + [("merfishvi", dict(X=np.asarray(a.X), params=None, epochs=EPOCHS,
                                                 kw=dict(seed=VI_SEED), noise=noise[:, :rows]))]
    out = run_groups(groups, tmp_path_factory.mktemp("tools"))
    names.append(("vi", "padded"))
    return {w: {n: [r[i] for r in per_rank] for i, n in enumerate(names)} for w, per_rank in out.items()}


JOBS = ([("iwls", d, q) for d in DISTRS for q in QS] + [("wass", c) for c in WASS_CASES]
        + [("vi", c) for c in VI_CASES] + [("vi", "padded"), ("morpho",)]
        + [("estep", r, k) for r in ESTEP_ROUTES for k in ESTEP_KS])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("job", JOBS, ids=lambda j: "-".join(map(str, j)))
def test_every_rank_returns_the_same_bits(ranks, world, job):
    assert same_bits(ranks[world][job])


# -- iwls_batch_sharded ----------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def iwls_refs():
    out = {}
    for distr in DISTRS:
        y, X, W = _iwls_case(distr)
        port = tru.iwls_batch(y, X, W, distr=distr, device="cpu")
        for q in QS:
            jb, jh = jru.iwls_batch_sharded(y, X, W[:q], mesh=jax_mesh(), distr=distr)
            out[distr, q] = (port[0][:q], port[1][:q]), (np.asarray(jb), np.asarray(jh))
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("distr", DISTRS)
def test_iwls_batch_sharded_matches_iwls_batch_and_jax(ranks, iwls_refs, world, q, distr):
    b, h = ranks[world][("iwls", distr, q)][0]
    assert b.shape == (q, 3) and h.shape == (q,)
    for rb, rh in iwls_refs[distr, q]:
        np.testing.assert_allclose(b, rb, atol=1e-5)
        np.testing.assert_allclose(h, rh, atol=1e-6)


def test_iwls_batch_sharded_uses_global_focal_rows():
    """On a one-rank mesh the whole of W is one block; the leverage of row i
    is taken against X's row i, so the hats equal `iwls_batch`'s in small
    blocks too (the JAX package's block-invariance regression)."""
    y, X, W = _iwls_case("poisson")
    try:
        mesh = stt.parallel.create_mesh(device="cpu")
        b, h = tru.iwls_batch_sharded(y, X, W, mesh=mesh, distr="poisson")
    finally:
        torch.distributed.destroy_process_group()
    rb, rh = tru.iwls_batch(y, X, W, distr="poisson", block=48, device="cpu")
    np.testing.assert_allclose(b, rb, atol=1e-5)
    np.testing.assert_allclose(h, rh, atol=1e-6)


# -- cal_wass_dis_batch_sharded --------------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_scan_matches_serial_and_jax(ranks, world):
    M, A, _, _ = _wass_case()
    d, _ = ranks[world][("wass", "default")][0]
    np.testing.assert_allclose(d, tsu.cal_wass_dis_batch(M, A, device="cpu"), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(d, jsu.cal_wass_dis_batch_sharded(M, A, mesh=jax_mesh()), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ("eps", "zero bin"))
def test_sharded_scan_stops_as_one_batch(ranks, world, case):
    """Every rank stops at the sweep where one unchunked batch of all the
    genes on one rank stops (its own rows would stop earlier at this eps),
    and NaN stops it as in the JAX package; the distances agree."""
    M, A, b, eps = _wass_case(case)
    d, sweeps = ranks[world][("wass", case)][0]
    bt = torch.full((M.shape[0],), 1.0 / M.shape[0]) if b is None else torch.from_numpy(b)
    e = eps if eps is not None else float(max(M.max() * 5e-3, 1e-6))
    ref, it = tsu._sinkhorn_batch_run(torch.from_numpy(A), bt, torch.from_numpy(M), e, 200)
    assert sweeps == it < 200
    np.testing.assert_allclose(d, ref.numpy(), rtol=1e-4, atol=1e-6, equal_nan=True)
    if case == "eps":
        np.testing.assert_allclose(d, jsu.cal_wass_dis_batch_sharded(M, A, eps=eps, mesh=jax_mesh()), rtol=1e-4,
                                   atol=1e-6)


# -- MERFISHVI.train(mesh=) ------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vi_refs():
    """Per case: the unsharded port's losses on the same weights and draws,
    and the JAX package's `train(mesh=)` on its 8-device mesh."""
    out = {}
    for case in VI_CASES:
        a, kw, params, noise, idx = _vi_inputs(case)
        mt = TM.MERFISHVI(adata_from_reference(a), n_latent=4, n_hidden=16, device="cpu", seed=VI_SEED,
                          **{k: v for k, v in kw.items() if k != "spatial_weight"})
        merfishvi_params_from_reference(params, model=mt)
        lt = mt.train(max_epochs=EPOCHS, noise=[[torch.from_numpy(e)] for e in noise],
                      batch_indices=None if idx is None else torch.from_numpy(idx))
        mj = JM.MERFISHVI(a.copy(), n_latent=4, n_hidden=16, seed=VI_SEED, **kw)
        lj = mj.train(max_epochs=EPOCHS, mesh=jax_mesh((8,), ("data",)))
        out[case] = lt, np.asarray(lj)
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(VI_CASES))
def test_merfishvi_mesh_matches_unsharded_port_and_jax(ranks, vi_refs, world, case):
    r = ranks[world][("vi", case)][0]
    lt, lj = vi_refs[case]
    assert np.isfinite(r["losses"]).all() and r["losses"][-1] < r["losses"][0]
    np.testing.assert_allclose(r["losses"], lt, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(r["losses"], lj, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert r["latent"].shape == (VI_CASES[case][0], 4)


@pytest.mark.parametrize("world", WORLDS)
def test_merfishvi_mesh_drops_the_penalty(ranks, world):
    """Under a mesh the smoothness penalty is not added (the JAX package's
    ``spatial_mode="none"``): the same bits as the model without it."""
    pen, none = ranks[world][("vi", "penalty")][0], ranks[world][("vi", "full")][0]
    assert same_bits([pen["losses"], none["losses"]]) and same_bits([pen["weights"], none["weights"]])


@pytest.mark.parametrize("world", WORLDS)
def test_merfishvi_mesh_pads_rows(ranks, world):
    """62 cells padded to 64 (4 ranks) or 63 (3): the padding rows weigh 0,
    so the losses are the unsharded port's on the same draws."""
    a, noise = _padded_vi_inputs()
    mt = TM.MERFISHVI(adata_from_reference(a), n_latent=4, n_hidden=16, device="cpu", seed=VI_SEED)
    lt = mt.train(max_epochs=EPOCHS, noise=[[torch.from_numpy(e[:62])] for e in noise])
    r = ranks[world][("vi", "padded")][0]
    np.testing.assert_allclose(r["losses"], lt, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_merfishvi_mesh_refuses_the_spatial_encoder():
    a = _vi_adata(30, coords=True)
    mt = TM.MERFISHVI(adata_from_reference(a), n_latent=4, n_hidden=16, spatial_encoder=True, n_spatial=4,
                      device="cpu")
    mj = JM.MERFISHVI(a.copy(), n_latent=4, n_hidden=16, spatial_encoder=True, n_spatial=4)
    with pytest.raises(NotImplementedError, match="spatial_encoder training is single-device") as et:
        mt.train(max_epochs=1, mesh=object())
    with pytest.raises(NotImplementedError) as ej:
        mj.train(max_epochs=1, mesh=jax_mesh((8,), ("data",)))
    assert str(et.value) == str(ej.value)


# -- Morpho's sparse calculation mode --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def morpho_refs():
    pts, X = _pair()
    mt, _ = stt.align.morpho_align([_slice(stt, pts, X), _slice(stt, pts + SHIFT, X)], verbose=False,
                                   device="cpu", **MORPHO_KW)
    mj, _ = st.align.morpho_align([_slice(st, pts, X), _slice(st, pts + SHIFT, X)], verbose=False,
                                  mesh=jax_mesh(axis_names=("data",)), **MORPHO_KW)
    return mt[1], mj[1]


@pytest.mark.parametrize("world", WORLDS)
def test_sparse_morpho_mesh_matches_unsharded_port_and_jax(ranks, morpho_refs, world):
    mt, mj = morpho_refs
    r = ranks[world][("morpho",)][0]
    for key, k in (("align", "align_spatial"), ("nonrigid", "align_spatial_nonrigid")):
        np.testing.assert_allclose(r[key], mt.obsm[k], atol=1e-4)
        np.testing.assert_allclose(r[key], np.asarray(mj.obsm[k]), atol=COORD_TOL)


@pytest.fixture(scope="module")
def sparse_estep_refs():
    c = dict(_estep_case(), sigma2=np.float32(ESTEP_SIGMA2))
    T = {k: torch.as_tensor(v) for k, v in c.items()}
    J = {k: jnp.asarray(v) for k, v in c.items()}
    port, jax_dense = {}, {}
    for route in ESTEP_ROUTES:
        for k in (0,) + ESTEP_KS:
            out = tm.estep_reduced(2.0, T["XAHat"], T["coordsA"], T["coordsB"], (T["a_rows"],), (T["b_cols"],),
                                   (T["A_feats"],), (T["B_feats"],), T["sigma2"], T["model_mul_vec"], T["gamma"],
                                   T["samples_s"], T["sigma2_variance"], ["gauss"], [T["p"]],
                                   n_chunks=1 if route == "dense" else 3, sparse_top_k=k)
            port[route, k] = {key: v.numpy() for key, v in out.items()}
    for k in ESTEP_KS:
        out = jm.estep_reduced(2.0, J["XAHat"], J["coordsA"], J["coordsB"], (J["a_rows"],), (J["b_cols"],),
                               (J["A_feats"],), (J["B_feats"],), J["sigma2"], J["model_mul_vec"], J["gamma"],
                               J["samples_s"], J["sigma2_variance"], ["gauss"], [J["p"]], n_chunks=1,
                               sparse_top_k=k)
        jax_dense[k] = {key: np.asarray(v) for key, v in out.items()}
    return port, jax_dense


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("k", ESTEP_KS)
@pytest.mark.parametrize("route", ESTEP_ROUTES)
def test_sharded_sparse_estep_matches_unsharded(ranks, sparse_estep_refs, world, route, k):
    port, jax_dense = sparse_estep_refs
    ref = port[route, k]
    out = ranks[world][("estep", route, k)][0]
    assert set(out) == set(ESTEP_KEYS)
    for key in ("K_NA", "K_NB", "PXB", "M1"):  # the cut matters at this sigma2
        assert _scaled_err(port[route, 0][key], ref[key]) > 1e-3, key
    for key in ESTEP_KEYS:
        assert out[key].shape == ref[key].shape, key
        assert _scaled_err(ref[key], out[key]) < 1e-5, (key, _scaled_err(ref[key], out[key]))
        assert _scaled_err(jax_dense[k][key], out[key]) < 5e-4, key
