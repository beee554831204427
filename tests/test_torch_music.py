"""The port's MuSIC (`spateo_tpu_torch.tools`) against the JAX package's on
the CPU.

The solver and the weights are held apart. Given the same spatial weights W,
the batched IWLS of both packages (the same pivot-free Gauss-Jordan in the
same order) agree to ~1e-6 of scale; the bar is 1e-5. The weights cannot
agree bit for bit: both compute distances as |q|^2 + |c|^2 - 2 q.c^T, and at
nearly coincident points the distance is the square root of a cancellation
residual in either package. They are held to 2e-3 absolute, with at most
1e-4 of the nonzeros moving in or out of the support. Whole fits share the
design through `core.bridge.music_state_from_reference`, so that only the
conditioned weights and the solver's rounding separate them.
"""

import os
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.tools import find_neighbors as jfn
from spateo_tpu.tools import spatial_degs as jsd
from spateo_tpu.tools.CCI_effects_modeling import distributions as jdist
from spateo_tpu.tools.CCI_effects_modeling import regression_utils as jru
from spateo_tpu_torch.core.bridge import adata_from_reference, music_state_from_reference
from spateo_tpu_torch.tools import find_neighbors as tfn
from spateo_tpu_torch.tools import spatial_degs as tsd
from spateo_tpu_torch.tools.CCI_effects_modeling import distributions as tdist
from spateo_tpu_torch.tools.CCI_effects_modeling import regression_utils as tru

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVER_TOL = 1e-5  # of max|value|, same W
WEIGHT_ATOL, FLIP_SHARE = 2e-3, 1e-4
#: Whole fits from the same design: coefficients and standard errors within
#: this share of their largest magnitude. Measured on the `lr_adata` fixture
#: (CPU): coefficients 1.75e-5 (gaussian) and 1.83e-5 (poisson) at bw 10,
#: 2.34e-5 after the poisson bandwidth search; standard errors <= 1.08e-5.
#: Given the same W the solvers agree to ~1e-6 (the tests above), so the
#: conditioned weights' rounding sets the gap; the bar is under 3x each.
FIT_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch and for numpy's pools: the tier-1 run
    shares the CPU among its workers, where those pools only contend."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _scaled(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _problem(n=240, k=6, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 50, (n, 2)).astype(np.float32)
    X = rng.normal(0, 0.3, (n, k)).astype(np.float32)
    X[:, 0] = 1.0
    beta = rng.normal(0, 0.4, k)
    y = rng.poisson(np.exp(np.clip(X @ beta, -4, 4))).astype(np.float32)
    return coords, X, y


def _jax_weights(coords, bw=8.0, fixed=True, exclude_self=False, kernel="bisquare"):
    """W [n, n] from the JAX package (host array)."""
    return jfn.get_wi_batch(coords, bw, fixed_bw=fixed, exclude_self=exclude_self, kernel=kernel)


# ---------------------------------------------------------------------------
# the solver, given the JAX package's W
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("distr", ["gaussian", "poisson", "nb"])
@pytest.mark.parametrize("kernel", ["bisquare", "gaussian"])
def test_iwls_batch_kernel_matches_jax(distr, kernel):
    """`_iwls_batch_kernel` (betas, hats) from the JAX package's W, ridge 0.3,
    clip 5, 25 IRLS iterations, every cell a query."""
    coords, X, y = _problem()
    W = _jax_weights(coords, kernel=kernel)
    bj, hj = jru._iwls_batch_kernel(jnp.asarray(y), jnp.asarray(X), jnp.asarray(W), 0.3, 5.0, distr, 25)
    bt, ht = tru._iwls_batch_kernel(torch.from_numpy(y), torch.from_numpy(X), torch.from_numpy(W), 0.3, 5.0, distr, 25)
    assert _scaled(bt, bj) <= SOLVER_TOL
    assert _scaled(ht, hj) <= SOLVER_TOL


@pytest.mark.parametrize("distr", ["gaussian", "poisson", "nb"])
def test_iwls_batch_full_kernel_matches_jax(distr):
    """`_iwls_batch_full_kernel` (betas, hats, inv_diag, preds) for a shuffled
    subset of focal cells, from the JAX package's adaptive W."""
    coords, X, y = _problem(seed=1)
    focal = np.random.default_rng(2).permutation(len(y))[:100]
    W = np.asarray(jfn._kernel_weights_batch(jnp.asarray(coords[focal]), jnp.asarray(coords), jnp.asarray(20),
                                             fixed=False, self_idx=jnp.asarray(focal.astype(np.int32))))
    outj = jru._iwls_batch_full_kernel(jnp.asarray(y), jnp.asarray(X), jnp.asarray(W), jnp.asarray(focal), 0.3, 5.0,
                                       distr, 25)
    outt = tru._iwls_batch_full_kernel(torch.from_numpy(y), torch.from_numpy(X), torch.from_numpy(W),
                                       torch.from_numpy(focal), 0.3, 5.0, distr, 25)
    for a, b in zip(outt, outj):
        assert _scaled(a, b) <= SOLVER_TOL


@pytest.mark.parametrize("focal", [False, True])
@pytest.mark.parametrize("distr", ["gaussian", "poisson"])
def test_iwls_batch_full_blocks_match_jax(distr, focal):
    """`iwls_batch_full` over 4 blocks of 64 rows (and a ragged last one),
    with and without explicit focal rows, against the JAX package's blocked
    loop on the same W; and the same rows as one block."""
    coords, X, y = _problem(n=230, seed=3)
    f = np.random.default_rng(4).permutation(230)[:200] if focal else None
    W = _jax_weights(coords, bw=10.0)
    W = W[f] if focal else W
    kw = dict(focal=f, distr=distr, ridge_lambda=0.3, clip=5.0)
    outj = jru.iwls_batch_full(y, X, W, block=64, **kw)
    outt = tru.iwls_batch_full(y, X, W, block=64, device="cpu", **kw)
    whole = tru.iwls_batch_full(y, X, W, block=1024, device="cpu", **kw)
    for a, b, c in zip(outt, outj, whole):
        assert a.shape == b.shape
        assert _scaled(a, b) <= SOLVER_TOL
        assert _scaled(a, c) <= SOLVER_TOL


@pytest.mark.parametrize("distr", ["gaussian", "nb"])
def test_iwls_batch_matches_jax(distr):
    """`iwls_batch` in blocks: each block's leverages are its global rows'."""
    coords, X, y = _problem(n=200, seed=5)
    W = _jax_weights(coords, bw=12.0)
    bj, hj = jru.iwls_batch(y, X, W, distr=distr, ridge_lambda=0.3, block=64)
    bt, ht = tru.iwls_batch(y, X, W, distr=distr, ridge_lambda=0.3, block=64, device="cpu")
    assert _scaled(bt, bj) <= SOLVER_TOL and _scaled(ht, hj) <= SOLVER_TOL


def test_iwls_batch_keeps_a_tensor_where_it_lies():
    """A weight tensor is used on its own device; the results are host
    arrays, and `device=` does not move it."""
    coords, X, y = _problem(n=80, seed=6)
    W = torch.from_numpy(_jax_weights(coords, bw=20.0, kernel="gaussian"))
    b, h, d, p = tru.iwls_batch_full(y, X, W, distr="poisson", device="meta")
    assert isinstance(b, np.ndarray) and b.shape == (80, X.shape[1]) and np.isfinite(b).all()


@pytest.mark.parametrize("k", [3, 12, 33])
def test_solve_spd_batched_matches_jax(k):
    """The pivot-free Gauss-Jordan on random SPD systems, k = 33 past the
    pair-feature limit; against the JAX package's and `torch.linalg.solve`."""
    rng = np.random.default_rng(k)
    G = rng.normal(size=(50, k, k)).astype(np.float32)
    A = G @ G.transpose(0, 2, 1) + k * np.eye(k, dtype=np.float32)
    B = rng.normal(size=(50, k, 2)).astype(np.float32)
    xt = tru._solve_spd_batched(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    xj = np.asarray(jru._solve_spd_batched(jnp.asarray(A), jnp.asarray(B)))
    ref = np.linalg.solve(A.astype(np.float64), B.astype(np.float64))
    assert _scaled(xt, xj) <= SOLVER_TOL
    assert _scaled(xt, ref) <= 1e-4


def test_solve_spd_writes_the_pivot_row_after_the_elimination():
    """The elimination reads row j: written first (in place), the result is
    wrong. A 2x2 system pins the order."""
    A = torch.tensor([[[4.0, 2.0], [2.0, 3.0]]])
    B = torch.tensor([[[2.0], [1.0]]])
    x = tru._solve_spd_batched(A, B)
    assert torch.allclose(x, torch.linalg.solve(A, B), atol=1e-6)


def test_pair_features_and_einsum_path_agree():
    """k > 32 takes the einsum path for the normal matrices; it gives the
    wide product's result."""
    rng = np.random.default_rng(7)
    X = torch.from_numpy(rng.normal(size=(40, 5)).astype(np.float32))
    wt = torch.from_numpy(rng.random((7, 40)).astype(np.float32))
    eye = torch.eye(5) * 0.3
    a = tru._xtx_gemm(wt, X, tru._pair_features(X), eye)
    b = tru._xtx_gemm(wt, X, None, eye)
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)
    assert tru._pair_features(torch.zeros(4, 33)) is None


def test_auto_block_is_the_jax_formula():
    for q, n in [(100, 100), (8192, 8192), (50_000, 50_000), (3000, 200_000)]:
        assert tru._auto_block(q, n) == jru._auto_block(q, n)


# ---------------------------------------------------------------------------
# the weights
# ---------------------------------------------------------------------------
def _weights_close(Wt, Wj):
    Wt, Wj = np.asarray(Wt), np.asarray(Wj)
    flips = int(((Wt > 0) != (Wj > 0)).sum())
    nnz = max(int((Wj > 0).sum()), 1)
    assert np.abs(Wt - Wj).max() <= WEIGHT_ATOL
    assert flips <= FLIP_SHARE * nnz


@pytest.mark.parametrize("cov", [False, True])
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("fixed,bw", [(True, 8.0), (False, 12)])
def test_conditioned_weights_match_jax(fixed, bw, exclude_self, cov):
    """`_conditioned_kernel_weights_batch` on 300 queries of 600 points in
    [0, 100]^2, with cell-type conditioning and optionally the cov mask."""
    rng = np.random.default_rng(8)
    n = 600
    coords = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    q = rng.permutation(n)[:300]
    ct = rng.integers(1, 4, n).astype(np.int32)
    cond = rng.random(300) < 0.5
    cov_all, cond_cov = rng.random(n) < 0.7, rng.random(300) < 0.5
    kw = dict(function="bisquare", fixed=fixed, exclude_self=exclude_self)
    Wj = jfn._conditioned_kernel_weights_batch(
        jnp.asarray(coords[q]), jnp.asarray(coords), jnp.asarray(bw, jnp.float32) if fixed else jnp.asarray(bw),
        jnp.asarray(ct[q]), jnp.asarray(ct), jnp.asarray(cond),
        jnp.asarray(cov_all) if cov else None, jnp.asarray(cond_cov) if cov else None,
        self_idx=jnp.asarray(q.astype(np.int32)), **kw,
    )
    Wt = tfn._conditioned_kernel_weights_batch(
        torch.from_numpy(coords[q]), torch.from_numpy(coords), bw, torch.from_numpy(ct[q]), torch.from_numpy(ct),
        torch.from_numpy(cond), torch.from_numpy(cov_all) if cov else None,
        torch.from_numpy(cond_cov) if cov else None, self_idx=torch.from_numpy(q), **kw,
    )
    _weights_close(Wt, Wj)
    if exclude_self:
        assert float(Wt[torch.arange(300), torch.from_numpy(q)].abs().max()) == 0.0


@pytest.mark.parametrize("kernel", ["triangular", "uniform", "quadratic", "bisquare", "gaussian", "exponential"])
@pytest.mark.parametrize("fixed,bw", [(True, 9.0), (False, 10)])
def test_get_wi_batch_matches_jax(kernel, fixed, bw):
    """All-pairs weights in blocks (block 128 over 400 points)."""
    coords = np.random.default_rng(9).uniform(0, 100, (400, 2)).astype(np.float32)
    kw = dict(fixed_bw=fixed, exclude_self=True, kernel=kernel, block=128)
    _weights_close(tfn.get_wi_batch(coords, bw, device="cpu", **kw), jfn.get_wi_batch(coords, bw, **kw))


def test_kernel_weights_normalize_and_unknown_kernel():
    coords = np.random.default_rng(10).uniform(0, 100, (150, 2)).astype(np.float32)
    c = torch.from_numpy(coords)
    Wt = tfn._kernel_weights_batch(c, c, 15, fixed=False, normalize=True, self_idx=torch.arange(150))
    Wj = jfn._kernel_weights_batch(jnp.asarray(coords), jnp.asarray(coords), jnp.asarray(15), fixed=False,
                                   normalize=True, self_idx=jnp.arange(150, dtype=jnp.int32))
    _weights_close(Wt, Wj)
    with pytest.raises(ValueError, match="Unsupported"):
        tfn._kernel_weights_batch(c, c, 5.0, function="cosine")


def test_adaptive_bandwidth_past_the_last_neighbour_is_nan():
    """An adaptive bandwidth past a row's last entry is NaN, as the JAX
    package's `take_along_axis` fills it, and so are the weights."""
    c = np.random.default_rng(16).random((5, 2)).astype(np.float32)
    Wt = tfn._kernel_weights_batch(torch.from_numpy(c), torch.from_numpy(c), 7, fixed=False)
    Wj = jfn._kernel_weights_batch(jnp.asarray(c), jnp.asarray(c), jnp.asarray(7), fixed=False)
    assert bool(torch.isnan(Wt).all()) and bool(np.isnan(np.asarray(Wj)).all())


def test_host_kernel_and_get_wi_match_the_batch():
    """The copied per-sample numpy path agrees with the batched rows."""
    coords = np.random.default_rng(11).uniform(0, 100, (200, 2))
    Wb = tfn.get_wi_batch(coords, 12, fixed_bw=False, exclude_self=True, kernel="bisquare", device="cpu")
    for i in (0, 77, 199):
        wi = tfn.get_wi(i, 200, coords, fixed_bw=False, exclude_self=True, kernel="bisquare", bw=12).toarray().ravel()
        assert np.abs(wi - Wb[i]).max() <= WEIGHT_ATOL
    assert np.allclose(tfn.calculate_distance(coords[:5])[0], tfn.local_dist(coords[0], coords[:5]))


# ---------------------------------------------------------------------------
# Moran's I
# ---------------------------------------------------------------------------
def _moran_adata(n=300, G=8, seed=12):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    X = rng.poisson(np.exp(np.sin(coords[:, :1] / 10.0 * np.arange(1, G + 1)[None, :] / 3))).astype(np.float32)
    a = st.AnnData(X=X, obs=pd.DataFrame(index=[f"c{i}" for i in range(n)]),
                   var=pd.DataFrame(index=[f"g{j}" for j in range(G)]))
    a.obsm["spatial"] = coords
    return a


@pytest.mark.parametrize("weighted", [False, True])
def test_moran_i_matches_jax(weighted, monkeypatch):
    """I, z and q within 1e-5 (z: of scale); p-values equal except where a
    permuted I lies within 1e-5 of the observed one. The permutations are
    taken in chunks of 7 here (the replicates are independent)."""
    a = _moran_adata()
    monkeypatch.setattr(tsd, "PERM_CHUNK_ELEMS", 7 * 300 * 8)
    rj = jsd.moran_i(a, weighted=weighted, permutations=99, seed=4)
    rt = tsd.moran_i(adata_from_reference(a), weighted=weighted, permutations=99, seed=4, device="cpu")
    assert list(rt.index) == list(rj.index) and list(rt.columns) == list(rj.columns)
    assert np.abs(rt["moran_i"].values - rj["moran_i"].values).max() <= 1e-5
    assert _scaled(rt["moran_z"].values, rj["moran_z"].values) <= 1e-4
    differ = rt["moran_p_val"].values != rj["moran_p_val"].values
    if differ.any():
        rng = np.random.default_rng(4)
        perm = torch.from_numpy(np.stack([rng.permutation(300) for _ in range(99)]))
        X = np.asarray(a.X, np.float32)
        Z = torch.from_numpy(X - X.mean(0, keepdims=True))
        Wm = torch.from_numpy(tsd._spatial_weights(np.asarray(a.obsm["spatial"], float), 5, weighted).astype(np.float32))
        I_obs, I_perm = tsd._moran_replicates(Z, Wm, perm)
        gap = (I_perm[:, differ] - I_obs[differ][None, :]).abs().min(0).values
        assert bool((gap <= 1e-5).all())


@pytest.mark.parametrize("weighted", [False, True])
def test_moran_weights_match_the_jax_neighbours(weighted):
    """The KNN weights from scipy's cKDTree equal the JAX package's from
    scikit-learn's `NearestNeighbors` on distinct points."""
    coords = np.random.default_rng(15).uniform(0, 100, (200, 2))
    assert np.allclose(tsd._spatial_weights(coords, 5, weighted), jsd._spatial_weights(coords, 5, weighted),
                       rtol=1e-12, atol=0)


def test_moran_i_gene_subset():
    a = _moran_adata(n=120, G=5)
    genes = ["g1", "g3"]
    rj = jsd.moran_i(a, genes=genes, permutations=19, seed=0)
    rt = tsd.moran_i(adata_from_reference(a), genes=genes, permutations=19, seed=0, device="cpu")
    assert list(rt.index) == genes
    assert np.abs(rt["moran_i"].values - rj["moran_i"].values).max() <= 1e-5


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["Gaussian", "Poisson", "NegativeBinomial"])
def test_distributions_copy_matches(family):
    rng = np.random.default_rng(13)
    y = rng.poisson(2.0, 50).astype(float)
    mu = rng.uniform(0.5, 4.0, 50)
    fj, ft = getattr(jdist, family)(), getattr(tdist, family)()
    for name in ("deviance", "log_likelihood"):
        assert getattr(ft, name)(y, mu) == getattr(fj, name)(y, mu)
    assert np.array_equal(ft.weights(mu), fj.weights(mu)) and np.array_equal(ft.predict(np.log(mu)), fj.predict(np.log(mu)))


def test_multiple_testing_copies_match():
    from spateo_tpu.svg.utils import multipletests_bh as jbh
    from spateo_tpu_torch.svg.utils import multipletests_bh as tbh

    p = np.random.default_rng(14).random(40)
    assert np.array_equal(tbh(p), jbh(p))
    assert np.array_equal(tru.multitesting_correction(p, "bonferroni"), jru.multitesting_correction(p, "bonferroni"))
    assert np.array_equal(tru.wald_test(p, p + 0.5), jru.wald_test(p, p + 0.5))


def test_define_spateo_argparse_copy_matches():
    kw = dict(mod_type="lr", custom_ligands=["TGFB1"], bw_fixed=True, bw=8.0, distr="poisson")
    pj, lj = st.tl.define_spateo_argparse(**kw)
    pt, lt = stt.tl.define_spateo_argparse(**kw)
    assert lt == lj and vars(pt.parse_args(lt)) == vars(pj.parse_args(lj))


# ---------------------------------------------------------------------------
# MuSIC
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lr_adata():
    """tests/test_music_fidelity.py's `lr_adata`: a secreted (TGFB1) and a
    membrane-bound (DLL1) ligand, receivers near the senders express TGT1."""
    rng = np.random.default_rng(11)
    n = 250
    pts = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    genes = ["TGFB1", "TGFBR1", "TGFBR2", "DLL1", "NOTCH1", "TGT1"]
    X = rng.poisson(0.2, (n, len(genes))).astype(np.float32)
    senders = pts[:, 0] < 50
    X[senders, 0] += rng.poisson(5.0, senders.sum())
    X[senders, 3] += rng.poisson(4.0, senders.sum())
    X[~senders, 1] += rng.poisson(3.0, (~senders).sum())
    X[~senders, 2] += rng.poisson(3.0, (~senders).sum())
    X[~senders, 4] += rng.poisson(3.0, (~senders).sum())
    near = ~senders & (pts[:, 0] < 65)
    X[near, 5] += rng.poisson(6.0, near.sum())
    adata = st.AnnData(
        X=X,
        obs=pd.DataFrame({"cell_type": np.where(senders, "sender", "receiver")}, index=[f"c{i}" for i in range(n)]),
        var=pd.DataFrame(index=genes),
    )
    adata.obsm["spatial"] = pts
    st.SKM.init_adata_type(adata, "UMI")
    return adata


MODELS = {
    "niche": dict(mod_type="niche", custom_targets=["TGT1"], bw_fixed=True, bw=12.0),
    "ligand": dict(mod_type="ligand", custom_ligands=["TGFB1", "DLL1"], custom_targets=["TGT1"],
                   n_neighbors_membrane_bound=4, n_neighbors_secreted=20, bw_fixed=True, bw=8.0),
    "receptor": dict(mod_type="receptor", custom_receptors=["TGFBR1", "TGFBR2", "NOTCH1"], custom_targets=["TGT1"],
                     bw_fixed=True, bw=10.0),
    "lr": dict(mod_type="lr", custom_ligands=["TGFB1", "DLL1"], custom_receptors=["TGFBR1", "TGFBR2", "NOTCH1"],
               custom_targets=["TGT1"], bw_fixed=True, bw=10.0),
}


def _pair(lr_adata, tmp, distr="gaussian", **kw):
    """A JAX package `MuSIC` and the port's, configured alike (the port on
    the CPU), each with its own copy of the data and its own output dir."""
    kw = dict(species="human", fit_intercept=True, distr=distr, **kw)
    pj, lj = st.tl.define_spateo_argparse(output_path=f"{tmp}/jax/out.csv", **kw)
    mj = st.tl.MuSIC(pj, lj)
    mj.adata = lr_adata.copy()
    pt, lt = stt.tl.define_spateo_argparse(output_path=f"{tmp}/port/out.csv", **kw)
    mt = stt.tl.MuSIC(pt, lt, device="cpu")
    mt.adata = adata_from_reference(lr_adata)
    return mj, mt


def _share_weights(tmp):
    """Give the port the JAX package's saved spatial weights (`define_sig_inputs`
    loads them from its output dir when their shape matches)."""
    import shutil

    src = f"{tmp}/jax/out/spatial_weights"
    if os.path.isdir(src):
        shutil.copytree(src, f"{tmp}/port/out/spatial_weights")


@pytest.mark.parametrize("mod_type", list(MODELS))
def test_define_sig_inputs_matches_jax(lr_adata, mod_type):
    """The same feature names, targets and X (to 1e-5) for each model type,
    given the same spatial weights."""
    with tempfile.TemporaryDirectory() as tmp:
        mj, mt = _pair(lr_adata, tmp, **MODELS[mod_type])
        mj.load_and_process()
        mj.define_sig_inputs()
        _share_weights(tmp)
        mt.load_and_process()
        mt.define_sig_inputs()
        assert mt.feature_names == mj.feature_names and mt.targets == mj.targets
        assert np.abs(mt.X - mj.X).max() <= 1e-5
        assert mt.targets_expr.equals(mj.targets_expr)
        assert os.path.exists(f"{tmp}/port/out/design_matrix/design_matrix.csv")


def test_spatial_weights_and_lag_match_jax(lr_adata):
    """Computed by each package (not shared): the membrane-bound and secreted
    weights within the weight bars, and the lagged ligands with them."""
    with tempfile.TemporaryDirectory() as tmp:
        mj, mt = _pair(lr_adata, tmp, **MODELS["ligand"])
        for m in (mj, mt):
            m.load_and_process()
            m.define_sig_inputs()
        for key in ("spatial_weights_membrane_bound", "spatial_weights_secreted"):
            _weights_close(getattr(mt, key).toarray(), getattr(mj, key).toarray())
        assert _scaled(mt.ligands_expr.values, mj.ligands_expr.values) <= 1e-4


def _fit_both(lr_adata, tmp, distr, bw=10.0, **kw):
    mj, mt = _pair(lr_adata, tmp, distr=distr, **dict(MODELS["lr"], bw=bw, **kw))
    mj.fit(verbose=False)
    mt.adata = adata_from_reference(mj.adata)
    mt.load_state(music_state_from_reference(mj))
    mt.fit(verbose=False)
    return mj, mt


@pytest.mark.parametrize("distr", ["gaussian", "poisson"])
def test_fit_and_predict_match_jax(lr_adata, distr):
    """A whole `fit` at a fixed bandwidth from the same design: coefficients
    and standard errors within `FIT_TOL` of scale (the conditioned weights'
    rounding sets the gap; see `FIT_TOL`), the same AICc to 1e-6 relative,
    `predict` within `FIT_TOL`, the same saved columns."""
    with tempfile.TemporaryDirectory() as tmp:
        mj, mt = _fit_both(lr_adata, tmp, distr)
        cj, ct = mj.coeffs["TGT1"], mt.coeffs["TGT1"]
        assert list(ct.columns) == list(cj.columns) and list(ct.index) == list(cj.index)
        gap = _scaled(ct.values, cj.values)
        se_gap = _scaled(mt.standard_errors["TGT1"].values, mj.standard_errors["TGT1"].values)
        print(f"{distr}: coefficients {gap:.3g}, standard errors {se_gap:.3g} of scale")
        assert gap <= FIT_TOL and se_gap <= FIT_TOL
        assert abs(mt.aiccs["TGT1"] - mj.aiccs["TGT1"]) <= 1e-6 * abs(mj.aiccs["TGT1"])
        assert _scaled(mt.predict()["TGT1"].values, mj.predict()["TGT1"].values) <= FIT_TOL
        sj, stt_ = pd.read_csv(f"{tmp}/jax/out_TGT1.csv"), pd.read_csv(f"{tmp}/port/out_TGT1.csv")
        assert list(stt_.columns) == list(sj.columns)
        oj, _ = mj.return_outputs(adjust_for_subsampling=False)
        ot, _ = mt.return_outputs(adjust_for_subsampling=False)
        assert _scaled(ot["TGT1"].values, oj["TGT1"].values) <= FIT_TOL


@pytest.mark.parametrize("distr", ["gaussian", "poisson"])
def test_bandwidth_search_chooses_the_jax_bandwidth(lr_adata, distr):
    """`fit(bw=None)` with adaptive weights: the golden-section search picks
    the JAX package's bandwidth (candidates are rounded to whole neighbour
    counts, and the AICc of neighbouring counts differ by far more than the
    packages' rounding)."""
    with tempfile.TemporaryDirectory() as tmp:
        mj, mt = _fit_both(lr_adata, tmp, distr, bw=None, bw_fixed=False, n_neighbors_membrane_bound=4,
                           n_neighbors_secreted=12)
        assert mt.bws == mj.bws
        assert _scaled(mt.coeffs["TGT1"].values, mj.coeffs["TGT1"].values) <= FIT_TOL


@pytest.mark.parametrize("bw_fixed", [True, False])
def test_find_optimal_bw_takes_the_same_steps(bw_fixed):
    """The golden-section search on a deterministic host score: the same
    candidates in the same order, the same answer, in both packages; also a
    score that is NaN everywhere (three NaN rounds end the search)."""
    def model(pkg):
        m = pkg.tl.MuSIC(bw_fixed=bw_fixed, **({"device": "cpu"} if pkg is stt else {}))
        return m

    for score in (lambda b: (b - 17.3) ** 2 + 0.01 * np.sin(3 * b), lambda b: float("nan")):
        calls = {}
        res = {}
        for pkg in (st, stt):
            seen = []
            res[pkg.__name__] = model(pkg).find_optimal_bw(4.0, 50.0, lambda b: seen.append(b) or score(b))
            calls[pkg.__name__] = seen
        assert calls["spateo_tpu_torch"] == calls["spateo_tpu"] and len(calls["spateo_tpu"]) > 2
        assert res["spateo_tpu_torch"] == res["spateo_tpu"] or (res["spateo_tpu"] is None
                                                                and res["spateo_tpu_torch"] is None)


def test_mpi_fit_padding_never_reaches_the_outputs(lr_adata):
    """`mpi_fit` pads the queries to 256 rows with repeats of the first;
    the outputs are the unpadded rows' own fits."""
    with tempfile.TemporaryDirectory() as tmp:
        _, mt = _pair(lr_adata, tmp, **MODELS["lr"])
        mt._set_up_model(verbose=False)
        y = mt.targets_expr["TGT1"].values.astype(float)
        chunk = np.arange(3, 250, 2)  # 124 queries, padded to 256
        mt.x_chunk = chunk
        assert len(mt._padded_chunk(chunk)) == 256 and (mt._padded_chunk(chunk)[124:] == 3).all()
        betas = mt.mpi_fit(y, mt.X, y_label="TGT1", bw=10.0, final=True)
        assert betas.shape == (124, mt.X.shape[1])
        mt.ct_vec = None
        W = mt._conditioned_weights(y, 10.0, chunk)
        direct = tru.iwls_batch_full(y, mt.X, W, focal=chunk, distr="gaussian", ridge_lambda=mt.ridge_lambda,
                                     clip=mt.clip, device="cpu")[0]
        assert np.abs(betas - direct).max() <= 1e-5 * np.abs(direct).max()
        saved = pd.read_csv(f"{tmp}/port/out_TGT1.csv")
        assert saved["index"].astype(int).tolist() == chunk.tolist()


def test_mask_indices_zero_the_weights_on_the_device(lr_adata):
    with tempfile.TemporaryDirectory() as tmp:
        _, mt = _pair(lr_adata, tmp, **MODELS["lr"])
        mt._set_up_model(verbose=False)
        y = mt.targets_expr["TGT1"].values.astype(float)
        W = mt._masked_weights(y, 10.0, np.arange(20), np.array([0, 5, 200]))
        assert isinstance(W, torch.Tensor) and float(W[:, [0, 5, 200]].abs().max()) == 0.0
        b = mt.local_fit(7, y, mt.X, bw=10.0, final=True, mask_indices=np.array([0, 5, 200]))
        assert b.shape == (mt.X.shape[1],) and np.isfinite(b).all()


def test_log_transform_and_subsample_match_jax(lr_adata):
    """`log_transform=True` (the copied log1p) and the spatially stratified
    subsample (the same KMeans strata and draws): the same chunks, mappings
    and fitted cells."""
    with tempfile.TemporaryDirectory() as tmp:
        mj, mt = _pair(lr_adata, tmp, **dict(MODELS["lr"], log_transform=True, spatial_subsample=True))
        mj.fit(verbose=False)
        _share_weights(tmp)
        mt.fit(verbose=False)
        assert mt.subsampled_indices == mj.subsampled_indices
        assert mt.neighboring_unsampled == mj.neighboring_unsampled
        assert list(mt.coeffs["TGT1"].index) == list(mj.coeffs["TGT1"].index)
        assert np.abs(mt.X - mj.X).max() <= 1e-5


@pytest.mark.parametrize("option", ["normalize"])
def test_unported_options_raise(lr_adata, option):
    """The last option that raised, `normalize=True`, is ported: it no
    longer raises, and `normalize_total` (copied host code) leaves the JAX
    package's X, bit for bit; the fit on it matches too."""
    with tempfile.TemporaryDirectory() as tmp:
        mj, mt = _pair(lr_adata, tmp, **dict(MODELS["lr"], **{option: True}))
        for m in (mj, mt):
            m.load_and_process()
        np.testing.assert_array_equal(np.asarray(mt.adata.X), np.asarray(mj.adata.X))
        mj.fit(verbose=False)
        _share_weights(tmp)
        mt.fit(verbose=False)
        np.testing.assert_allclose(mt.coeffs["TGT1"].values, mj.coeffs["TGT1"].values, rtol=0,
                                   atol=1e-4 * np.abs(mj.coeffs["TGT1"].values).max())


def test_smooth_option_matches_jax(lr_adata):
    """`smooth=True` smooths the expression over each cell's 8 nearest cells
    (`svg.get_svg.smooth`) before the log transform: the same X as the JAX
    package's on the fixture's uniform random coordinates (no tied
    neighbours)."""
    with tempfile.TemporaryDirectory() as tmp:
        mj, mt = _pair(lr_adata, tmp, **dict(MODELS["lr"], smooth=True))
        for m in (mj, mt):
            m.load_and_process()
        np.testing.assert_allclose(np.asarray(mt.adata.X), np.asarray(mj.adata.X), rtol=1e-6, atol=1e-6)


def test_molecule_selection_by_moran_matches_jax(lr_adata):
    """No custom ligands: `_select_molecules` falls back to the Moran's I
    ranking (MuSIC.py:287-297) in both packages and picks the same ones."""
    with tempfile.TemporaryDirectory() as tmp:
        mj, mt = _pair(lr_adata, tmp, mod_type="ligand", custom_targets=["TGT1"])
        for m in (mj, mt):
            m.load_and_process()
            m._load_db()
        assert mt._select_molecules("ligand") == mj._select_molecules("ligand")


def test_music_state_bridge(lr_adata):
    """`music_state_from_reference` carries the design, targets, chunks and
    weights as copies; `load_state` sets the model up."""
    with tempfile.TemporaryDirectory() as tmp:
        mj, mt = _pair(lr_adata, tmp, **MODELS["ligand"])
        mj.load_and_process()
        mj.define_sig_inputs()
        state = music_state_from_reference(mj)
        assert np.array_equal(state["X"], mj.X) and state["X"] is not mj.X
        assert state["feature_names"] == mj.feature_names
        assert (state["spatial_weights_secreted"] != mj.spatial_weights_secreted).nnz == 0
        mt.load_state(state)
        assert mt.set_up and mt.n_features == mj.n_features and mt.X_df.shape == mj.X_df.shape
        assert list(mt.sample_names) == list(map(str, mj.sample_names))


def test_mpi_fit_runs_no_jax_and_no_reference_package():
    """A whole `MuSIC.fit` (`lr` model, bandwidth search) in a fresh
    interpreter loads no JAX module and no `spateo_tpu` module."""
    code = (
        "import sys, tempfile, numpy as np, pandas as pd; import spateo_tpu_torch as stt\n"
        "rng = np.random.default_rng(0); n = 150\n"
        "X = rng.poisson(1.0, (n, 6)).astype(np.float32); X[:75, 0] += 4; X[75:, 1:3] += 3; X[75:100, 5] += 5\n"
        "a = stt.AnnData(X=X, obs=pd.DataFrame({'cell_type': ['s'] * 75 + ['r'] * 75}, index=[f'c{i}' for i in range(n)]),"
        " var=pd.DataFrame(index=['TGFB1', 'TGFBR1', 'TGFBR2', 'DLL1', 'NOTCH1', 'TGT1']))\n"
        "a.obsm['spatial'] = np.c_[np.r_[rng.uniform(0, 50, 75), rng.uniform(50, 100, 75)], rng.uniform(0, 100, n)]\n"
        "tmp = tempfile.mkdtemp()\n"
        "m = stt.tl.MuSIC(adata=a, mod_type='lr', custom_ligands=['TGFB1'], custom_receptors=['TGFBR1', 'TGFBR2'],"
        " custom_targets=['TGT1'], output_path=tmp + '/o.csv', n_neighbors_membrane_bound=4, n_neighbors_secreted=12,"
        " device='cpu').fit(verbose=False)\n"
        "assert 'TGT1' in m.coeffs and m.predict().shape == (n, 1)\n"
        "bad = [k for k in sys.modules if k in ('jax', 'spateo_tpu') or k.startswith(('jax.', 'jaxlib', 'spateo_tpu.'))]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_music_slice_fit_recovers_the_planted_pairs():
    """`chip_smoke.music_fit` on `chip_smoke.music_slice` at 1,200 cells on
    the CPU (phase 14b's path at a small size): every target's driving pair
    has a positive mean coefficient on the receivers its effect lies on."""
    sys.path.insert(0, REPO)
    import chip_smoke

    adata, effect = chip_smoke.music_slice(1200, seed=1)
    with tempfile.TemporaryDirectory() as tmp:
        model, coeffs, bws, seconds, _, calls = chip_smoke.music_fit(adata, tmp, device="cpu")
    assert set(coeffs) == {"TGT1", "TGT2", "TGT3"} and calls >= 5
    assert bws["TGT1"] == 20 and all(8 <= bws[t] <= 50 for t in ("TGT2", "TGT3"))
    chip_smoke.check_music_effects(coeffs, effect, "cpu")
