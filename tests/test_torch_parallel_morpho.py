"""Sharded Morpho (`align.morpho_align(mesh=)`, `Morpho_pairwise(mesh=)`,
and the E-step with the moving slice's rows split over ranks) held against
the unsharded port and the JAX package on the CPU.

The port's ranks are gloo groups of 4 and of 3 ranks on the CPU
(`_torch_ranks.run_groups`; 256 cells make blocks of 64 and of 86, 85, 85),
every rank returning the same bits.

Bars:

- `morpho_align(mesh=)` on the JAX package's own mesh test's pair
  (`tests/test_alignment.py:114-136`: 256 cells, 40 iterations): the
  moving slice's coordinates within 1e-4 of the unsharded port's, and
  within `COORD_TOL` = 2e-3 of `spateo_tpu`'s unsharded `morpho_align` (the
  bar of the port's unsharded test, `tests/test_torch_align.py`); the
  assignment within 1e-4 of the unsharded port's.
- The E-step of a Morton-ordered 1,600 x 600 case (`tests/test_ops.py:346`'s
  shape), each route sharded: every reduction within 1e-5 of its scale of
  the unsharded port's `estep_reference`, and within 5e-4 of the JAX
  package's dense `estep_reduced` (the JAX package's own bar between its
  E-step routes, `tests/test_ops.py:297`).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

import spateo_tpu as st
import spateo_tpu_torch as stt
from _torch_ranks import run_groups, same_bits
from spateo_tpu.alignment.methods import math as jm
from spateo_tpu_torch.alignment.methods import math as tm
from spateo_tpu_torch.alignment.methods import morpho as tmorpho
from spateo_tpu_torch.ops import estep_cuda as ec

WORLDS = (4, 3)
COORD_TOL = 2e-3
KW = dict(max_iter=40)
SHIFT = 0.4
ROUTES = ("kernel", "dense", "chunked")
ESTEP_KEYS = ("K_NA", "K_NA_spatial", "K_NA_sigma2", "K_NB", "Sp", "sigma2_related", "PXB", "M1")


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


def _estep_case():
    """Morton-ordered 1,600 x 600 rows, G = 12, sigma2 = 2e-4, with the
    expression distances factorised by the port."""
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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pts, X = _pair()
    case = _estep_case()
    jobs = [("morpho", dict(pts=pts, X=X, shift=SHIFT, kw=KW))] + [("estep", dict(args=case, route=r)) for r in ROUTES]
    out = run_groups({w: jobs for w in WORLDS}, tmp_path_factory.mktemp("morpho"))
    names = ("morpho",) + ROUTES
    return {w: {n: [r[i] for r in per_rank] for i, n in enumerate(names)} for w, per_rank in out.items()}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("job", ("morpho",) + ROUTES)
def test_every_rank_returns_the_same_bits(ranks, world, job):
    assert same_bits(ranks[world][job])


@pytest.fixture(scope="module")
def unsharded():
    pts, X = _pair()
    mt, pis = stt.align.morpho_align([_slice(stt, pts, X), _slice(stt, pts + SHIFT, X)], verbose=False,
                                     device="cpu", **KW)
    mj, _ = st.align.morpho_align([_slice(st, pts, X), _slice(st, pts + SHIFT, X)], verbose=False, **KW)
    return mt[1], pis[0].numpy(), mj[1]


@pytest.mark.parametrize("world", WORLDS)
def test_morpho_align_mesh_matches_unsharded_port_and_jax(ranks, unsharded, world):
    mt, Pt, mj = unsharded
    r = ranks[world]["morpho"][0]
    np.testing.assert_allclose(r["align"], mt.obsm["align_spatial"], atol=1e-4)
    np.testing.assert_allclose(r["nonrigid"], mt.obsm["align_spatial_nonrigid"], atol=1e-4)
    np.testing.assert_allclose(r["P"], Pt, atol=1e-4)
    v = mt.uns["VecFld_morpho"]
    for k in ("R", "optimal_R", "t", "Coff"):
        np.testing.assert_allclose(r[k], v[k], atol=1e-4)
    np.testing.assert_allclose(r["sigma2"], v["sigma2"], rtol=1e-4)
    np.testing.assert_allclose(r["align"], np.asarray(mj.obsm["align_spatial"]), atol=COORD_TOL)
    np.testing.assert_allclose(r["nonrigid"], np.asarray(mj.obsm["align_spatial_nonrigid"]), atol=COORD_TOL)


def _scaled_err(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return float(np.max(np.abs(ref - out)) / (np.max(np.abs(ref)) + 1e-30))


@pytest.fixture(scope="module")
def estep_refs():
    c = _estep_case()
    T = {k: torch.as_tensor(v) for k, v in c.items()}
    port = ec.estep_reference(T["XAHat"], T["coordsA"], T["coordsB"], T["a_rows"], T["b_cols"], T["A_feats"],
                              T["B_feats"], T["model_mul_vec"], T["sigma2"], T["gamma"], T["samples_s"],
                              T["sigma2_variance"], T["p"])
    J = {k: jnp.asarray(v) for k, v in c.items()}
    jax_dense = jm.estep_reduced(2.0, J["XAHat"], J["coordsA"], J["coordsB"], (J["a_rows"],), (J["b_cols"],),
                                 (J["A_feats"],), (J["B_feats"],), J["sigma2"], J["model_mul_vec"], J["gamma"],
                                 J["samples_s"], J["sigma2_variance"], ["gauss"], [J["p"]], n_chunks=1)
    return {k: v.numpy() for k, v in port.items()}, {k: np.asarray(v) for k, v in jax_dense.items()}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("route", ROUTES)
def test_sharded_estep_matches_unsharded(ranks, estep_refs, world, route):
    port, jax_dense = estep_refs
    out = ranks[world][route][0]
    assert set(out) == set(ESTEP_KEYS)
    for k in ESTEP_KEYS:
        assert out[k].shape == port[k].shape, k
        assert _scaled_err(port[k], out[k]) < 1e-5, (k, _scaled_err(port[k], out[k]))
        assert _scaled_err(jax_dense[k], out[k]) < 5e-4, k


def test_morpho_pairwise_refuses_a_foreign_mesh_or_device():
    """A mesh that is not a `DeviceMesh` raises, and so does a `device` of
    another type than a real mesh's (the one-rank mesh starts here)."""
    pts, X = _pair()
    a = _slice(stt, pts[:30], X[:30])
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmorpho.Morpho_pairwise(a, a, device="cpu", mesh=object())
    try:
        mesh = stt.parallel.create_mesh(device="cpu")
        with pytest.raises(ValueError, match="mesh sets where the ranks run"):
            tmorpho.Morpho_pairwise(a, a, device="cuda", mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
