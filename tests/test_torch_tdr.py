"""The port's 3D reconstruction (`stt.tdr`: point clouds, surfaces, voxels,
backbones, the migration models, model IO and utilities, morphology, kernel
density and shape similarity) against the JAX package on the CPU.

Bars:

- Host code the port copies (`construct_pc`, the alpha shape and its
  smoothing, marching tetrahedra, `voxelize_pc`, `voxelize_mesh`, normals,
  ball pivoting, the model utilities, `save_model`/`read_model`, the
  morphopath models, `model_morphology`, shape similarity, the backbone
  utilities): equal.
- `_splat_and_solve` at res 16 and 24: rho to 1e-6 of its scale (measured
  3.2e-7), chi to 2e-5 of its scale (measured 5.0e-6). The port sums the
  splat exactly (int64 fixed point) and rounds once, where XLA adds in
  float32; the splat is the float64 sum of the same addends rounded once to
  float32, up to the fixed point's quantum. The JAX package does not expose its CG iteration count, so
  the port's is held to a float64 numpy transcription of the same
  recurrence on the port's system: within 1 (measured 0 on every case).
- `poisson_reconstruction` of a unit sphere: equal face counts, and the
  meshes within a symmetric Chamfer distance of 1e-6 (measured 3.5e-7, a
  cell is 0.076), the vertex densities at the nearest vertex to 1e-4
  relative (measured 6.8e-5, at 22 of 9,368 vertices that rho's rounding
  moved).
- The batched `_optimize_elastic` against the JAX package's serial one, each
  candidate: nodes to 1e-10, energy to 1e-12 relative.
- `ElPiGraph_tree` (tree on tests/test_tdr.py's Y cloud, curve and circle on
  its circle cloud): edges equal, nodes to 1e-10 (measured 4.4e-16). On the
  Y cloud in circle topology, symmetric candidates tie within 2 ulp and the
  two packages keep different ones (pinned by
  `test_elpigraph_tie_within_rounding`).
- SimplePPT (float32, as in JAX): edges equal, nodes to 1e-5 of scale
  (measured 3.0e-7).
- NLPCA: `_forward` and `project` on weights carried over by
  `core.bridge.nlpca_from_reference` to 1e-6; after 20 full-batch Adam
  steps from the same draws the weights to 1e-5 (torch and optax Adam round
  differently; measured 1.3e-6), and `PrinCurve`'s nodes after 20 epochs to
  1e-4 of scale.
- `pc_KDE` against scikit-learn's `KernelDensity`, all six kernels: 1e-10
  relative (measured 4e-13).
- `construct_field_streams` (float32 field evaluations): points to 1e-5 of
  scale.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.tdr.models import mesh_core as jmc
from spateo_tpu.tdr.models.models_backbone import backbone_methods as JB
from spateo_tpu.tdr.models.models_individual import reconstruction as JR
from spateo_tpu.tdr.models.models_individual import voxel as JV
from spateo_tpu.tdr.models.models_individual.mesh import _alpha_shape_3d as j_alpha, _smooth_mesh as j_smooth
from spateo_tpu_torch.core.bridge import nlpca_from_reference
from spateo_tpu_torch.tdr.models.models_backbone import backbone_methods as TB
from spateo_tpu_torch.tdr.models.models_individual import reconstruction as TR
from spateo_tpu_torch.tdr.models.models_individual import voxel as TV
from spateo_tpu_torch.tdr.models.models_individual.mesh import _alpha_shape_3d as t_alpha, _smooth_mesh as t_smooth

RHO_TOL, CHI_TOL = 1e-6, 2e-5
NODE_TOL = 1e-10
PPT_TOL = 1e-5
NLPCA_FWD_TOL, NLPCA_TRAIN_TOL, PRINCURVE_TOL = 1e-6, 1e-5, 1e-4
KDE_TOL = 1e-10
STREAM_TOL = 1e-5


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


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _ellipsoid(n, seed=0, axes=(1.0, 0.5, 1.6)):
    p = np.random.default_rng(seed).normal(size=(n, 3))
    return p / np.linalg.norm(p, axis=1, keepdims=True) * np.asarray(axes)


def _y_cloud():
    """tests/test_tdr.py's Y-shaped cloud (test_elpigraph_tree_branches)."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 150)
    trunk = np.c_[np.zeros_like(t), t, np.zeros_like(t)]
    left = np.c_[-t, 1 + t, np.zeros_like(t)]
    right = np.c_[t, 1 + t, np.zeros_like(t)]
    return np.vstack([trunk, left, right]) + rng.normal(0, 0.02, (450, 3))


def _circle_cloud():
    """tests/test_tdr.py's noisy circle (test_elpigraph_curve_topology)."""
    rng = np.random.default_rng(1)
    t = np.linspace(0, 2 * np.pi, 300)
    return np.c_[np.cos(t), np.sin(t)] * (1 + rng.normal(0, 0.02, (300, 1)))


def _same_model(a, b):
    assert type(a).__name__ == type(b).__name__
    np.testing.assert_array_equal(a.points, b.points)
    for attr in ("faces", "lines", "edges"):
        assert hasattr(a, attr) == hasattr(b, attr)
        if hasattr(a, attr):
            np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
    assert set(a.point_data) == set(b.point_data)
    for k in a.point_data:
        np.testing.assert_array_equal(np.asarray(a.point_data[k]), np.asarray(b.point_data[k]))


def _adatas(n=300, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (n, 3))
    groups = rng.choice(["a", "b", "c"], n)
    out = []
    for pkg in (st, stt):
        a = pkg.AnnData(X=np.ones((n, 2), np.float32), obs=pd.DataFrame({"cluster": groups},
                                                                        index=[f"c{i}" for i in range(n)]))
        a.obsm["spatial"] = coords.copy()
        out.append(a)
    return out


# -- point clouds, surfaces, voxels ---------------------------------------------------------------


@pytest.mark.parametrize("mask", [None, "b"])
def test_construct_pc_equals_jax(mask):
    aj, at = _adatas()
    pj, _ = st.tdr.construct_pc(aj, groupby="cluster", mask=mask)
    pt, _ = stt.tdr.construct_pc(at, groupby="cluster", mask=mask)
    _same_model(pt, pj)


@pytest.mark.parametrize("alpha,n_iter", [(None, 10), (0.4, 3)])
def test_alpha_shape_and_smoothing_equal_jax(alpha, n_iter):
    p = _ellipsoid(600, seed=1)
    mj, mt = j_alpha(p, alpha=alpha), t_alpha(p, alpha=alpha)
    _same_model(mt, mj)
    _same_model(t_smooth(mt, n_iter=n_iter), j_smooth(mj, n_iter=n_iter))


@pytest.mark.parametrize("cs_method,cs_args", [("alpha_shape", {}), ("marching_cube", {"resolution": 16}),
                                               ("pyvista", {"alpha": 0.5})])
def test_construct_surface_host_methods_equal_jax(cs_method, cs_args):
    p = _ellipsoid(500, seed=2)
    mj, cj, _ = st.tdr.construct_surface(jmc.PointCloud(p), cs_method=cs_method, cs_args=cs_args, smooth=2)
    mt, ct, _ = stt.tdr.construct_surface(stt.tdr.PointCloud(p), cs_method=cs_method, cs_args=cs_args, smooth=2,
                                          device="cpu")
    _same_model(mt, mj)
    _same_model(ct, cj)


def test_marching_tetrahedra_and_marching_cubes_equal_jax():
    g = np.linspace(-1, 1, 14)
    field = np.sqrt(sum(a**2 for a in np.meshgrid(g, g * 1.3, g * 0.8, indexing="ij")))
    _same_model(TV._marching_tetrahedra(field, 0.7, np.zeros(3), 0.1),
                JV._marching_tetrahedra(field, 0.7, np.zeros(3), 0.1))
    p = _ellipsoid(400, seed=3)
    _same_model(TV.marching_cubes_mesh(p, resolution=12), JV.marching_cubes_mesh(p, resolution=12))
    # the JAX package's `marching_cube_mesh` passes `levelset` on and raises;
    # the port's takes the model's points and the default iso
    from spateo_tpu_torch.tdr.models.models_individual.mesh_methods import marching_cube_mesh

    _same_model(marching_cube_mesh(stt.tdr.PointCloud(p), resolution=12), JV.marching_cubes_mesh(p, resolution=12))


def test_construct_cells_equal_jax():
    p = _ellipsoid(20, seed=4)
    sizes = np.random.default_rng(4).uniform(0.5, 1.5, 20)
    for geometry in ("cube", "sphere"):
        _same_model(stt.tdr.construct_cells(stt.tdr.PointCloud(p), sizes, geometry=geometry),
                    st.tdr.construct_cells(jmc.PointCloud(p), sizes, geometry=geometry))


@pytest.mark.parametrize("voxel_size", [None, np.array([0.2, 0.2, 0.3])])
def test_voxelize_pc_equals_jax(voxel_size):
    p = _ellipsoid(800, seed=5)
    _same_model(stt.tdr.voxelize_pc(stt.tdr.PointCloud(p), voxel_size=voxel_size),
                st.tdr.voxelize_pc(jmc.PointCloud(p), voxel_size=voxel_size))


@pytest.mark.parametrize("with_labels", [False, True])
def test_voxelize_mesh_equals_jax(with_labels):
    p = _ellipsoid(300, seed=6)
    mj, mt = j_alpha(p), t_alpha(p)
    vj = vt = None
    if with_labels:
        lab = np.where(p[:, 2] > 0, "top", "bottom")
        vj, vt = jmc.PointCloud(p, {"groups": lab}), stt.tdr.PointCloud(p, {"groups": lab})
    oj, cj = st.tdr.voxelize_mesh(mj, voxel_pc=vj, smooth=20)
    ot, ct = stt.tdr.voxelize_mesh(mt, voxel_pc=vt, smooth=20)
    _same_model(ot, oj)
    assert ct == cj


def test_normals_and_ball_pivoting_equal_jax():
    p = _ellipsoid(150, seed=7)
    np.testing.assert_array_equal(TR.estimate_normals(p), JR.estimate_normals(p))
    _same_model(TR.ball_pivoting_reconstruction(p), JR.ball_pivoting_reconstruction(p))
    _same_model(stt.tdr.construct_surface(stt.tdr.PointCloud(p), cs_method="ball_pivoting", smooth=0)[0],
                st.tdr.construct_surface(jmc.PointCloud(p), cs_method="ball_pivoting", smooth=0)[0])


# -- screened Poisson ---------------------------------------------------------------------------


def _poisson_case(seed, res, n=1500):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    p = p / np.linalg.norm(p, axis=1, keepdims=True) * rng.uniform(0.5, 1.5, 3)
    normals = JR.estimate_normals(p)
    cell = 2.2 * np.abs(p).max() / (res - 3)
    return (p + cell * (res - 1) / 2) / cell, normals


def _cg_f64(diag, b, tol, maxiter):
    """`jax.scipy.sparse.linalg.cg`'s recurrence in float64 numpy; returns
    the iterations it takes."""
    diag, b = diag.astype(np.float64), b.astype(np.float64)

    def A(x):
        p = np.pad(x, 1)
        return diag * x - (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1] + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
                           + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:])

    atol2 = max(tol * tol * np.vdot(b, b), 0.0)
    x = np.zeros_like(b)
    r = b - A(x)
    p = r
    g = np.vdot(r, r)
    k = 0
    while g > atol2 and k < maxiter:
        Ap = A(p)
        a = g / np.vdot(p, Ap)
        x, r = x + a * p, r - a * Ap
        g_new = np.vdot(r, r)
        p = r + (g_new / g) * p
        g, k = g_new, k + 1
    return k


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("res", [16, 24])
def test_splat_and_solve_matches_jax(seed, res):
    import jax.numpy as jnp

    pts_g, normals = _poisson_case(seed, res)
    cj, rj = JR._splat_and_solve(jnp.asarray(pts_g, jnp.float32), jnp.asarray(normals, jnp.float32), res=res,
                                 screen=4.0, tol=1e-5, maxiter=8 * res)
    reads = TR._splat_and_solve.host_reads
    ct, rt = TR._splat_and_solve(pts_g, normals, res, 4.0, 1e-5, 8 * res, device="cpu")
    iters = TR._splat_and_solve.last_iterations
    assert ct.dtype == rt.dtype == torch.float32 and ct.shape == rt.shape == (res,) * 3
    assert _scaled(rt.numpy(), rj) <= RHO_TOL
    assert _scaled(ct.numpy(), cj) <= CHI_TOL
    # one read of the stop flag a block of iterations
    assert TR._splat_and_solve.host_reads - reads == max(1, -(-iters // TR.CG_CHECK_EVERY))
    _, diag, b = TR._poisson_system(pts_g, normals, res, 4.0, device="cpu")
    assert abs(iters - _cg_f64(diag.numpy(), b.numpy(), 1e-5, 8 * res)) <= 1


def test_splat_is_the_rounded_exact_sum():
    """The int64 fixed-point splat is the float64 sum of the JAX package's
    float32 addends rounded once to float32, up to the fixed point's
    quantum (2^-(bits+1) an addend), and the same on every call. On this
    case 7 of 3,804 cells differ from the rounded sum at all."""
    res = 16
    pts_g, normals = _poisson_case(2, res, n=3000)
    pg, nr = torch.from_numpy(pts_g.astype(np.float32)), torch.from_numpy(normals.astype(np.float32))
    bits = TR._splat_bits(len(pg), 1.0)
    grid = TR._splat(pg, nr, res, bits)
    assert torch.equal(grid, TR._splat(pg, nr, res, bits))
    pg_np, nr_np = pg.numpy(), nr.numpy()
    i0 = np.clip(np.floor(pg_np).astype(np.int32), 0, res - 2)
    frac = pg_np - i0.astype(np.float32)  # float32, as in JAX (numpy would promote to float64)
    ref = np.zeros((4, res, res, res))
    count = np.zeros((res, res, res))
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((frac[:, 0] if dx else 1 - frac[:, 0]) * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                ii = (i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz)
                np.add.at(count, ii, 1.0)
                np.add.at(ref[0], ii, w.astype(np.float64))
                for c in range(3):
                    np.add.at(ref[c + 1], ii, (w * nr_np[:, c]).astype(np.float64))
    r32 = ref.astype(np.float32)
    err = np.abs(grid.numpy().astype(np.float64) - ref)
    assert (err <= np.spacing(np.abs(r32)) + count * 2.0 ** -(bits + 1)).all()
    assert (grid.numpy() != r32).mean() < 0.01


def test_poisson_reconstruction_matches_jax():
    from scipy.spatial import cKDTree

    p = _ellipsoid(2000, seed=8, axes=(1.0, 1.0, 1.0))
    mj = JR.poisson_reconstruction(p, max_resolution=32, density_threshold=0.05)
    mt = TR.poisson_reconstruction(p, max_resolution=32, density_threshold=0.05, device="cpu")
    assert mt.n_faces == mj.n_faces and mt.n_points == mj.n_points
    chamfer = 0.5 * (cKDTree(mj.points).query(mt.points)[0].mean() + cKDTree(mt.points).query(mj.points)[0].mean())
    assert chamfer <= 1e-6
    assert abs(mt.volume - mj.volume) <= 1e-6 * mj.volume
    # the welded vertices are ordered by their rounded coordinates: compare at the nearest vertex
    near = cKDTree(mj.points).query(mt.points)[1]
    np.testing.assert_allclose(mt.point_data["density"], mj.point_data["density"][near], rtol=1e-4)


# -- backbones ----------------------------------------------------------------------------------


def _candidates(X, nodes, edges):
    """One growth step's candidates, in the JAX package's order."""
    k = len(nodes)
    part = ((X[:, None, :] - nodes[None, :, :]) ** 2).sum(-1).argmin(1)
    out = [(np.vstack([nodes, (nodes[a] + nodes[b]) / 2]), np.vstack([np.delete(edges, ei, axis=0), [[a, k], [k, b]]]))
           for ei, (a, b) in enumerate(edges)]
    for v in range(k):
        off = X[part == v].mean(0) - nodes[v]
        out.append((np.vstack([nodes, nodes[v] + off]), np.vstack([edges, [[v, k]]])))
    return out


@pytest.mark.parametrize("alpha,n_iter", [(0.0, 5), (0.02, 3), (0.0, 1)])
def test_batched_optimize_elastic_matches_serial(alpha, n_iter):
    X = _y_cloud()
    nodes, edges = JB.ElPiGraph_tree(X, NumNodes=6, topology="tree")
    cands = _candidates(X, nodes, edges)
    out = TB._optimize_elastic_batch(torch.from_numpy(X), np.stack([c[0] for c in cands]),
                                     np.stack([c[1] for c in cands]), 0.01, 0.1, alpha, n_iter)
    for i, (cn, ce) in enumerate(cands):
        n_ref, e_ref = JB._optimize_elastic(X, cn, ce, 0.01, 0.1, alpha, n_iter)
        assert np.abs(out[0][i].numpy() - n_ref).max() <= NODE_TOL
        assert abs(float(out[1][i]) - e_ref) <= 1e-12 * e_ref
        np.testing.assert_array_equal(out[2][i].numpy(), np.bincount(
            ((X[:, None] - n_ref[None]) ** 2).sum(-1).argmin(1), minlength=len(cn)))


@pytest.mark.parametrize("cloud,topology,num_nodes", [("y", "tree", 20), ("circle", "curve", 12),
                                                      ("circle", "circle", 12), ("circle", "tree", 10)])
def test_elpigraph_matches_jax(cloud, topology, num_nodes):
    X = _y_cloud() if cloud == "y" else _circle_cloud()
    nj, ej = JB.ElPiGraph_tree(X, NumNodes=num_nodes, topology=topology)
    TB.ElPiGraph_tree.host_reads = TB.ElPiGraph_tree.steps = 0
    nt, et = TB.ElPiGraph_tree(X, NumNodes=num_nodes, topology=topology, device="cpu")
    np.testing.assert_array_equal(et, ej)
    assert np.abs(nt - nj).max() <= NODE_TOL
    steps = num_nodes - (3 if topology == "circle" else 2)
    # one read a growth step, and one each for the first and the last fit
    assert TB.ElPiGraph_tree.steps == steps and TB.ElPiGraph_tree.host_reads == steps + 2


def test_elpigraph_tie_within_rounding():
    """The Y cloud in circle topology: replaying the JAX package's growth,
    every step's batched energies pick the serial loop's candidate until a
    step where symmetric candidates lie within 2 ulp of each other; there
    the port keeps another of the tied ones."""
    X = _y_cloud()
    mean = X.mean(0)
    _, _, Vt = np.linalg.svd(X - mean, full_matrices=False)
    pc1, pc2 = Vt[0] * X.std(0).max(), Vt[1] * X.std(0).max()
    nodes = np.stack([mean + pc1, mean - 0.5 * pc1 + 0.8 * pc2, mean - 0.5 * pc1 - 0.8 * pc2])
    edges = np.array([[0, 1], [1, 2], [2, 0]])
    nodes, _ = JB._optimize_elastic(X, nodes, edges, 0.01, 0.1, 0.0, 10)
    Xt = torch.from_numpy(X)
    tie = None
    while len(nodes) < 20:
        k = len(nodes)
        cands = [(np.vstack([nodes, (nodes[a] + nodes[b]) / 2]),
                  np.vstack([np.delete(edges, ei, axis=0), [[a, k], [k, b]]])) for ei, (a, b) in enumerate(edges)]
        ref = [JB._optimize_elastic(X, cn, ce, 0.01, 0.1, 0.0, 5) for cn, ce in cands]
        e_ref = np.array([r[1] for r in ref])
        _, e_t, _, _, _ = TB._optimize_elastic_batch(Xt, np.stack([c[0] for c in cands]),
                                                     np.stack([c[1] for c in cands]), 0.01, 0.1, 0.0, 5)
        bj, bt = int(np.argmin(e_ref)), int(torch.argmin(e_t))
        if bj != bt:
            tie = (k, e_ref[bj], e_ref[bt])
            break
        nodes, edges = ref[bj][0], cands[bj][1]
    assert tie is not None and tie[0] == 15
    assert abs(tie[2] - tie[1]) <= 2 * np.spacing(tie[1])


def test_simpleppt_matches_jax():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, 500)
    X = np.c_[np.cos(t), np.sin(t), t / 3] + rng.normal(0, 0.03, (500, 3))
    nj, ej = JB.SimplePPT_tree(X, NumNodes=20)
    nt, et = TB.SimplePPT_tree(X, NumNodes=20, device="cpu")
    assert nt.dtype == np.float32
    np.testing.assert_array_equal(et, ej)
    assert _scaled(nt, nj) <= PPT_TOL


def _arc(n=400, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, np.pi, n)
    pts = np.c_[np.cos(t), np.sin(t), 0.3 * t] + rng.normal(0, 0.02, (n, 3))
    return pts - pts.min(0)


def test_nlpca_forward_and_project_on_carried_weights():
    import jax.numpy as jnp

    X = _arc()
    sj = JB.NLPCA().fit(X, epochs=30, nodes=25)
    m = nlpca_from_reference({k: np.asarray(v) for k, v in sj.params.items()}, device="cpu")
    oj, bj = JB.NLPCA._forward(sj.params, jnp.asarray(X, jnp.float32))
    with torch.no_grad():
        ot, bt = m(torch.from_numpy(X.astype(np.float32)))
    assert np.abs(ot.numpy() - np.asarray(oj)).max() <= NLPCA_FWD_TOL
    assert np.abs(bt.numpy() - np.asarray(bj)).max() <= NLPCA_FWD_TOL
    pj, sj_sorted = sj.project(X)
    pt, st_sorted = m.project(X)
    assert np.abs(pt - pj).max() <= NLPCA_FWD_TOL and np.abs(st_sorted - sj_sorted).max() <= NLPCA_FWD_TOL
    assert np.abs(m.fit_points - sj.fit_points).max() <= NLPCA_FWD_TOL


def test_nlpca_training_and_princurve_match_jax():
    X = _arc()
    init_j = JB.NLPCA().fit(X, epochs=0, nodes=25).params
    init_t = TB.NLPCA(device="cpu").fit(X, epochs=0, nodes=25).params
    assert all(np.array_equal(np.asarray(init_j[k]), init_t[k]) for k in init_t)
    pj = JB.NLPCA().fit(X, epochs=20, nodes=25).params
    pt = TB.NLPCA(device="cpu").fit(X, epochs=20, nodes=25).params
    assert max(np.abs(np.asarray(pj[k]) - pt[k]).max() for k in pt) <= NLPCA_TRAIN_TOL
    nj, ej = JB.PrinCurve(X, NumNodes=15, epochs=20)
    nt, et = TB.PrinCurve(X, NumNodes=15, epochs=20, device="cpu")
    np.testing.assert_array_equal(et, ej)
    assert _scaled(nt, nj) <= PRINCURVE_TOL
    assert TB.orth_dist(X, X + 1.0) == JB.orth_dist(X, X + 1.0)


@pytest.mark.parametrize("rd_method,kw", [("ElPiGraph", {}), ("SimplePPT", {}), ("PrinCurve", {"epochs": 10})])
def test_construct_backbone_and_utilities_match_jax(rd_method, kw):
    X = _y_cloud()[::3]
    bj, lj, _ = st.tdr.construct_backbone(X, rd_method=rd_method, num_nodes=8, **kw)
    bt, lt, _ = stt.tdr.construct_backbone(X, rd_method=rd_method, num_nodes=8, device="cpu", **kw)
    np.testing.assert_array_equal(bt.edges, bj.edges)
    assert np.abs(bt.points - bj.points).max() <= 1e-4 * np.abs(bj.points).max()
    assert abs(lt - lj) <= 1e-4 * lj
    if rd_method != "ElPiGraph":
        return
    aj, at = _adatas(n=150, seed=1)
    st.tdr.map_points_to_backbone(aj, bj)
    stt.tdr.map_points_to_backbone(at, bt)
    np.testing.assert_array_equal(np.asarray(at.obs["nodes"]), np.asarray(aj.obs["nodes"]))
    # the utilities on one backbone (nodes equal only to NODE_TOL across the packages)
    bt = stt.tdr.PointCloud(bj.points, dict(bj.point_data))
    bt.edges = bj.edges
    cj = jmc.PointCloud(X, {"g": X[:, 0] ** 2})
    ct = stt.tdr.PointCloud(X, {"g": X[:, 0] ** 2})
    _same_model(stt.tdr.map_gene_to_backbone(ct, bt, "g"), st.tdr.map_gene_to_backbone(cj, bj, "g"))
    _same_model(stt.tdr.update_backbone(bt, select_nodes=[0, 2, 3, 5]),
                st.tdr.update_backbone(bj, select_nodes=[0, 2, 3, 5]))


def test_backbone_scc_raises_citing_item_11():
    """`backbone_scc` was refused until `tools.cluster.scc` was ported
    (ROADMAP item 11); it now runs, and matches the JAX package: the same
    nodes and the same Leiden and Louvain clusters along one backbone, the
    kNN graphs built on the CPU."""
    X = _y_cloud()[::3]
    bj, _, _ = st.tdr.construct_backbone(X, rd_method="ElPiGraph", num_nodes=8)
    bt = stt.tdr.PointCloud(bj.points, dict(bj.point_data))
    bt.edges = bj.edges
    rng = np.random.default_rng(7)
    expr = (rng.poisson(1.0, (len(X), 12)) + (X[:, :1] > 0) * rng.poisson(3.0, (len(X), 12))).astype(np.float32)
    pcs = rng.normal(size=(len(X), 5)) + (X[:, :1] > 0) * 3.0
    for method in ("leiden", "louvain"):
        aj, at = (pkg.AnnData(X=expr.copy(), obs=pd.DataFrame(index=[f"c{i}" for i in range(len(X))]))
                  for pkg in (st, stt))
        for a in (aj, at):
            a.obsm["spatial"], a.obsm["X_pca"] = X.copy(), pcs.copy()
        st.SKM.init_adata_type(aj, "UMI")
        stt.SKM.init_adata_type(at, "UMI")
        assert st.tdr.backbone_scc(aj, bj, cluster_method=method) is None
        assert stt.tdr.backbone_scc(at, bt, cluster_method=method, device="cpu") is None
        np.testing.assert_array_equal(at.obs["backbone_nodes"], aj.obs["backbone_nodes"])
        np.testing.assert_array_equal(at.obs["backbone_scc"], aj.obs["backbone_scc"])
        assert aj.obs["backbone_scc"].nunique() >= 2
    out = stt.tdr.backbone_scc(at, bt, key_added="k2", inplace=False, device="cpu")
    assert "k2" in out.obs and "k2" not in at.obs


# -- migration models -----------------------------------------------------------------------------


def _vf(n=200, m=20, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    ctrl, C = X[:m].copy(), rng.normal(0, 0.3, (m, 3)).astype(np.float32)
    K = np.exp(-2.0 * ((X[:, None] - ctrl[None]) ** 2).sum(-1))
    return {"X": X, "V": (K @ C).astype(np.float32), "X_ctrl": ctrl, "C": C, "beta": 2.0}


def test_construct_field_and_streams_match_jax():
    vf = _vf()
    pj = jmc.PointCloud(vf["X"], {"V": vf["V"]})
    pt = stt.tdr.PointCloud(vf["X"], {"V": vf["V"]})
    _same_model(stt.tdr.construct_field(pt, n_sampling=50)[0], st.tdr.construct_field(pj, n_sampling=50)[0])
    _same_model(stt.tdr.construct_field_plain(pt)[0], st.tdr.construct_field_plain(pj)[0])
    sj, cj = st.tdr.construct_field_streams(vf, n_streams=30, n_steps=40)
    s_t, ct = stt.tdr.construct_field_streams(vf, n_streams=30, n_steps=40, device="cpu")
    assert cj == ct
    np.testing.assert_array_equal(s_t.lines, sj.lines)
    np.testing.assert_array_equal(s_t.point_data["v_streams"], sj.point_data["v_streams"])
    assert _scaled(s_t.points, sj.points) <= STREAM_TOL


def test_morphopath_models_match_jax():
    rng = np.random.default_rng(3)
    paths = [rng.normal(size=(3, 12)).cumsum(1) for _ in range(25)]
    aj, at = _adatas(n=25, seed=3)
    for a in (aj, at):
        a.uns["fate_develop"] = {"prediction": [p.copy() for p in paths]}
        a.uns["fate_morpho"] = {"prediction": [p.copy() for p in paths]}
    _same_model(stt.tdr.construct_trajectory(at, n_sampling=10, device="cpu")[0],
                st.tdr.construct_trajectory(aj, n_sampling=10)[0])
    _same_model(stt.tdr.construct_trajectory_X([p.T for p in paths])[0],
                st.tdr.construct_trajectory_X([p.T for p in paths])[0])
    for logspace in (False, True):
        gj, _ = st.tdr.construct_genesis(aj, n_steps=5, logspace=logspace)
        gt, _ = stt.tdr.construct_genesis(at, n_steps=5, logspace=logspace)
        assert len(gt) == len(gj)
        for a, b in zip(gt, gj):
            _same_model(a, b)


# -- utilities and IO ---------------------------------------------------------------------------


_COLOR_CASES = ["gainsboro", "GainsBoro", "tab:grey", "k", "#abc", "#abcd", "#a1B2c3", "#a1b2c3d4", "0.25", "none",
                (0.1, 0.2, 0.3), [0.1, 0.2, 0.3, 0.4], np.array([[0.5, 0.5, 0.5]])]


def test_colors_match_matplotlib():
    """`colors.to_rgba` / `to_hex` against matplotlib's on every named color
    and color-string form it resolves, and its list of colormap names
    (matplotlib 3.10's 180)."""
    import matplotlib as mpl
    import matplotlib.colors as mc

    from spateo_tpu_torch.tdr.models.utilities import colors as C

    names = list(mc.CSS4_COLORS) + [n.upper() for n in mc.CSS4_COLORS] + list(mc.TABLEAU_COLORS) + list(
        mc.BASE_COLORS) + _COLOR_CASES + ["xkcd:sky blue", "C3"]
    for n in names:
        for a in (None, 0.3):
            assert C.to_rgba(n, a) == mc.to_rgba(n, a), (n, a)
        assert C.to_hex(n) == mc.to_hex(n), n
    # matplotlib's own colormaps (other packages, colorcet say, register more in a process that imports them)
    assert C.COLORMAP_NAMES <= set(mpl.colormaps()) and len(C.COLORMAP_NAMES) == 180
    for bad in ("nonsense", "1.5", (1, 2), "#12345", (0.1, 2.0, 0.3)):
        with pytest.raises(ValueError):
            C.to_rgba(bad)


@pytest.mark.parametrize("colormap", ["rainbow", "gray", "gainsboro", "tab:blue", {"a": "red", "b": "#00ff00",
                                      "c": "C2"}, ["red", "0.5", (0.1, 0.2, 0.3)]])
@pytest.mark.parametrize("alphamap", [0.5, {"a": 0.2, "b": 0.3, "c": 1.0}, [0.1, 0.2, 0.3, 0.4]])
def test_add_model_labels_equals_jax(colormap, alphamap):
    from spateo_tpu.tdr.models.utilities.label_utils import add_model_labels as j_labels

    from spateo_tpu_torch.tdr.models.utilities.label_utils import add_model_labels as t_labels

    rng = np.random.default_rng(0)
    p, lab = rng.normal(size=(40, 3)), rng.choice(["a", "b", "mask", "c"], 40)
    mj, cj = j_labels(jmc.PointCloud(p), lab, colormap=colormap, alphamap=alphamap)
    mt, ct = t_labels(stt.tdr.PointCloud(p), lab, colormap=colormap, alphamap=alphamap)
    assert ct == cj
    _same_model(mt, mj)


def test_color_names_resolve_without_matplotlib():
    """The models' default colors resolve in an interpreter that never
    imports matplotlib (the GPU machine has none)."""
    import subprocess
    import sys

    code = (
        "import sys, numpy as np\n"
        "sys.modules['matplotlib'] = None\n"
        "import spateo_tpu_torch as stt\n"
        "p = np.random.default_rng(0).normal(size=(30, 3))\n"
        "m, _ = stt.tdr.add_model_labels(stt.tdr.PointCloud(p), np.array(['a'] * 15 + ['mask'] * 15),\n"
        "                                colormap='gainsboro', alphamap=0.5)\n"
        "stt.tdr.construct_lines(p[:3], np.array([[0, 1], [1, 2]]))\n"
        "print('OK', m.point_data['groups_rgba'][0].tolist())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK" in out.stdout



def test_model_utilities_equal_jax():
    p = _ellipsoid(200, seed=9)
    lab = np.where(p[:, 0] > 0, "x+", "x-")
    mj = jmc.PointCloud(p, {"groups": lab})
    mt = stt.tdr.PointCloud(p, {"groups": lab})
    for name, kw in (("center_to_zero", {}), ("translate_model", {"distance": (1, 2, 3), "t_center": (0.5, 0, 0)}),
                     ("rotate_model", {"angle": (10, 20, 30)}), ("scale_model", {"scale_factor": [2, 1, 0.5]})):
        _same_model(getattr(stt.tdr, name)(mt, **kw), getattr(st.tdr, name)(mj, **kw))
    sj, s_t = st.tdr.split_model(mj), stt.tdr.split_model(mt)
    assert list(s_t) == list(sj)
    for k in sj:
        _same_model(s_t[k], sj[k])
    fj = j_alpha(p)
    ft = t_alpha(p)
    _same_model(stt.tdr.multiblock2model([ft, ft]), st.tdr.multiblock2model([fj, fj]))
    for a, b in zip(stt.tdr.collect_models([mt, ft]), st.tdr.collect_models([mj, fj])):
        _same_model(a, b)


def test_save_and_read_model_round_trip(tmp_path):
    p = _ellipsoid(120, seed=10)
    mesh = t_alpha(p)
    mesh.point_data["groups"] = np.asarray(["a"] * mesh.n_points, dtype=object)
    line, _ = stt.tdr.construct_lines(p[:4], np.array([[0, 1], [1, 2], [2, 3]]))
    pc = stt.tdr.PointCloud(p, {"v": p[:, 0]})
    jmesh = j_alpha(p)
    jmesh.point_data["groups"] = np.asarray(["a"] * jmesh.n_points, dtype=object)
    jline, _ = st.tdr.construct_lines(p[:4], np.array([[0, 1], [1, 2], [2, 3]]))
    jpc = jmc.PointCloud(p, {"v": p[:, 0]})
    for i, (m, jm) in enumerate(((mesh, jmesh), (line, jline), (pc, jpc))):
        ft = stt.tdr.save_model(m, str(tmp_path / f"t{i}"), texture="groups" if i == 0 else None)
        fj = st.tdr.save_model(jm, str(tmp_path / f"j{i}"), texture="groups" if i == 0 else None)
        _same_model(stt.tdr.read_model(ft), st.tdr.read_model(fj))
        _same_model(stt.tdr.read_model(fj), st.tdr.read_model(ft))


# -- morphometrics ------------------------------------------------------------------------------


def test_model_morphology_and_shape_similarity_equal_jax():
    p = _ellipsoid(500, seed=11)
    mj, mt = j_alpha(p), t_alpha(p)
    assert stt.tdr.model_morphology(mt, pc=stt.tdr.PointCloud(p)) == st.tdr.model_morphology(mj, pc=jmc.PointCloud(p))
    assert stt.tdr.model_morphology(stt.tdr.PointCloud(p)) == st.tdr.model_morphology(jmc.PointCloud(p))
    q = _ellipsoid(500, seed=12, axes=(1.0, 0.8, 1.2))
    assert stt.tdr.pairwise_shape_similarity(p, q) == st.tdr.pairwise_shape_similarity(p, q)
    np.testing.assert_array_equal(stt.tdr.model_eigenvector(q, n_subspace=8), st.tdr.model_eigenvector(q, n_subspace=8))


@pytest.mark.parametrize("kernel", ["gaussian", "tophat", "epanechnikov", "exponential", "linear", "cosine"])
@pytest.mark.parametrize("bandwidth", [0.3, 1.0])
def test_pc_kde_matches_sklearn(kernel, bandwidth):
    from sklearn.neighbors import KernelDensity

    p = np.random.default_rng(13).normal(size=(600, 3))
    ref = np.exp(KernelDensity(kernel=kernel, bandwidth=bandwidth).fit(p).score_samples(p))
    out, _ = stt.tdr.pc_KDE(stt.tdr.PointCloud(p), kernel=kernel, bandwidth=bandwidth, device="cpu")
    dens = out.point_data["kde"]
    assert np.abs(dens / ref - 1).max() <= KDE_TOL
    if kernel == "gaussian" and bandwidth == 1.0:
        jout, _ = st.tdr.pc_KDE(jmc.PointCloud(p), kernel=kernel, bandwidth=bandwidth)
        assert np.abs(dens / jout.point_data["kde"] - 1).max() <= KDE_TOL
        pc = stt.tdr.PointCloud(p)
        assert stt.tdr.pc_KDE(pc, inplace=True, device="cpu") == (None, None) and "kde" in pc.point_data


def test_tdr_exports_what_jax_exports_but_interpolation_engines_and_widgets():
    """`stt.tdr` exports what `st.tdr` does, the interpolation engines and
    the widgets included (their parity is in `tests/test_torch_widgets.py`):
    nothing is left out."""
    left_out = set()
    jax_names = {n for n in dir(st.tdr) if not n.startswith("_")}
    port_names = {n for n in dir(stt.tdr) if not n.startswith("_")}
    assert jax_names - port_names == left_out
    assert {n for n in dir(st.tdr.models) if not n.startswith("_")} <= {n for n in dir(stt.tdr.models)}
