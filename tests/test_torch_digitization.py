"""The digitization slice of the port (`stt.dd`, `ops.stencil`,
`ops.jacobi_cuda`) held against the JAX package on the CPU.

Inputs are made with numpy (and OpenCV, for contours) from a seed; each
AnnData is built once with `spateo_tpu` and carried across with
`core.bridge.adata_from_reference`. The Pallas sweep runs in interpret mode,
as the JAX package's own tests run it. The port's sweep uses the same
float32 operations in the same order as the JAX package's XLA step, so the
fields it gives are expected to equal the JAX ones bit for bit; the tests
assert that, and equal iteration counts.
"""

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse

import jax.numpy as jnp

import spateo_tpu as st
import spateo_tpu_torch as stt
from spateo_tpu.ops import stencil as jst
from spateo_tpu_torch.core.bridge import adata_from_reference
from spateo_tpu_torch.ops import jacobi_cuda
from spateo_tpu_torch.ops import stencil as tst

REPO = Path(__file__).resolve().parent.parent


def _frame_equal(a: pd.DataFrame, b: pd.DataFrame):
    assert list(a.columns) == list(b.columns)
    for c in a.columns:
        np.testing.assert_array_equal(np.asarray(a[c]), np.asarray(b[c]), err_msg=c)


# -- the bridge --------------------------------------------------------------


def test_adata_from_reference_carries_every_field():
    """X, layers, obs, var, uns, obsm, varm, obsp (sparse) and varp (dense)
    arrive equal and as copies."""
    rng = np.random.default_rng(0)
    n, g = 30, 5
    a = st.AnnData(
        X=rng.poisson(2.0, (n, g)).astype(np.float32),
        obs=pd.DataFrame({"cl": rng.choice(["A", "B"], n)}, index=[f"c{i}" for i in range(n)]),
        var=pd.DataFrame(index=[f"g{j}" for j in range(g)]),
    )
    a.layers["counts"] = sparse.csr_matrix(a.X)
    a.obsm["spatial"] = rng.uniform(0, 40, (n, 2))
    a.varm["loadings"] = rng.normal(size=(g, 3))
    a.obsp["connectivities"] = sparse.random(n, n, density=0.1, format="csr", random_state=1)
    a.varp["corr"] = rng.normal(size=(g, g))
    st.SKM.init_adata_type(a, "UMI")
    b = adata_from_reference(a)
    np.testing.assert_array_equal(b.X, a.X)
    _frame_equal(b.obs, a.obs)
    assert list(b.obs_names) == list(a.obs_names) and list(b.var_names) == list(a.var_names)
    assert b.uns == a.uns
    for field in ("layers", "obsm", "varm", "obsp", "varp"):
        src, dst = getattr(a, field), getattr(b, field)
        assert set(dst) == set(src), field
        for k in src:
            assert sparse.issparse(dst[k]) == sparse.issparse(src[k]), (field, k)
            x, y = (m.toarray() if sparse.issparse(m) else m for m in (src[k], dst[k]))
            np.testing.assert_array_equal(y, x)
    b.obsm["spatial"][0, 0] = -1.0
    b.obsp["connectivities"].data[:] = 7.0
    assert a.obsm["spatial"][0, 0] != -1.0 and not (a.obsp["connectivities"].data == 7.0).any()


# -- the sweep block ------------------------------------------------------------


def _upd(H, W, border):
    upd = np.zeros((H, W), np.uint8)
    upd[1:-1, 1:-1] = 1
    upd[border] = 0
    return upd


def _block_case(H, W, seed=0):
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(0, 10, (H, W)).astype(np.float32)
    border = np.zeros((H, W), bool)
    border[0] = border[-1] = True
    border[min(3, H - 1), W // 3 : W // 2] = True
    border[rng.uniform(size=(H, W)) < 0.05] = True
    return f0, border


def test_jacobi_block_reference_matches_pallas_interpret():
    """The case of tests/test_digitization.py:33-60 (16x128, 7 sweeps) at its
    bar, atol 1e-6: the TPU kernel blends f + upd*(avg - f), which may be an
    ulp off the select for a moving pixel."""
    from spateo_tpu.ops.stencil import _jacobi_pallas_block

    f0, border = _block_case(16, 128)
    upd = _upd(16, 128, border)
    want = np.asarray(_jacobi_pallas_block(jnp.asarray(f0), jnp.asarray(upd.astype(np.float32)), 7, interpret=True))
    got = jacobi_cuda.jacobi_block_reference(torch.from_numpy(f0), torch.from_numpy(upd), 7).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [0, 1, 7, 40])
@pytest.mark.parametrize("shape", [(16, 128), (3, 3), (37, 53)])
def test_jacobi_block_reference_matches_xla_block(shape, n):
    """Against one block of the JAX package's XLA step (`_jacobi_kernel` with
    use_pallas=False, max_itr=0 so exactly one block runs, mask 1): equal
    bits."""
    H, W = shape
    f0, border = _block_case(H, W, seed=H)
    got = jacobi_cuda.jacobi_block_reference(torch.from_numpy(f0), torch.from_numpy(_upd(H, W, border)), n).numpy()
    if n == 0:
        np.testing.assert_array_equal(got, f0)
        return
    want, it, _ = jst._jacobi_kernel(jnp.asarray(f0), jnp.asarray(border), jnp.ones((H, W), jnp.float32), -1.0, 0, n)
    assert int(it) == n
    np.testing.assert_array_equal(got, np.asarray(want))


def test_jacobi_block_on_cpu_is_plain_and_uncounted():
    """A CPU tensor takes the plain version and counts no launch; the input
    is not modified; a tensor on neither the CPU nor a CUDA device raises."""
    f0, border = _block_case(20, 30)
    f = torch.from_numpy(f0.copy())
    upd = torch.from_numpy(_upd(20, 30, border))
    before = jacobi_cuda.jacobi_block.launches
    out = jacobi_cuda.jacobi_block(f, upd, 5)
    assert jacobi_cuda.jacobi_block.launches == before
    np.testing.assert_array_equal(out.numpy(), jacobi_cuda.jacobi_block_reference(f, upd, 5).numpy())
    np.testing.assert_array_equal(f.numpy(), f0)
    with pytest.raises(ValueError):
        jacobi_cuda.jacobi_block(torch.empty((4, 4), device="meta"), torch.empty((4, 4), dtype=torch.uint8, device="meta"), 1)


def test_jacobi_block_with_weight_on_cpu_is_plain():
    """With a weight, a CPU tensor returns the plain field and its relative
    change from `rel_change_reference`, the value `_heat_loop` reads once
    per block; no launch of either kernel is counted."""
    f0, border = _block_case(20, 30, seed=3)
    f = torch.from_numpy(f0)
    upd = torch.from_numpy(_upd(20, 30, border))
    w = torch.from_numpy((np.arange(600).reshape(20, 30) % 3 != 0).astype(np.float32))
    before = (jacobi_cuda.jacobi_block.launches, jacobi_cuda.jacobi_block.err_launches)
    out, err = jacobi_cuda.jacobi_block(f, upd, 7, weight=w)
    assert (jacobi_cuda.jacobi_block.launches, jacobi_cuda.jacobi_block.err_launches) == before
    want = jacobi_cuda.jacobi_block_reference(f, upd, 7)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    assert err.shape == () and float(err) == float(jacobi_cuda.rel_change_reference(want, f, w)) > 0


# -- the solvers ------------------------------------------------------------------


def _case_ramp():
    """tests/test_digitization.py:13-31: hot and cold edges, linear top/bottom."""
    H, W = 32, 64
    field = np.zeros((H, W), np.float32)
    border = np.zeros((H, W))
    field[:, 0], field[:, -1] = 1.0, 100.0
    ramp = np.linspace(1, 100, W)
    field[0], field[-1] = ramp, ramp
    border[:, 0] = border[:, -1] = border[0] = border[-1] = 1
    return field, border, np.ones((H, W)), dict(max_err=1e-8, max_itr=50_000)


def _case_rows():
    """tests/test_digitization.py:62-80: Dirichlet top and bottom rows."""
    H = W = 24
    init = np.zeros((H, W), np.float32)
    border = np.zeros((H, W))
    init[0, :], init[-1, :] = 1, 100
    border[0] = border[-1] = 1
    return init, border, np.ones((H, W)), dict(max_err=1e-12, max_itr=100_000)


def _case_max_itr():
    """Stopped by max_itr = 250 with blocks of 100: it overshoots to 300."""
    field, border, mask, _ = _case_ramp()
    return field, border, mask, dict(max_err=0.0, max_itr=250, check_every=100)


def _case_masked():
    """tests/test_digitization.py:235-254 (serial half): isolines inside a
    masked sub-domain of a 60x60 raster."""
    H = W = 60
    field = np.zeros((H, W), np.float32)
    border = np.zeros((H, W), bool)
    mask = np.zeros((H, W), np.float32)
    mask[5:-5, 5:-5] = 1
    field[5, 5:-5], field[-6, 5:-5] = 1.0, 100.0
    border[5, 5:-5] = border[-6, 5:-5] = True
    return field, border, mask, dict(max_itr=20_000, max_err=1e-8)


def _case_ragged():
    """A ragged raster with scattered Dirichlet pixels and blocks of 37."""
    rng = np.random.default_rng(3)
    H, W = 45, 71
    field = rng.uniform(0, 100, (H, W)).astype(np.float32)
    border = rng.uniform(size=(H, W)) < 0.02
    return field, border, np.ones((H, W)), dict(max_err=1e-6, max_itr=5_000, check_every=37)


@pytest.mark.parametrize("case", [_case_ramp, _case_rows, _case_max_itr, _case_masked, _case_ragged])
def test_jacobi_solve_matches_jax(case):
    """Same iteration count, equal fields (tolerance 0: the same float32
    sweeps), errors within 1e-6 relative (the sums run in other orders)."""
    field, border, mask, kw = case()
    fj, itj, errj = jst.jacobi_solve(field, border, mask, **kw)
    ft, itt, errt = tst.jacobi_solve(field, border, mask, device="cpu", **kw)
    assert itt == itj
    if case is _case_max_itr:
        assert itt == 300
    np.testing.assert_array_equal(ft, fj)
    assert errt == pytest.approx(errj, rel=1e-6, abs=1e-30)


@pytest.mark.parametrize("graph", ["path", "knn"])
def test_graph_heat_solve_matches_jax(graph):
    """The path graph of tests/test_digitization.py:82-87, and a 5-NN graph
    of 200 random points: same iteration count, values within 1e-4 on a
    scale of 100 (the neighbour sums run in other orders)."""
    if graph == "path":
        rows = np.array([0, 1, 1, 2, 2, 3, 3, 4])
        cols = np.array([1, 0, 2, 1, 3, 2, 4, 3])
        args = (5, rows, cols, [0], [4])
        kw = dict(lh=0.0, hh=4.0)
    else:
        from scipy.spatial import cKDTree

        rng = np.random.default_rng(4)
        pts = rng.uniform(0, 1, (200, 2))
        _, nn = cKDTree(pts).query(pts, 6)
        rows, cols = np.repeat(np.arange(200), 5), nn[:, 1:].ravel()
        args = (200, rows, cols, np.argsort(pts[:, 0])[:10], np.argsort(pts[:, 0])[-10:])
        kw = dict(max_itr=5_000)
    vj, itj, _ = jst.graph_heat_solve(*args, **kw)
    vt, itt, _ = tst.graph_heat_solve(*args, device="cpu", **kw)
    assert itt == itj
    np.testing.assert_allclose(vt, vj, atol=1e-4, rtol=0)


# -- the entry points -------------------------------------------------------------


@pytest.fixture
def domain_adata():
    """tests/test_digitization.py:90-103: cells filling a square domain, and
    its contour."""
    xs, ys = np.meshgrid(np.arange(5, 35), np.arange(5, 35))
    coords = np.c_[xs.ravel(), ys.ravel()].astype(float)
    adata = st.AnnData(X=np.ones((len(coords), 4)))
    adata.obsm["spatial"] = coords
    st.SKM.init_adata_type(adata, "UMI")
    mask = np.zeros((40, 40), np.uint8)
    mask[5:35, 5:35] = 255
    ctrs, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    return adata, ctrs


def test_digitize_and_gridit_match_jax(domain_adata):
    """Layer and column heat equal (the same sweeps and iteration counts),
    and every label gridit writes equal."""
    aj, ctrs = domain_adata
    at = adata_from_reference(aj)
    corners = ((5, 5), (34, 5), (5, 34), (34, 34))
    st.dd.digitize(aj, ctrs, 0, *corners, max_itr=20000)
    stt.dd.digitize(at, ctrs, 0, *corners, max_itr=20000, device="cpu")
    for key in ("digital_layer", "digital_column"):
        np.testing.assert_array_equal(np.asarray(at.obs[key]), np.asarray(aj.obs[key]))
    assert (np.asarray(at.obs["digital_layer"]) > 0).mean() > 0.9
    st.dd.gridit(aj, layer_num=4, column_num=4)
    stt.dd.gridit(at, layer_num=4, column_num=4)
    _frame_equal(at.obs, aj.obs)


def _cluster_adata(n, seed, grid=False, split=20, extent=40):
    rng = np.random.default_rng(seed)
    if grid:
        xs, ys = np.meshgrid(np.arange(2, extent - 2), np.arange(2, extent - 2))
        coords = np.c_[xs.ravel(), ys.ravel()].astype(float)
    else:
        coords = rng.uniform(2, extent - 2, (n, 2))
    a = st.AnnData(X=np.ones((len(coords), 3)))
    a.obsm["spatial"] = coords
    a.obs["cl"] = np.where(coords[:, 0] < split, "A", "B")
    st.SKM.init_adata_type(a, "UMI")
    return a


def test_contours_and_domains_match_jax():
    """`gen_cluster_image`, `extract_cluster_contours` and `set_domains`
    (tests/test_digitization.py:130-156): equal images, contours and obs."""
    aj = _cluster_adata(300, 0)
    at = adata_from_reference(aj)
    img_j = st.dd.gen_cluster_image(aj, bin_size=2, cluster_key="cl")
    img_t = stt.dd.gen_cluster_image(at, bin_size=2, cluster_key="cl")
    np.testing.assert_array_equal(img_t, img_j)
    _frame_equal(at.obs, aj.obs)
    cj, fj, oj = st.dd.extract_cluster_contours(img_j, [1], bin_size=2, min_area=4)
    ct, ft, ot = stt.dd.extract_cluster_contours(img_t, [1], bin_size=2, min_area=4)
    assert len(ct) == len(cj) >= 1
    for x, y in zip(ct, cj):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(ot, oj)

    aj = _cluster_adata(400, 1)
    at = adata_from_reference(aj)
    st.dd.set_domains(aj, bin_size_high=2, cluster_key="cl", min_area=2)
    stt.dd.set_domains(at, bin_size_high=2, cluster_key="cl", min_area=2)
    _frame_equal(at.obs, aj.obs)
    assert (np.asarray(at.obs["domain_cl"]) != "NA").mean() > 0.7


def test_borderline_and_grid_borderline_match_jax():
    """`get_borderline` (tests/test_digitization.py:159-172), then its ordered
    line through `grid_borderline`: equal images, line and labels."""
    aj = _cluster_adata(0, 0, grid=True, split=30, extent=60)
    at = adata_from_reference(aj)
    img_j = st.dd.get_borderline(aj, "cl", ["A"], ["B"], bin_size=1, k_size=4, min_area=4)
    img_t = stt.dd.get_borderline(at, "cl", ["A"], ["B"], bin_size=1, k_size=4, min_area=4)
    np.testing.assert_array_equal(img_t, img_j)
    line_j = st.dd.order_borderline(img_j)
    line_t = stt.dd.order_borderline(img_t)
    assert line_t == line_j and len(line_t) > 20
    st.dd.grid_borderline(aj, img_j, line_j, layer_num=2, column_num=5, layer_width=5, init=True)
    stt.dd.grid_borderline(at, img_t, line_t, layer_num=2, column_num=5, layer_width=5, init=True, device="cpu")
    _frame_equal(at.obs, aj.obs)


def test_boundary_old_api_matches_jax():
    """`identify_boundary`, `order_borderline`/`format_boundary_line`,
    `boundary_gridding` (tests/test_digitization.py:175-213) and
    `extend_layer`: equal images, segments and labels."""
    aj = _cluster_adata(0, 0, grid=True, split=30, extent=60)
    at = adata_from_reference(aj)
    img_j = st.dd.identify_boundary(aj, "cl", ["A"], ["B"], bin_size=1, k_size=4, min_area=4)
    img_t = stt.dd.identify_boundary(at, "cl", ["A"], ["B"], bin_size=1, k_size=4, min_area=4)
    np.testing.assert_array_equal(img_t, img_j)
    _frame_equal(at.obs, aj.obs)
    line = st.dd.order_borderline(img_j)
    assert len(line) >= 8
    fl_j = st.dd.format_boundary_line(img_j, line[0], line[-1])
    fl_t = stt.dd.format_boundary_line(img_t, line[0], line[-1])
    assert fl_t[0] == fl_j[0]
    np.testing.assert_array_equal(fl_t[1], fl_j[1])
    ex_j = st.dd.extend_layer(img_j, line, extend_width=5)
    ex_t = stt.dd.extend_layer(img_t, line, extend_width=5, device="cpu")
    np.testing.assert_array_equal(ex_t[0], ex_j[0])
    assert ex_t[1] == ex_j[1]
    segs_j = st.dd.boundary_gridding(aj, img_j, line, n_layer=2, n_column=5, layer_width=5, init=True)
    segs_t = stt.dd.boundary_gridding(at, img_t, line, n_layer=2, n_column=5, layer_width=5, init=True, device="cpu")
    assert len(segs_t) == len(segs_j) >= 3
    for x, y in zip(segs_t, segs_j):
        np.testing.assert_array_equal(x, y)
    _frame_equal(at.obs, aj.obs)
    assert (np.asarray(at.obs["layer_label"]) != 0).any()


def test_calc_op_field_and_digitize_general_match_jax():
    """`calc_op_field` (tests/test_digitization.py:215-232) equal to the JAX
    field; `digitize_general` on a 6-NN graph within 1e-4 on a scale of 100."""
    field = np.zeros((40, 40), np.float32)
    border = np.zeros((40, 40), np.float32)
    mask = np.zeros((40, 40), np.float32)
    mask[5:35, 5:35] = 1
    lines = ([(x, 5) for x in range(5, 35)], [(x, 34) for x in range(5, 35)],
             [(5, y) for y in range(5, 35)], [(34, y) for y in range(5, 35)])
    for ln in lines:
        for x, y in ln:
            border[y, x] = 1
    want = st.dd.calc_op_field(field, *lines, border, mask, max_itr=2e4, lp=1, hp=100)
    got = stt.dd.calc_op_field(field, *lines, border, mask, max_itr=2e4, lp=1, hp=100, device="cpu")
    np.testing.assert_array_equal(got, want)

    from scipy.spatial import cKDTree

    rng = np.random.default_rng(5)
    pc = rng.uniform(0, 1, (150, 2))
    _, nn = cKDTree(pc).query(pc, 7)
    adj = sparse.csr_matrix((np.ones(150 * 6), (np.repeat(np.arange(150), 6), nn[:, 1:].ravel())), shape=(150, 150))
    lo, hi = np.argsort(pc[:, 1])[:8], np.argsort(pc[:, 1])[-8:]
    want = st.dd.digitize_general(pc, adj, lo, hi, max_itr=3000)
    got = stt.dd.digitize_general(pc, adj, lo, hi, max_itr=3000, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_digitization_imports_neither_jax_nor_opencv():
    """`import spateo_tpu_torch` (with `stt.dd`) and the digitization and
    label modules load no JAX module, no `spateo_tpu` module and no cv2."""
    code = (
        "import sys; import spateo_tpu_torch as stt; import spateo_tpu_torch.digitization.utils, "
        "spateo_tpu_torch.ops.labels, spateo_tpu_torch.ops.stencil, spateo_tpu_torch.ops.jacobi_cuda; "
        "assert stt.dd.digitize and stt.dd.utils_old.calc_op_field and stt.dd.boundary_old.identify_boundary; "
        "bad = [m for m in sys.modules if m in ('jax', 'cv2', 'spateo_tpu') or m.startswith(('jax.', 'jaxlib', "
        "'spateo_tpu.', 'cv2.'))]; sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
