"""The port's CUDA kernels on the card, held against their plain versions.

Marked `cuda`: each test skips where no NVIDIA GPU is visible (the decision
is made in a fixture, at run time). On a machine with a card and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from spateo_tpu_torch.alignment.methods import math as amath
from spateo_tpu_torch.ops import bp_cuda, em, estep_cuda, inlier_cuda, jacobi_cuda, labels, stencil
from spateo_tpu_torch.segmentation import starro

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _phi_m(H, W, dtype, device, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    phi = torch.rand((2, H, W), generator=gen, device=device) + 0.05
    phi = (phi / phi.sum(0, keepdim=True)).contiguous()
    M = (torch.rand((4, H, W), generator=gen, device=device) * 0.96 + 0.02).to(dtype)
    return phi, M


BP_SHAPES = [(1, 1), (7, 33), (130, 257), (13, 1), (9, 31), (40, 32), (33, 33), (17, 255), (21, 257), (11, 1500),
             (1000, 1500), (37, 1002), (3, 4100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BP_SHAPES)
def test_bp_step_kernel_matches_plain(cuda, dtype, shape):
    """Kernel vs `bp_step_reference` on ragged shapes: equal bits in both
    types (the same f32 operations in the same order, one rounding to bf16).
    The widths cover one pixel, a lane, a warp's strip and its ragged ends,
    rows of 1,500 (not 16-byte aligned in bf16), 1,002 (2 elements) and odd
    widths (scalar accesses); the heights are no multiple of a strip's rows.
    One counted launch."""
    phi, M = _phi_m(*shape, dtype, cuda)
    before = bp_cuda.bp_step.launches
    out = bp_cuda.bp_step(phi, M, 0.6, 0.4)
    torch.cuda.synchronize()
    assert bp_cuda.bp_step.launches == before + 1
    ref = bp_cuda.bp_step_reference(phi, M, 0.6, 0.4)
    assert out.dtype == dtype and out.shape == M.shape
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bp_step_kernel_misaligned_messages(cuda, dtype):
    """Message planes that start off a 16-byte boundary (a view one element
    into a larger buffer) take narrower accesses, with the same bits."""
    phi, M = _phi_m(29, 512, dtype, cuda)
    buf = torch.empty(M.numel() + 1, dtype=dtype, device=cuda)
    Mv = buf[1:].view(M.shape)
    Mv.copy_(M)
    assert Mv.is_contiguous() and Mv.data_ptr() % 16 != 0
    assert torch.equal(bp_cuda.bp_step(phi, Mv, 0.6, 0.4), bp_cuda.bp_step_reference(phi, M, 0.6, 0.4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,q", [(0.6, 0.4), (0.999, 1e-4), (0.5, 0.5), (3.0, 2000.0)])
def test_bp_step_kernel_wide_inputs(cuda, dtype, p, q):
    """Messages and potentials spread over [1e-30, 1] (log-uniform), with
    exact 0s and 1s, so that the products fall on both sides of the
    branch-free division's range and outside it, and edge potentials inside
    and outside [2^-10, 2^10]: equal bits to `bp_step_reference`."""
    rng = np.random.default_rng(11)
    H, W = 300, 777

    def wide(shape):
        x = np.exp(rng.uniform(np.log(1e-30), 0.0, shape))
        x = np.where(rng.uniform(size=shape) < 0.3, rng.uniform(size=shape), x)
        pick = rng.uniform(size=shape)
        return np.where(pick < 0.03, 0.0, np.where(pick > 0.97, 1.0, x)).astype(np.float32)

    phi = torch.from_numpy(wide((2, H, W))).to(cuda)
    M = torch.from_numpy(wide((4, H, W))).to(cuda).to(dtype)
    ref = bp_cuda.bp_step_reference(phi, M, p, q)
    assert torch.equal(bp_cuda.bp_step(phi, M, p, q), ref)


def test_bp_step_kernel_config_matches_plan(cuda):
    """The compiled choice is the one `step_plan` and the wrapper assume."""
    cfg = bp_cuda.kernel_config()
    assert (cfg["V"], cfg["R"], cfg["NW"], cfg["threads"]) == (bp_cuda.LANE_PIXELS, bp_cuda.STRIP_ROWS,
                                                               bp_cuda.BLOCK_WARPS, 32 * bp_cuda.BLOCK_WARPS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1), (17, 255), (130, 257), (1000, 1500), (2048, 2048)])
def test_bp_step_fused_delta(cuda, dtype, shape):
    """`bp_step(..., delta=True)`: the messages of a plain launch; the delta
    within 1e-5 relative of `delta_reference` (f64 sums in the kernel's
    order against f32 sums); the same bits on two runs; one counted launch
    of each kernel."""
    phi, M = _phi_m(*shape, dtype, cuda, seed=3)
    before = (bp_cuda.bp_step.launches, bp_cuda.bp_step.delta_launches)
    out, d = bp_cuda.bp_step(phi, M, 0.6, 0.4, delta=True)
    torch.cuda.synchronize()
    assert (bp_cuda.bp_step.launches, bp_cuda.bp_step.delta_launches) == (before[0] + 1, before[1] + 1)
    assert d.shape == () and d.dtype == torch.float32 and d.device == M.device
    assert torch.equal(out, bp_cuda.bp_step(phi, M, 0.6, 0.4))
    torch.testing.assert_close(d, bp_cuda.delta_reference(out, M), rtol=1e-5, atol=0)
    assert torch.equal(bp_cuda.bp_step(phi, M, 0.6, 0.4, delta=True)[1], d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bp_step_fused_delta_zero_at_fixed_point(cuda, dtype):
    """With p = q every outgoing message is exactly 0.5, so messages of 0.5
    are a fixed point: the fused delta is exactly 0."""
    phi, _ = _phi_m(67, 300, dtype, cuda, seed=4)
    M = torch.full((4, 67, 300), 0.5, dtype=dtype, device=cuda)
    out, d = bp_cuda.bp_step(phi, M, 0.5, 0.5, delta=True)
    assert torch.equal(out, M)
    assert float(d) == 0.0


def test_bp_step_rejects_bad_inputs(cuda):
    phi, M = _phi_m(8, 8, torch.float32, cuda)
    with pytest.raises(TypeError):
        bp_cuda.bp_step(phi.double(), M, 0.6, 0.4)
    with pytest.raises(ValueError):
        bp_cuda.bp_step(phi, M[:, :4], 0.6, 0.4)
    with pytest.raises(ValueError):
        bp_cuda.bp_step(phi, M.cpu(), 0.6, 0.4)


@pytest.mark.parametrize("msg_dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_bp_kernel_cuda_matches_cpu(cuda, msg_dtype, tol):
    """The full loop on the card against the plain loop on the CPU."""
    phi, _ = _phi_m(96, 160, torch.float32, cuda)
    phi = phi.permute(1, 2, 0).contiguous()
    out = bp_cuda.bp_kernel(phi, 0.6, 0.4, 1e-6, 30, check_every=10, msg_dtype=msg_dtype)
    ref = bp_cuda.bp_kernel(phi.cpu(), 0.6, 0.4, 1e-6, 30, check_every=10, msg_dtype=msg_dtype)
    torch.testing.assert_close(out.cpu(), ref, atol=tol, rtol=0)


def test_starro_score_mask_cuda_matches_cpu(cuda):
    """Steps 5-7 of one tile, from one density raster and one NB fit, through
    the fused 4-neighbour loop with bf16 messages on the card (kernel) and on
    the CPU (plain): mask IoU >= 0.999 (conditionals differ at the ulp of
    lgamma between the two devices)."""
    rng = np.random.default_rng(0)
    X = rng.negative_binomial(1, 0.5, (256, 256)).astype(np.float32)
    X[40:90, 60:120] += rng.negative_binomial(8, 0.35, (50, 60))
    res, samp, w0, mu0, var0, _ = starro._starro_density_init_sample(torch.from_numpy(X), 5, 1000, seed=0)
    ones = torch.ones((1, 1000), dtype=torch.bool)
    w, r, p = em._nbn_em_batched(samp[None], ones, w0[None], mu0[None], var0[None])
    args = (w[0], r[0], p[0], 7, starro._offsets(3, False), 0.6, 0.4, 1e-6, 50, True, "bfloat16")
    s_gpu, m_gpu = starro._starro_score_mask(res.to(cuda), *args)
    s_cpu, m_cpu = starro._starro_score_mask(res, *args)
    a, b = m_gpu.cpu().numpy(), m_cpu.numpy()
    assert np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1) >= 0.999


ESTEP_KEYS = ("K_NA", "K_NA_spatial", "K_NA_sigma2", "K_NB", "Sp", "sigma2_related", "PXB", "M1")


def _estep_args(NA, B, device, sigma2=0.05, morton=False, G=50, seed=0):
    """E-step inputs on `device`: kl factors of Poisson counts over G genes,
    coordinates in a unit-scale box (Morton-ordered when asked)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.7, 1.7, (NA, 2)).astype(np.float32)
    b = rng.uniform(-1.7, 1.7, (B, 2)).astype(np.float32)
    if morton:
        a, b = a[np.argsort(amath.morton_code(a))], b[np.argsort(amath.morton_code(b))]
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    fac = amath.factorize_distance(T(rng.poisson(2.0, (NA, G)).astype(np.float32)),
                                   T(rng.poisson(2.0, (B, G)).astype(np.float32)), "kl")
    mm = T(rng.uniform(0.5, 1, NA).astype(np.float32))
    s = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return (T(a), T(a), T(b), *fac, mm, s(sigma2), s(0.7), s(3.0), s(2.0), s(0.05))


def _scaled(ref, out):
    return float((out - ref).abs().max() / (ref.abs().max() + 1e-30))


@pytest.mark.parametrize("NA,B,sigma2,morton", [
    (1000, 333, 0.05, False),   # ragged: neither is a multiple of 64
    (777, 65, 0.3, False),
    (20000, 2000, 0.05, False),
    (30000, 3000, 1e-3, True),  # Morton-ordered at the solver's sigma2 floor: most tiles skip
])
def test_estep_kernels_match_plain(cuda, NA, B, sigma2, morton):
    """Both kernels against `estep_reference` on the card: every reduction
    within 1e-4 of its scale at sigma2 >= 0.05 and 2e-3 at 1e-3, where one
    ulp of |a|^2 in the distance expansion moves exp(-d s2v / (2 sigma2))
    by ~1e-4 relative and the two round the expansion differently; one
    counted launch each."""
    args = _estep_args(NA, B, cuda, sigma2, morton)
    before = (estep_cuda.colnorm.launches, estep_cuda.rowred.launches)
    out = estep_cuda.estep_cuda(*args)
    torch.cuda.synchronize()
    assert (estep_cuda.colnorm.launches, estep_cuda.rowred.launches) == (before[0] + 1, before[1] + 1)
    ref = estep_cuda.estep_reference(*args)
    tol = 1e-4 if sigma2 >= 0.05 else 2e-3
    for k in ESTEP_KEYS:
        assert out[k].shape == ref[k].shape and bool(torch.isfinite(out[k]).all()), k
        assert _scaled(ref[k], out[k]) < tol, (k, _scaled(ref[k], out[k]))
    if morton:
        skip = estep_cuda.tile_skip_mask(args[0], args[2], args[8])
        assert float(skip.float().mean()) > 0.5


def test_estep_kernels_skip_nothing_and_everything(cuda, monkeypatch):
    """With skipping disabled the kernels give the same reductions to 1e-6
    of scale (what a skip drops is below e^-40 per pair); with every tile
    skipped every row output is 0, which shows the skip path is live."""
    args = _estep_args(6000, 700, cuda, sigma2=1e-3, morton=True, seed=1)
    with_skip = estep_cuda.estep_cuda(*args)
    monkeypatch.setattr(estep_cuda, "_SKIP_MULT", 1e30)
    no_skip = estep_cuda.estep_cuda(*args)
    for k in ESTEP_KEYS:
        assert _scaled(no_skip[k], with_skip[k]) < 1e-6, k
    monkeypatch.setattr(estep_cuda, "_SKIP_MULT", 0.0)
    all_skip = estep_cuda.estep_cuda(*args)
    torch.cuda.synchronize()
    assert float(all_skip["K_NA"].abs().max()) == 0.0 and float(all_skip["K_NB"].abs().max()) == 0.0


def test_estep_kernels_are_deterministic(cuda):
    """No float atomics: two runs give identical bits."""
    args = _estep_args(20000, 2000, cuda, seed=2)
    a, b = estep_cuda.estep_cuda(*args), estep_cuda.estep_cuda(*args)
    for k in ESTEP_KEYS:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("G", [18, 50, 100])
@pytest.mark.parametrize("NA,B", [(1000, 333), (20000, 2000)])
def test_rowred_kernel_matches_plain(cuda, NA, B, G):
    """`rowred` against `rowred_reference` at G1 = 19, 51 (the row tile
    resident) and 101 features (the fat chunks in the ring), B not a
    multiple of 64 and 2000 (split over columns at 20k rows): every row sum
    within 1e-4 of its scale; one counted launch; the same bits twice."""
    args = _estep_args(NA, B, cuda, G=G, seed=G)
    xa, cb, fat, fbt, bt, mm, scal, skip = estep_cuda.prepare(*args[:1], *args[2:])
    assert fat.shape[0] == G + 1
    col = estep_cuda.colnorm_reference(xa, cb, fat, fbt, bt, mm, scal)
    before = estep_cuda.rowred.launches
    out = estep_cuda.rowred(xa, cb, fat, fbt, bt, col, scal, skip)
    torch.cuda.synchronize()
    assert estep_cuda.rowred.launches == before + 1
    ref = estep_cuda.rowred_reference(xa, cb, fat, fbt, bt, col, scal)
    for q in range(6):
        assert _scaled(ref[q], out[q]) < 1e-4, (q, _scaled(ref[q], out[q]))
    assert torch.equal(estep_cuda.rowred(xa, cb, fat, fbt, bt, col, scal, skip), out)


@pytest.mark.parametrize("G", [18, 50, 100])
@pytest.mark.parametrize("NA,B", [(1000, 333), (20000, 2000)])
def test_colnorm_kernel_matches_plain(cuda, NA, B, G):
    """`colnorm` against `colnorm_reference` at G1 = 19, 51 (the column tile
    resident) and 101 features (the fbt chunks in the ring), B not a
    multiple of 64 and 2000 (live row tiles dealt over splits): every column
    output within 1e-4 of its scale; one counted launch; the same bits
    twice."""
    args = _estep_args(NA, B, cuda, G=G, seed=G + 1)
    xa, cb, fat, fbt, bt, mm, scal, skip = estep_cuda.prepare(*args[:1], *args[2:])
    assert fat.shape[0] == G + 1
    before = estep_cuda.colnorm.launches
    out = estep_cuda.colnorm(xa, cb, fat, fbt, bt, mm, scal, skip)
    torch.cuda.synchronize()
    assert estep_cuda.colnorm.launches == before + 1
    ref = estep_cuda.colnorm_reference(xa, cb, fat, fbt, bt, mm, scal)
    for q in range(5):
        assert _scaled(ref[q], out[q]) < 1e-4, (q, _scaled(ref[q], out[q]))
    assert torch.equal(estep_cuda.colnorm(xa, cb, fat, fbt, bt, mm, scal, skip), out)


def test_colnorm_morton_splits_stay_balanced(cuda):
    """Morton-ordered rows at the solver's sigma2 floor, where the live row
    tiles of a column tile form a narrow band: the splits of each column
    tile get the same number of live tiles to within one, and the kernel
    stays within 2e-3 of scale of the plain sweep (the bar of
    `test_estep_kernels_match_plain` at sigma2 1e-3), the same bits twice."""
    NA, B = 60000, 6000
    args = _estep_args(NA, B, cuda, sigma2=1e-3, morton=True, seed=5)
    xa, cb, fat, fbt, bt, mm, scal, skip = estep_cuda.prepare(*args[:1], *args[2:])
    splits = estep_cuda.colnorm_splits(NA, B)
    assert splits > 1
    for per_split in estep_cuda.colnorm_assignment(skip, NA, B, splits):
        counts = [len(t) for t in per_split]
        assert max(counts) - min(counts) <= 1
    out = estep_cuda.colnorm(xa, cb, fat, fbt, bt, mm, scal, skip)
    ref = estep_cuda.colnorm_reference(xa, cb, fat, fbt, bt, mm, scal)
    for q in range(5):
        assert _scaled(ref[q], out[q]) < 2e-3, (q, _scaled(ref[q], out[q]))
    assert torch.equal(estep_cuda.colnorm(xa, cb, fat, fbt, bt, mm, scal, skip), out)


def test_estep_kernels_reject_bad_inputs(cuda):
    args = _estep_args(200, 70, cuda)
    xa, cb = args[0], args[2]
    fat = torch.cat([args[5].T, args[3][None]]).contiguous()
    fbt = torch.cat([args[6].T, torch.ones((1, 70), device=cuda)]).contiguous()
    scal = torch.zeros(8, device=cuda)
    skip = estep_cuda.tile_skip_mask(xa, cb, args[8])
    with pytest.raises(ValueError):
        estep_cuda.colnorm(xa, cb, fat[:, :100], fbt, args[4], args[7], scal, skip)
    with pytest.raises(TypeError):
        estep_cuda.colnorm(xa.double(), cb, fat, fbt, args[4], args[7], scal, skip)
    with pytest.raises(ValueError):
        estep_cuda.rowred(xa, cb.cpu(), fat, fbt, args[4], torch.zeros((5, 70), device=cuda), scal, skip)


def test_morpho_pairwise_cuda_matches_cpu(cuda):
    """One 1,500-cell pair solved on the card (E-step kernels) and on the
    CPU (dense plain E-step), same seed: rotations within 1e-3, aligned
    coordinates within 1e-2 on a 10-unit box."""
    import pandas as pd
    import spateo_tpu_torch as stt

    rng = np.random.default_rng(6)
    n = 1500
    pts = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    X = rng.poisson(2.0, (n, 50)).astype(np.float32)
    th = 0.3
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    ptsA = pts @ R.T + np.array([1.5, -0.8], np.float32)

    def mk(p):
        a = stt.AnnData(X=X.copy(), obs=pd.DataFrame(index=[f"c{i}" for i in range(n)]),
                        var=pd.DataFrame(index=[f"g{j}" for j in range(50)]))
        a.obsm["spatial"] = p.copy()
        return a

    before = estep_cuda.rowred.launches
    out_g, _ = stt.align.morpho_align([mk(pts), mk(ptsA)], spatial_key="spatial", key_added="align", max_iter=100,
                                      verbose=False, device="cuda")
    assert estep_cuda.rowred.launches == before + 100
    out_c, _ = stt.align.morpho_align([mk(pts), mk(ptsA)], spatial_key="spatial", key_added="align", max_iter=100,
                                      verbose=False, device="cpu")
    vg, vc = out_g[1].uns["VecFld_morpho"], out_c[1].uns["VecFld_morpho"]
    np.testing.assert_allclose(vg["optimal_R"], vc["optimal_R"], atol=1e-3)
    np.testing.assert_allclose(out_g[1].obsm["align"], out_c[1].obsm["align"], atol=1e-2)
    assert np.sqrt(((out_g[1].obsm["align"] - pts) ** 2).sum(1).mean()) < 0.1


def _inlier_args(n, N, device, seed=0):
    """The case of tests/test_ops.py:307 at n valid of N rows: a rotation of
    0.4 rad and a shift, a third of the matches outliers, row-0 padding."""
    rng = np.random.default_rng(seed)
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    tx = rng.uniform(0, 5, (N, 2)).astype(np.float32)
    ty = (tx @ R.T + np.array([1.0, -2.0], np.float32)).astype(np.float32)
    ty[: n // 3] += rng.normal(0, 2.0, (n // 3, 2)).astype(np.float32)
    dist = rng.uniform(0, 3, (N, 1)).astype(np.float32)
    tx[n:], ty[n:], dist[n:] = tx[0], ty[0], dist[0]
    mask = np.zeros((N, 1), np.float32)
    mask[:n] = 1.0
    T = lambda x: torch.from_numpy(x).to(device)
    return (T(tx), T(ty), T(dist), T(mask), float(n)), R


@pytest.mark.parametrize("n,N", [(30, 33), (1900, 2048), (20000, 20480), (190000, 200000)])
@pytest.mark.parametrize("flip", [False, True])
def test_inlier_kernel_matches_plain(cuda, n, N, flip):
    """The one-launch fit against `inlier_reference` on the card, at the
    bars tests/test_ops.py:319-324 hold the TPU kernel to: R atol 2e-5, t
    2e-4, P 1e-3, weight0 1e-5, sigma2 and gamma 1e-3; the planted rotation
    is recovered; two runs give the same bits. 200,000 rows are more than
    the cluster keeps on chip; `flip` is the mirrored input
    `_coarse_match_fit` fits under `allow_flip`."""
    args, R_true = _inlier_args(n, N, cuda)
    if flip:
        mirror = torch.tensor([1.0, -1.0], device=cuda)
        args = ((args[0] * mirror).contiguous(), *args[1:])
    before = inlier_cuda.inlier_fit.launches
    P, R, t, w, s2, g = inlier_cuda.inlier_fit(*args)
    torch.cuda.synchronize()
    assert inlier_cuda.inlier_fit.launches == before + 1
    Pr, Rr, tr, wr, s2r, gr = inlier_cuda.inlier_reference(*args)
    torch.testing.assert_close(R, Rr, atol=2e-5, rtol=0)
    torch.testing.assert_close(t, tr, atol=2e-4, rtol=0)
    torch.testing.assert_close(P, Pr, atol=1e-3, rtol=0)
    torch.testing.assert_close(w, wr, atol=1e-5, rtol=0)
    assert abs(float(s2) - float(s2r)) < 1e-3 * max(float(s2r), 1e-3)
    assert abs(float(g) - float(gr)) < 1e-3
    if not flip and n >= 1900:
        np.testing.assert_allclose(R.cpu().numpy(), R_true, atol=0.05)
    again = inlier_cuda.inlier_fit(*args)
    assert torch.equal(again[0], P) and torch.equal(again[1], R)


def test_inlier_kernel_one_row(cuda):
    """N = 1: one row on one rank, the other ranks empty. The fit is
    degenerate (no extent, so the plain loop's posterior and rotation are
    NaN): one counted launch, weight0 as the plain's, P and R NaN where
    the plain's are, the same bits twice."""
    args, _ = _inlier_args(1, 1, cuda)
    before = inlier_cuda.inlier_fit.launches
    P, R, t, w, s2, g = inlier_cuda.inlier_fit(*args)
    torch.cuda.synchronize()
    assert inlier_cuda.inlier_fit.launches == before + 1
    Pr, Rr, _, wr, _, _ = inlier_cuda.inlier_reference(*args)
    torch.testing.assert_close(w, wr, atol=1e-5, rtol=0)
    assert torch.equal(torch.isnan(P), torch.isnan(Pr)) and torch.equal(torch.isnan(R), torch.isnan(Rr))
    again = inlier_cuda.inlier_fit(*args)
    torch.testing.assert_close(again[0], P, atol=0, rtol=0, equal_nan=True)


def _jacobi_case(H, W, device, seed=0):
    """A random field in [0, 100) and the solver's moving set: the interior
    window minus 1% scattered Dirichlet pixels."""
    rng = np.random.default_rng(seed)
    f = torch.from_numpy(rng.uniform(0, 100, (H, W)).astype(np.float32)).to(device)
    upd = torch.zeros((H, W), dtype=torch.uint8, device=device)
    upd[1:-1, 1:-1] = 1
    upd[torch.from_numpy(rng.uniform(size=(H, W)) < 0.01).to(device)] = 0
    return f, upd


@pytest.mark.parametrize("shape", [(1, 1), (2, 5), (3, 3), (7, 33), (130, 257), (1000, 1500), (229, 333)])
def test_jacobi_block_kernel_matches_plain(cuda, shape):
    """Kernel vs `jacobi_block_reference` on ragged shapes (229 x 333: no
    side a multiple of the tile or of a warp's 128 columns) for 1, T - 1,
    T, T + 1, 2T + 3 and 100 sweeps: the same bits (both round each add and
    the 0.25 multiply the same way); ceil(n / T) counted launches; the input
    untouched."""
    f, upd = _jacobi_case(*shape, cuda)
    f_before = f.clone()
    T = jacobi_cuda.sweeps_per_launch()
    for n in (1, T - 1, T, T + 1, 2 * T + 3, 100):
        before = jacobi_cuda.jacobi_block.launches
        out = jacobi_cuda.jacobi_block(f, upd, n)
        torch.cuda.synchronize()
        assert jacobi_cuda.jacobi_block.launches == before + -(-n // T)
        assert torch.equal(out, jacobi_cuda.jacobi_block_reference(f, upd, n)), n
    assert torch.equal(f, f_before)


@pytest.mark.parametrize("shape,n", [((130, 257), 1), ((229, 333), 40), ((1024, 1024), 100)])
def test_jacobi_block_fused_err_matches_plain(cuda, shape, n):
    """The relative change the last launch sums in f64 (and the small kernel
    adds in a fixed order) against `rel_change_reference` in f32 on the same
    block, under a non-uniform weight: rtol 1e-5 (the two sum in other
    orders and precisions); the field is the one without a weight; one
    counted reduction launch; the same bits twice."""
    f, upd = _jacobi_case(*shape, cuda, seed=7)
    weight = torch.rand(shape, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = (jacobi_cuda.jacobi_block.launches, jacobi_cuda.jacobi_block.err_launches)
    out, err = jacobi_cuda.jacobi_block(f, upd, n, weight=weight)
    torch.cuda.synchronize()
    T = jacobi_cuda.sweeps_per_launch()
    assert (jacobi_cuda.jacobi_block.launches, jacobi_cuda.jacobi_block.err_launches) == (
        before[0] + -(-n // T), before[1] + 1)
    assert torch.equal(out, jacobi_cuda.jacobi_block(f, upd, n))
    want = jacobi_cuda.rel_change_reference(out, f, weight)
    assert err.shape == () and err.dtype == torch.float32
    torch.testing.assert_close(err, want, rtol=1e-5, atol=0)
    assert torch.equal(jacobi_cuda.jacobi_block(f, upd, n, weight=weight)[1], err)


def test_jacobi_block_rejects_bad_inputs(cuda):
    f, upd = _jacobi_case(16, 16, cuda)
    with pytest.raises(TypeError):
        jacobi_cuda.jacobi_block(f.double(), upd, 1)
    with pytest.raises(TypeError):
        jacobi_cuda.jacobi_block(f, upd.float(), 1)
    with pytest.raises(ValueError):
        jacobi_cuda.jacobi_block(f, upd[:, :8], 1)
    with pytest.raises(ValueError):
        jacobi_cuda.jacobi_block(f, upd.cpu(), 1)
    with pytest.raises(ValueError):
        jacobi_cuda.jacobi_block(f.t(), upd, 1)


def test_jacobi_solve_cuda_matches_cpu(cuda):
    """A masked 96x160 solve with Dirichlet isolines on the card (kernel) and
    on the CPU (plain): the same iteration count and the same field."""
    H, W = 96, 160
    field = np.zeros((H, W), np.float32)
    border = np.zeros((H, W), bool)
    mask = np.zeros((H, W), np.float32)
    mask[4:-4, 4:-4] = 1
    field[4, 4:-4], field[-5, 4:-4] = 1.0, 100.0
    border[4, 4:-4] = border[-5, 4:-4] = True
    before = jacobi_cuda.jacobi_block.launches
    fg, itg, _ = stencil.jacobi_solve(field, border, mask, max_err=1e-7, max_itr=20_000, device="cuda")
    assert jacobi_cuda.jacobi_block.launches > before
    fc, itc, _ = stencil.jacobi_solve(field, border, mask, max_err=1e-7, max_itr=20_000, device="cpu")
    assert itg == itc
    np.testing.assert_array_equal(fg, fc)


def test_label_cells_from_mask_cuda_matches_cpu(cuda):
    """The labeling chain on a disk raster on the card and on the CPU: equal
    labels and centroids."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:256, :256]
    mask = np.zeros((256, 256), bool)
    for cy, cx, r in zip(rng.uniform(8, 248, 120), rng.uniform(8, 248, 120), rng.uniform(3, 7, 120)):
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    lg, cg = labels.label_cells_from_mask(mask, 3, device="cuda")
    lc, cc = labels.label_cells_from_mask(mask, 3, device="cpu")
    np.testing.assert_array_equal(lg.cpu().numpy(), lc.numpy())
    np.testing.assert_array_equal(cg, cc)


def _rotation_fields(N, F, seed):
    rng = np.random.default_rng(seed)
    Xs = rng.uniform(-1, 1, (F, N, 3)).astype(np.float32)
    Vs = np.cross(np.broadcast_to([0.0, 0.0, 1.0], Xs.shape), Xs).astype(np.float32)
    return Xs, (Vs + rng.normal(0, 0.05, Vs.shape)).astype(np.float32)


def test_tf32_stays_off(cuda):
    """SparseVFC's kernel products take f32 (`precision="highest"` in the JAX
    package); the port sets no global flag, so the defaults must hold."""
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32


def test_sparsevfc_batch_cuda_matches_cpu(cuda):
    """`SparseVFC_batch` on 3 x 5,000 points (5 row chunks) on the card and on
    the CPU: V within 1e-3 of max|V|, div/curl within 1e-2, equal iterations
    (pinned at 60, and stopped by the energy at ecr 1e-3), and
    `GPVectorField` Jacobians within 1e-4 of scale."""
    import spateo_tpu_torch as stt
    from spateo_tpu_torch.ops import vfc
    from spateo_tpu_torch.tdr.morphometrics.morphofield_dg.GPVectorField import GPVectorField

    Xs, Vs = _rotation_fields(5000, 3, seed=4)
    for kw in (dict(MaxIter=60, ecr=0.0), dict(MaxIter=200, ecr=1e-3)):
        res = {d: vfc.SparseVFC_batch(Xs, Vs, M=100, seed=1, device=d, **kw) for d in ("cuda", "cpu")}
        for f, (g, c) in enumerate(zip(res["cuda"], res["cpu"])):
            v_err = float(np.abs(g["V"] - c["V"]).max() / np.abs(c["V"]).max())
            dc_err = max(float(np.abs(g[k] - c[k]).max()) for k in ("div", "curl"))
            msg = f"{kw} field {f}: iterations {g['iteration']}/{c['iteration']}, V {v_err}, div/curl {dc_err}"
            print(msg)
            assert g["iteration"] == c["iteration"] and v_err <= 1e-3 and dc_err <= 1e-2, msg
            assert g["_device"]["C"].is_cuda
    a = stt.AnnData(X=np.ones((5000, 1), np.float32))
    a.uns["VecFld_morpho"] = {k: v for k, v in res["cpu"][0].items() if k != "_device"}
    J = {}
    for d in ("cuda", "cpu"):
        gv = GPVectorField(device=d)
        gv.from_adata(a, vf_key="VecFld_morpho")
        J[d] = gv.get_Jacobian("analytical")(Xs[0][:500])
    assert np.abs(J["cuda"] - J["cpu"]).max() <= 1e-4 * np.abs(J["cpu"]).max()


def test_sparsevfc_em_host_reads(cuda):
    """The EM reads the card once per block of CHECK_EVERY iterations (and
    once for the factorisations' status), never once per iteration."""
    from spateo_tpu_torch.ops import vfc

    Xs, Vs = _rotation_fields(5000, 2, seed=5)
    before = vfc._run_em.host_reads
    vfc.SparseVFC_batch(Xs, Vs, M=100, MaxIter=60, ecr=0.0, seed=0, device="cuda")
    assert vfc._run_em.host_reads - before == -(-60 // vfc.CHECK_EVERY)


def test_sparsevfc_em_cholesky_failure_raises(cuda):
    """A non-SPD M-step system (NaN features) raises after the loop: the
    factorisation's status is read once, not per iteration."""
    from spateo_tpu_torch.ops import vfc

    K = torch.full((1, 64, 8), float("nan"), device="cuda")
    U = torch.eye(8, device="cuda")[None]
    Y = torch.ones((1, 64, 3), device="cuda")
    one = torch.ones(1, device="cuda")
    with pytest.raises(torch.linalg.LinAlgError):
        vfc._run_em(K, U, Y, one, 3.0, 0.9, 5.0, 0.0, 1e-5, 12, False, one)


def test_music_tf32_stays_off(cuda):
    """MuSIC's distance dot takes `precision="highest"` in the JAX package and
    `wt @ F` sums n products an entry: the port's products must stay f32."""
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("distr", ["gaussian", "poisson", "nb"])
def test_music_iwls_batch_full_cuda_matches_cpu(cuda, distr):
    """`iwls_batch_full` at 2,000 cells, k = 12, on the card and on the CPU:
    betas, hats, inv_diag and preds within 1e-4 of scale; a CUDA weight
    tensor stays on the card."""
    from spateo_tpu_torch.tools.CCI_effects_modeling import regression_utils as ru

    rng = np.random.default_rng(15)
    n, k = 2000, 12
    coords = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    X = rng.normal(0, 0.3, (n, k)).astype(np.float32)
    X[:, 0] = 1.0
    y = rng.poisson(np.exp(np.clip(X @ rng.normal(0, 0.4, k), -4, 4))).astype(np.float32)
    W = np.exp(-((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1) / (2 * 8.0**2)).astype(np.float32)
    kw = dict(distr=distr, ridge_lambda=0.3, clip=5.0)
    g = ru.iwls_batch_full(y, X, torch.from_numpy(W).to(cuda), device="cpu", **kw)
    c = ru.iwls_batch_full(y, X, W, device="cpu", **kw)
    for a, b in zip(g, c):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("fixed,bw", [(True, 8.0), (False, 25)])
def test_music_conditioned_weights_cuda_matches_cpu(cuda, fixed, bw, exclude_self):
    """The conditioned weights on 2,000 points: within 2e-3 absolute, support
    flips at most 1e-4 of the nonzeros."""
    from spateo_tpu_torch.tools import find_neighbors as fn

    rng = np.random.default_rng(16)
    n = 2000
    coords = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    ct = rng.integers(1, 4, n).astype(np.int32)
    cond = rng.random(n) < 0.4
    W = {}
    for d in ("cuda", "cpu"):
        c, ctd = torch.from_numpy(coords).to(d), torch.from_numpy(ct).to(d)
        W[d] = fn._conditioned_kernel_weights_batch(
            c, c, bw, ctd, ctd, torch.from_numpy(cond).to(d), fixed=fixed, exclude_self=exclude_self,
            self_idx=torch.arange(n, device=d),
        )
    assert W["cuda"].is_cuda
    g, c = W["cuda"].cpu().numpy(), W["cpu"].numpy()
    assert np.abs(g - c).max() <= 2e-3
    assert ((g > 0) != (c > 0)).sum() <= 1e-4 * (c > 0).sum()


def test_music_moran_i_cuda_matches_cpu(cuda):
    """`moran_i` on 2,000 cells x 20 genes, 199 permutations: I within 1e-5,
    p-values equal except where a permuted I lies within 1e-5 of the
    observed one."""
    import pandas as pd

    import spateo_tpu_torch as stt
    from spateo_tpu_torch.tools import spatial_degs as sd

    rng = np.random.default_rng(17)
    n, G = 2000, 20
    coords = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    expr = rng.poisson(np.exp(np.sin(coords[:, :1] / 15.0 * np.arange(1, G + 1)[None, :] / 4))).astype(np.float32)
    a = stt.AnnData(X=expr, obs=pd.DataFrame(index=[f"c{i}" for i in range(n)]))
    a.obsm["spatial"] = coords
    r = {d: sd.moran_i(a, permutations=199, seed=3, device=d) for d in ("cuda", "cpu")}
    assert np.abs(r["cuda"]["moran_i"].values - r["cpu"]["moran_i"].values).max() <= 1e-5
    differ = r["cuda"]["moran_p_val"].values != r["cpu"]["moran_p_val"].values
    if differ.any():
        rng_p = np.random.default_rng(3)
        perm = torch.from_numpy(np.stack([rng_p.permutation(n) for _ in range(199)]))
        Z = torch.from_numpy(expr - expr.mean(0, keepdims=True))
        Wm = torch.from_numpy(sd._spatial_weights(coords.astype(float), 5).astype(np.float32))
        I_obs, I_perm = sd._moran_replicates(Z, Wm, perm)
        assert bool(((I_perm[:, differ] - I_obs[differ][None, :]).abs().min(0).values <= 1e-5).all())


def test_music_fit_cuda_matches_cpu(cuda, tmp_path):
    """One `MuSIC.fit` (lr model, 250 cells, bw 10 neighbours, poisson) on
    the card and on the CPU: coefficients within `chip_smoke.MUSIC_FIT_BAR`
    of scale; the weights of `mpi_fit` stay on the card."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    import chip_smoke

    adata, _ = chip_smoke.music_slice(250, seed=11, n_targets=1)
    fits = {}
    for d in ("cuda", "cpu"):
        model, coeffs, _, _, _, _ = chip_smoke.music_fit(adata, tmp_path / d, device=d, fixed_bw=10, search=(),
                                                         distr="poisson")
        fits[d] = coeffs["TGT1"].values
        if d == "cuda":
            assert model._conditioned_weights(model.targets_expr["TGT1"].values, 10, np.arange(4)).is_cuda
    assert np.abs(fits["cuda"] - fits["cpu"]).max() <= chip_smoke.MUSIC_FIT_BAR * np.abs(fits["cpu"]).max()


def _binned(n=192, seed=0):
    """A raster with two tissue depths, two density bins, a band outside
    both, and a certain mask."""
    rng = np.random.default_rng(seed)
    X = rng.negative_binomial(1, 0.5, (n, n)).astype(np.float32)
    X[:, n // 2 :] += rng.negative_binomial(1, 0.5, (n, n - n // 2))
    yy, xx = np.mgrid[:n, :n]
    for _ in range(n * n // 400):
        cy, cx, r = rng.integers(0, n), rng.integers(0, n), rng.integers(3, 7)
        m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        X[m] += rng.negative_binomial(8, 0.35, int(m.sum()))
    bins = np.ones((n, n), np.int64)
    bins[:, n // 2 :] = 2
    bins[:10] = 0
    certain = np.zeros((n, n), bool)
    certain[50:54, 60:64] = True
    return X, bins, certain


def test_staged_em_bp_cuda_matches_cpu(cuda):
    """The staged EM+BP with bins and a certain mask: the card (bp_step in
    f32, checked every iteration, counted) against the CPU (the generic
    loop): scores within 1e-3, Otsu masks with IoU >= 0.999."""
    from spateo_tpu_torch.ops.threshold import threshold_otsu
    from spateo_tpu_torch.segmentation import icell
    from spateo_tpu_torch.segmentation.utils import _apply_threshold

    X, bins, certain = _binned()
    kw = dict(em_kwargs=dict(seed=0, downsample=5000), certain_mask=certain, bins=bins)
    bp_cuda.bp_step.launches = bp_cuda.bp_step.delta_launches = 0
    s_gpu = icell._score_pixels(X, 5, "EM+BP", device="cuda", **kw)
    assert 0 < bp_cuda.bp_step.launches == bp_cuda.bp_step.delta_launches <= 100
    s_cpu = icell._score_pixels(X, 5, "EM+BP", device="cpu", **kw)
    torch.testing.assert_close(s_gpu.cpu(), s_cpu, atol=1e-3, rtol=0)
    m_gpu = _apply_threshold(s_gpu, 7, threshold_otsu(s_gpu)).cpu().numpy()
    m_cpu = _apply_threshold(s_cpu, 7, threshold_otsu(s_cpu)).numpy()
    assert np.logical_and(m_gpu, m_cpu).sum() / max(np.logical_or(m_gpu, m_cpu).sum(), 1) >= 0.999


def test_bp_kernel_on_binned_phi_matches_plain(cuda):
    """bp_kernel on a binned phi (exactly (1, 0) outside the bins), f32,
    checked every iteration: the same iterations and the same bits as the
    plain loop on the CPU."""
    from spateo_tpu_torch.ops.image import conv2d
    from spateo_tpu_torch.segmentation import icell

    X, bins, _ = _binned()
    res = conv2d(X, 5, bins=bins, device="cpu")
    fit = em.run_em(res.numpy(), bins=bins, params=icell._initial_nb_params(res, bins), seed=0,
                    downsample=5000, device="cpu")
    bg, cell = em.conditionals(res, fit, torch.as_tensor(bins))
    phi = torch.stack([bg, cell], dim=-1)
    phi = phi / torch.clamp_min(phi.sum(-1, keepdim=True), 1e-30)
    assert bool((phi[:10] == torch.tensor([1.0, 0.0])).all())
    st_gpu, st_cpu = {}, {}
    out = bp_cuda.bp_kernel(phi.to(cuda), 0.6, 0.4, 1e-6, 100, check_every=1, stats=st_gpu)
    ref = bp_cuda.bp_kernel(phi, 0.6, 0.4, 1e-6, 100, check_every=1, stats=st_cpu)
    assert st_gpu["n_iter"] == st_cpu["n_iter"]
    assert torch.equal(out.cpu(), ref)


def test_stream_em_batch_matches_per_tile_on_card(cuda):
    """`starro_em_bp_stream(em_batch=4)` on the card yields exactly what the
    per-tile stream yields, across a shape change."""
    rng = np.random.default_rng(1)
    tiles = [rng.negative_binomial(1, 0.5, (256, 256)).astype(np.float32) for _ in range(5)]
    for t in tiles:
        t[40:90, 60:120] += rng.negative_binomial(8, 0.35, (50, 60))
    tiles[3] = tiles[3][:200]
    kw = dict(k=5, seed=0, bp_max_iter=30, mask_only=True, device="cuda")
    one = list(starro.starro_em_bp_stream(tiles, em_batch=1, **kw))
    four = list(starro.starro_em_bp_stream(tiles, em_batch=4, **kw))
    assert len(one) == len(four) == 5
    for (s1, m1), (s4, m4) in zip(one, four):
        np.testing.assert_array_equal(m1, m4)
        assert torch.equal(s1, s4)


def test_safe_erode_and_labels_cuda_match_cpu(cuda):
    """safe_erode's bools and label_connected_components' labels: equal on
    the card and on the CPU."""
    from spateo_tpu_torch.segmentation.label import _label_connected_components
    from spateo_tpu_torch.segmentation.utils import safe_erode

    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[:160, :160]
    m = np.zeros((160, 160), bool)
    for _ in range(30):
        cy, cx, r = rng.integers(0, 160), rng.integers(0, 160), rng.integers(4, 14)
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    np.testing.assert_array_equal(safe_erode(m, 3, min_area=30, device="cuda"), safe_erode(m, 3, min_area=30, device="cpu"))
    np.testing.assert_array_equal(_label_connected_components(m, 300, min_area=30, device="cuda"),
                                  _label_connected_components(m, 300, min_area=30, device="cpu"))


def _scan_inputs(N=300, G=120, seed=0, zero_bins=0):
    from scipy.spatial.distance import cdist

    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 5000, (N, 2))
    M = cdist(x, x).astype(np.float32)
    A = rng.dirichlet(np.ones(N) * 0.5, G).astype(np.float32)
    b = rng.dirichlet(np.ones(N)).astype(np.float32)
    b[:zero_bins] = 0
    return A, (b / b.sum()).astype(np.float32), M


@pytest.mark.parametrize("zero_bins,sweeps", [(0, None), (4, 20)])
def test_svg_scan_cuda_matches_cpu(cuda, zero_bins, sweeps):
    """The batched Sinkhorn (`_sinkhorn_batch_run`) on the card and on the
    CPU: scores within 1e-4 relative, the same sweeps (20 with zero target
    bins: the NaN stop), and `cal_wass_dis_batch` over ragged chunks."""
    from spateo_tpu_torch.svg import utils as tsu

    A, b, M = _scan_inputs(zero_bins=zero_bins)
    eps = float(M.max() * 5e-3)
    (dg, itg), (dc, itc) = (tsu._sinkhorn_batch_run(*[torch.from_numpy(x).to(d) for x in (A, b, M)], eps, 200)
                            for d in ("cuda", "cpu"))
    assert itg == itc and (sweeps is None or itg == sweeps)
    assert float((dg.cpu() - dc).abs().max() / dc.abs().max()) <= 1e-4
    g = tsu.cal_wass_dis_batch(M, A[:21], b=b, chunk=8, device="cuda")
    c = tsu.cal_wass_dis_batch(M, A[:21], b=b, chunk=8, device="cpu")
    assert np.abs(g - c).max() <= 1e-4 * np.abs(c).max()


@pytest.mark.parametrize("alpha", [0.1, 1.0])
def test_fgw_cuda_matches_cpu(cuda, alpha):
    """Entropic (F)GW on the card and on the CPU (100 x 90 points, unit
    costs, 30 outer iterations): objectives within 1e-4 relative, the same
    outer iterations; FGW plans within 1e-4 of scale (GW plans move ~1e-4
    under one ulp of their inputs in float32, tests/test_torch_ot.py: 1e-3)."""
    from scipy.spatial.distance import cdist

    from spateo_tpu_torch.ops import ot

    rng = np.random.default_rng(0)
    x, y = rng.uniform(0, 1, (100, 2)), rng.uniform(0, 1, (90, 2))
    ins = [cdist(x, x), cdist(y, y), rng.dirichlet(np.ones(100) * 5), rng.dirichlet(np.ones(90) * 5)]
    M = rng.uniform(0, 1, (100, 90))
    eps = 5e-3 if alpha < 1 else float(ins[0].max()) * 1e-2
    out = {}
    for d in ("cuda", "cpu"):
        t = [torch.from_numpy(np.asarray(v, np.float32)).to(d) for v in (M, *ins)]
        T, obj, it = ot._fgw_entropic_run(*t, alpha, eps, 30, 100, 1e-8)
        out[d] = (T.cpu().numpy(), float(obj), it)
    assert out["cuda"][2] == out["cpu"][2]
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-4 * abs(out["cpu"][1])
    plan = np.abs(out["cuda"][0] - out["cpu"][0]).max() / np.abs(out["cpu"][0]).max()
    assert plan <= (1e-4 if alpha < 1 else 1e-3)


def test_sinkhorn_log_cuda_matches_cpu(cuda):
    from spateo_tpu_torch.ops import ot

    A, b, M = _scan_inputs(N=80, G=1)
    M = M / M.max()
    (Tg, itg), (Tc, itc) = (ot._sinkhorn_log_run(*[torch.from_numpy(x).to(d) for x in (A[0], b, M)], 1e-2, 1000,
                                                 1e-5) for d in ("cuda", "cpu"))
    assert itg == itc and float((Tg.cpu() - Tc).abs().max() / Tc.abs().max()) <= 1e-4


@pytest.mark.parametrize("outer,bar", [(1, 1e-4), (50, 2e-3)])
def test_paste_and_nmf_cuda_match_cpu(cuda, outer, bar):
    """A 500-cell PASTE pair (`chip_smoke.slice_pair`, phase 19's) on the
    card and on the CPU: after one outer iteration plan and objective within
    1e-4 (of scale, relative); after 50, as the plan sharpens, float32
    differences grow (the JAX package and the port's CPU path lie 6.8e-4
    apart there), so 2e-3; the same outer iterations. The center's KL NMF
    (float64): W @ H within 1e-6 relative, the same iterations."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    import spateo_tpu_torch as stt
    from spateo_tpu_torch.alignment.methods.paste import KLNMF

    A, B = chip_smoke.slice_pair(500, unit=0.05)
    out = {}
    for d in ("cuda", "cpu"):
        with chip_smoke.fgw_log(d) as log:
            pi, obj = stt.align.paste_pairwise_align(A, B, numItermax=outer, verbose=False, device=d)
        out[d] = (pi, obj, log.iterations[0])
    assert out["cuda"][2] == out["cpu"][2]
    assert np.abs(out["cuda"][0] - out["cpu"][0]).max() <= bar * np.abs(out["cpu"][0]).max()
    assert abs(out["cuda"][1] - out["cpu"][1]) <= bar * abs(out["cpu"][1])
    X = np.random.default_rng(1).gamma(0.5, 2.0, (300, 80))
    m = {d: KLNMF(15, 0, device=d) for d in ("cuda", "cpu")}
    WH = {d: k.fit_transform(X) @ k.components_ for d, k in m.items()}
    assert m["cuda"].n_iter_ == m["cpu"].n_iter_
    assert np.abs(WH["cuda"] - WH["cpu"]).max() <= 1e-6 * np.abs(WH["cpu"]).max()


def test_icp_batch_and_a_cost_table_cuda_match_cpu(cuda):
    """Mesh correction's batched ICP (60 ragged problems) and one [L, L]
    cost table of tests/test_mesh_correction.py:92's case on the card and on
    the CPU: gamma equal, R and t within 1e-10; the table equal but where an
    entry's ICP meets a degenerate cross-covariance (every inlier on one
    contour point: the rotation is then set by rounding noise), at most 1% of
    entries."""
    from scipy.spatial import ConvexHull

    import spateo_tpu_torch as stt
    from spateo_tpu_torch.alignment.methods import mesh_correction as mc

    rng = np.random.default_rng(0)
    c1, c2 = [], []
    for _ in range(60):
        n1, n2 = rng.integers(20, 200, 2)
        th = rng.uniform(0, 2 * np.pi, n1)
        c1.append(np.c_[np.cos(th), np.sin(th)] * rng.uniform(0.5, 2))
        th = rng.uniform(0, 2 * np.pi, n2)
        c2.append(np.c_[np.cos(th), 0.8 * np.sin(th)] + rng.normal(0, 0.1, 2))
    out = {d: [x.cpu().numpy() for x in mc._icp_batch(*mc._padded(c1, d), *mc._padded(c2, d), max_iter=10,
                                                        allow_rotation=True)] for d in ("cuda", "cpu")}
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    for k in (1, 3):
        np.testing.assert_allclose(out["cuda"][k], out["cpu"][k], rtol=0, atol=1e-10)
    sp = rng.normal(size=(400, 3))
    sp = sp / np.linalg.norm(sp, axis=1, keepdims=True) * np.array([1.0, 0.8, 0.6])
    mesh = stt.tdr.Mesh(sp, ConvexHull(sp).simplices)
    slices = []
    for z in np.linspace(-0.45, 0.45, 4):
        a = np.sqrt(max(1 - (z / 0.6) ** 2, 1e-6))
        th, rr = rng.uniform(0, 2 * np.pi, 400), np.sqrt(rng.uniform(0, 1, 400))
        ad = stt.AnnData(X=np.ones((400, 2), np.float32))
        stt.SKM.init_adata_type(ad, "UMI")
        ad.obsm["spatial"] = np.stack([a * rr * np.cos(th), 0.8 * a * rr * np.sin(th)], 1) + rng.uniform(-0.15, 0.15, 2)
        slices.append(ad)
    m = stt.align.Mesh_correction(slices, np.linspace(-0.45, 0.45, 4), mesh, label_num=5, max_rotation_angle=15,
                                  max_translation_scale=0.2, max_scaling=1.15, device="cpu")
    m.extract_contours(alpha_shape_kwargs={"alpha": 2.0})
    m.max_translation, m.best_transformation = 0.2 * m.slices_scale, {"rotation": np.zeros(3), "translation": 0.0,
                                                                      "scaling": 1.0}
    labels = m.generate_labels()
    tables = {d: mc._get_binary_values(m.contours, m.mesh_points, m.mesh_faces, m.z_heights, (0, 3), labels, d)
              for d in ("cuda", "cpu")}
    assert (tables["cuda"] != tables["cpu"]).sum() <= 0.01 * tables["cpu"].size


def test_kmeans_cuda_match_cpu(cuda):
    """`KMeans` and `MiniBatchKMeans` on the card and on the CPU: the draws are
    the host's, the centre sums atomics on the card, so labels and steps
    equal and centres within 1e-10 of the coordinates' scale."""
    from spateo_tpu_torch.ops.kmeans import KMeans, MiniBatchKMeans

    X = np.random.default_rng(0).uniform(0, 100, (5000, 2))
    for cls, kw in ((KMeans, dict(n_clusters=250, n_init=4)), (MiniBatchKMeans, dict(n_clusters=400, n_init=3))):
        g, c = (cls(random_state=0, device=d, **kw).fit(X) for d in ("cuda", "cpu"))
        np.testing.assert_array_equal(g.labels_, c.labels_)
        np.testing.assert_allclose(g.cluster_centers_, c.cluster_centers_, rtol=0, atol=1e-10 * 100)


def test_tmm_and_pca_cuda_match_cpu(cuda):
    """TMM factors (float64, masked ranks) within 1e-12, on continuous counts
    and on integer ones, where many genes tie (the logarithms are the host's,
    so the card ranks the same keys); the randomized PCA of a sparse matrix
    within 1e-8 of scale, up to column signs."""
    from scipy import sparse

    from spateo_tpu_torch.preprocessing.normalize import calcNormFactors
    from spateo_tpu_torch.tools.dimensionality_reduction import randomized_pca_centered

    rng = np.random.default_rng(0)
    counts = rng.gamma(2.0, 3.0, size=(500, 400)) * (rng.random((500, 400)) > 0.3)
    for c in (counts, rng.poisson(rng.gamma(0.5, 1.0, 300), (2000, 300)).astype(float)):
        f = {d: calcNormFactors(c, method="TMM", device=d) for d in ("cuda", "cpu")}
        np.testing.assert_allclose(f["cuda"], f["cpu"], rtol=0, atol=1e-12)
    X = sparse.random(800, 300, density=0.1, format="csr", random_state=1)
    p = {d: randomized_pca_centered(X, 20, device=d)[0] for d in ("cuda", "cpu")}
    s = np.sign((p["cuda"] * p["cpu"]).sum(0))
    assert np.abs(p["cuda"] * s - p["cpu"]).max() <= 1e-8 * np.abs(p["cpu"]).max()


def _ellipsoid_points(n, seed=0, axes=(1.0, 0.5, 1.6)):
    p = np.random.default_rng(seed).normal(size=(n, 3))
    return p / np.linalg.norm(p, axis=1, keepdims=True) * np.asarray(axes)


def test_poisson_solve_cuda_matches_cpu(cuda):
    """The screened-Poisson splat and CG at res 32 on 5,000 points, card
    against CPU: the splat gives equal bits on two card runs; rho and chi
    within 1e-5 of their scale, the CG iterations within 1; the meshes of
    `poisson_reconstruction` within a symmetric Chamfer distance of 1e-3 of
    a cell."""
    from scipy.spatial import cKDTree

    from spateo_tpu_torch.tdr.models.models_individual import reconstruction as R

    p = _ellipsoid_points(5000)
    normals = R.estimate_normals(p)
    res = 32
    cell = 1.1 * np.ptp(p, axis=0).max() / (res - 3)
    pts_g = (p - (p.min(0) + p.max(0)) / 2 + cell * (res - 1) / 2) / cell
    pg, nr = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (pts_g, normals))
    bits = R._splat_bits(len(p), 1.0)
    assert torch.equal(R._splat(pg, nr, res, bits), R._splat(pg, nr, res, bits))
    out, iters = {}, {}
    for d in ("cuda", "cpu"):
        chi, rho = R._splat_and_solve(pts_g, normals, res, 4.0, 1e-5, 8 * res, device=d)
        out[d], iters[d] = (chi.cpu().numpy(), rho.cpu().numpy()), R._splat_and_solve.last_iterations
    for g, c in zip(out["cuda"], out["cpu"]):
        assert np.abs(g - c).max() <= 1e-5 * np.abs(c).max()
    assert abs(iters["cuda"] - iters["cpu"]) <= 1
    m = {d: R.poisson_reconstruction(p, max_resolution=res, normals=normals, device=d) for d in ("cuda", "cpu")}
    ch = 0.5 * (cKDTree(m["cpu"].points).query(m["cuda"].points)[0].mean()
                + cKDTree(m["cuda"].points).query(m["cpu"].points)[0].mean())
    assert ch <= 1e-3 * cell


def test_elpigraph_cuda_matches_cpu(cuda):
    """ElPiGraph on 3,000 cells x 12 nodes, card against CPU: edges equal,
    nodes within 1e-9; one host read a growth step."""
    from spateo_tpu_torch.tdr.models.models_backbone import backbone_methods as B

    X = _ellipsoid_points(3000, seed=1) * np.random.default_rng(1).uniform(0.2, 1.0, (3000, 1))
    B.ElPiGraph_tree.host_reads = B.ElPiGraph_tree.steps = 0
    ng, eg = B.ElPiGraph_tree(X, NumNodes=12, device="cuda")
    assert B.ElPiGraph_tree.steps == 10 and B.ElPiGraph_tree.host_reads == 12
    nc, ec = B.ElPiGraph_tree(X, NumNodes=12, device="cpu")
    np.testing.assert_array_equal(eg, ec)
    assert np.abs(ng - nc).max() <= 1e-9


def test_pc_kde_cuda_matches_cpu(cuda):
    """The kernel density of 4,000 points, card against CPU, for a smooth and
    a compact kernel: 1e-10 relative."""
    from spateo_tpu_torch.tdr.morphometrics.morphology import kde_log_density

    X = _ellipsoid_points(4000, seed=2) * np.random.default_rng(2).uniform(0.5, 1.0, (4000, 1))
    for kernel in ("gaussian", "epanechnikov"):
        g, c = (np.exp(kde_log_density(X, kernel, 0.3, device=d)) for d in ("cuda", "cpu"))
        assert np.abs(g / c - 1).max() <= 1e-10


def _interp_pair(tmp, n=600):
    """`chip_smoke`'s 600-cell interpretation case: one CPU fit, an
    interpreter of its output directory on the card and one on the CPU."""
    import chip_smoke

    return chip_smoke.small_interpreters(tmp, {"cuda": "cuda", "cpu": "cpu"}, n=n)


def test_cci_deg_detection_cuda_matches_cpu(cuda, tmp_path):
    """The CCI DEG GLM of TGFB1 on the TFs (weights built on each device):
    the same TFs in the same order, coefficients and standard errors within
    1e-4 of scale; the downstream weights stay on the card."""
    it = _interp_pair(str(tmp_path))
    res = {}
    for d, interp in it.items():
        interp.CCI_deg_detection_setup(use_ligands=True, custom_tfs=["STAT3", "JUN", "MYC"])
        res[d] = interp.CCI_deg_detection("TGFB1", distr="poisson")
    assert it["cuda"]._cci_deg_weights[1].is_cuda
    assert list(res["cuda"].index) == list(res["cpu"].index)
    for col in ("coefficient", "se"):
        g, c = res["cuda"][col].values, res["cpu"][col].values
        assert np.abs(g - c).max() <= 1e-4 * np.abs(c).max()


def test_permutation_test_cuda_matches_cpu(cuda, tmp_path):
    """Ten permutations of TGT1 from one seed: the same scrambles, effects
    within 1e-4 of scale, p-values equal (the counts of permuted effects at
    or above the observed one; this case has no ties)."""
    import pandas as pd

    it = _interp_pair(str(tmp_path))
    out = {d: interp.permutation_test("TGT1", n_permutations=10, seed=1) for d, interp in it.items()}
    pd.testing.assert_frame_equal(it["cuda"]._perm_truth["TGT1"], it["cpu"]._perm_truth["TGT1"])
    g, c = out["cuda"]["mean_abs_effect"].values, out["cpu"]["mean_abs_effect"].values
    assert np.abs(g - c).max() <= 1e-4 * np.abs(c).max()
    np.testing.assert_array_equal(out["cuda"]["perm_pvalue"].values, out["cpu"]["perm_pvalue"].values)


def test_refine_alignment_cuda_matches_cpu(cuda):
    """The warps on a 256² raster given the same parameters (1e-5), and 100
    Adam epochs on smooth blobs: theta within 1e-2 (rotation and shear are
    nearly flat), the non-rigid displacements within 1e-5; the losses read
    once, after the loop."""
    from spateo_tpu_torch.segmentation import align as tal

    yy, xx = np.mgrid[0:256, 0:256].astype(float)
    rna = 10 * np.exp(-((yy - 128) ** 2 + (xx - 124) ** 2) / (2 * 28.0**2))
    stain = 200 * np.exp(-((yy - 138) ** 2 + (xx - 129) ** 2) / (2 * 28.0**2))
    img = torch.from_numpy((stain / stain.max()).astype(np.float32))
    theta = torch.tensor([[1.01, 0.02, 0.03], [-0.02, 0.99, -0.04]])
    g = tal._affine_warp(img.cuda(), theta.cuda()).cpu()
    assert (g - tal._affine_warp(img, theta)).abs().max() <= 1e-5
    for mode, kw, bar in (("rigid", {}, 1e-2), ("non-rigid", {"binsize": 64}, 1e-5)):
        p = {}
        for d in ("cuda", "cpu"):
            ref = tal.MODULES[mode](rna, stain, device=d, **kw)
            ref.train(100)
            assert len(ref.losses) == 100 and ref.losses[-1] < ref.losses[0]
            p[d] = ref.get_params()
        for k in p["cpu"]:
            assert np.abs(p["cuda"][k] - p["cpu"][k]).max() <= bar


def test_frobenius_nmf_cuda_matches_cpu(cuda):
    """The center's Frobenius NMF (15 components) of 300 x 200 counts, card
    against CPU: W and H within 1e-8 of scale, the same iterations."""
    from spateo_tpu_torch.alignment.methods.paste import FrobeniusNMF

    rng = np.random.default_rng(0)
    X = rng.poisson(rng.gamma(0.5, 2.0, (300, 200))).astype(float)
    m = {d: FrobeniusNMF(15, 0, device=d) for d in ("cuda", "cpu")}
    W = {d: mod.fit_transform(X) for d, mod in m.items()}
    assert m["cuda"].n_iter_ == m["cpu"].n_iter_
    assert np.abs(W["cuda"] - W["cpu"]).max() <= 1e-8 * np.abs(W["cpu"]).max()
    assert np.abs(m["cuda"].components_ - m["cpu"].components_).max() <= 1e-8 * np.abs(m["cpu"].components_).max()


# -- interpolation engines, clustering, UMAP, the two-group CCI test ------------------------------


def test_interp_cluster_cuda_matches_cpu(cuda):
    """Phase 27 of chip_smoke.py at 1,000 cells, TF32 off: the VTK fields
    (1e-5 of scale), the SGPR's first 10 Adam steps and its prediction, the
    SIREN's first 10 steps from one start and one set of batches (losses
    1e-4 relative), SpaGCN's length scale (1e-12) and GC-DEC's q (1e-4), the
    GMM's labels and iterations (equal) and means (1e-8), UMAP after 3
    epochs from one init and negatives (1e-3 of scale) and after all (15-NN
    preservation within 0.05), the CCI null scores (1e-5)."""
    import chip_smoke
    import spateo_tpu_torch as stt

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = chip_smoke.interp_cluster_cuda_vs_cpu(stt, n=1_000)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert all(v <= bar for v, bar in out.values()), out


def test_no_host_read_in_umap_sgpr_and_siren_loops(cuda):
    """The UMAP epochs, the SGPR's Adam steps and the SIREN's run with no
    host read: no synchronising call under `set_sync_debug_mode("error")`;
    the SGPR and SIREN fits read their losses once, UMAP its embedding once
    (their host-read counters)."""
    from spateo_tpu_torch.tdr.interpolations import interpolation_dl as idl
    from spateo_tpu_torch.tdr.interpolations import interpolation_gp as igp
    from spateo_tpu_torch.tools import dimensionality_reduction as dr

    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 3))
    Y = np.sin(X[:, :2])
    Xd, Yd = (torch.from_numpy(a).cuda() for a in (X, Y))
    params = igp.SGPRParams(X[:32], device="cuda")
    model = idl.SIREN([3, 32, 32, 2], device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    heads, tails = (torch.from_numpy(rng.integers(0, 500, 2000)).cuda() for _ in range(2))
    init = torch.from_numpy(rng.normal(size=(500, 2)).astype(np.float32)).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        igp.sgpr_train(params, Xd, Yd, n_epochs=5)
        idl.siren_train(model, Xd.float(), Yd.float(), 5, batch_size=128, generator=gen)
        dr.umap_layout(init, heads, tails, torch.ones(2000, device="cuda"), 1.58, 0.9, 5, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = igp._fit_sgpr.host_reads, idl._fit_siren.host_reads, dr.umap_conn_indices_dist_embedding.host_reads
    igp._fit_sgpr(X, Y, X[:32], n_epochs=5)
    idl._fit_siren(idl.SIREN([3, 32, 2], device="cuda"), X, Y, 5, 1e-3, 128, 0, "cuda")
    dr.umap_conn_indices_dist_embedding(X, n_neighbors=10, max_iter=5, return_mapper=False)
    after = igp._fit_sgpr.host_reads, idl._fit_siren.host_reads, dr.umap_conn_indices_dist_embedding.host_reads
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 1]


def test_neighbour_graphs_and_cci_cuda_match_cpu(cuda):
    """`knn` on the card against the CPU (indices equal, distances 1e-12 of
    scale, on untied points), the silhouette (1e-10) and the two-group CCI
    test on the card against the CPU (scores 1e-6 relative, p-values
    equal: no null score ties an observed one here)."""
    import pandas as pd

    import spateo_tpu_torch as stt
    from spateo_tpu_torch.tools.cluster.utils import ecp_silhouette
    from spateo_tpu_torch.tools.find_neighbors import knn

    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 30))
    (ig, dg), (ic, dc) = knn(X, 15, device="cuda"), knn(X, 15, device="cpu")
    np.testing.assert_array_equal(ig, ic)
    assert np.abs(dg - dc).max() <= 1e-12 * dc.max()
    lab = rng.integers(0, 5, 3000)
    assert abs(ecp_silhouette(X, lab, device="cuda") - ecp_silhouette(X, lab, device="cpu")) <= 1e-10
    c = rng.uniform(0, 20, (1500, 2))
    Xe = rng.poisson(0.5, (1500, 12)).astype(np.float32)
    Xe[:, 0] += (c[:, 0] < 10) * 2
    Xe[:, 1] += (c[:, 0] >= 10) * 2
    var = ["TGFB1", "TGFBR1_TGFBR2"] + [f"g{i}" for i in range(10)]
    res = {}
    for d in ("cuda", "cpu"):
        ad = stt.AnnData(X=Xe.copy(), obs=pd.DataFrame({"g": np.where(c[:, 0] < 10, "A", "B")},
                                                       index=[f"c{i}" for i in range(1500)]),
                         var=pd.DataFrame(index=var))
        ad.obsm["spatial"] = c
        res[d] = stt.tl.find_cci_two_group(ad, group="g", sender_group="A", receiver_group="B", num=200,
                                           pvalue=1.1, min_pairs_ratio=1e-5, device=d)["lr_pair"]
    g, h = res["cuda"], res["cpu"]
    assert np.abs(g["lr_score"].values - h["lr_score"].values).max() <= 1e-6 * np.abs(h["lr_score"].values).max()
    np.testing.assert_array_equal(g["lr_value"].values, h["lr_value"].values)


def test_external_cuda_matches_cpu(cuda):
    """Phase 29 of chip_smoke.py at 500 cells, TF32 off: CAST-Mark's,
    STAGATE's and merfishVI's first 10 Adam steps from one init and one set
    of draws, a CAST-Stack pair (affine 50 iterations, FFD 20, the FFD's
    mesh the same bits on a second run, cost flips at most 1%), and the
    projection (index flips at most 1%), at `chip_smoke.EXT_CVC_BAR`."""
    import chip_smoke
    import spateo_tpu_torch as stt

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = chip_smoke.external_cuda_vs_cpu(stt, n=500)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert all(v <= bar for v, bar in out.values()), out


def test_no_host_read_in_external_loops(cuda):
    """CAST-Mark's, STAGATE's and merfishVI's training loops and CAST-Stack's
    affine and FFD loops make no synchronising call
    (`set_sync_debug_mode("error")`)."""
    from spateo_tpu_torch.external import MERFISHVI
    from spateo_tpu_torch.external import cast as ec
    from spateo_tpu_torch.external import cast_stack as es
    from spateo_tpu_torch.external import merfishvi as em
    from spateo_tpu_torch.external import stagate as eg

    import spateo_tpu_torch as stt

    rng = np.random.default_rng(0)
    P = rng.uniform(0, 100, (300, 2))
    X = rng.poisson(2.0, (300, 20)).astype(np.float32)
    Xd = torch.from_numpy(X).cuda()
    A = ec._norm_adj(P, 10, "cuda")
    params = ec._init_params(0, 20, 16, 8, "cuda")
    mask = eg._adj_mask(P, None, 6, "cuda")
    st_init = eg.STAGATE(20, (16, 4), device="cuda").params
    ad = stt.AnnData(X=X)
    ad.obsm["spatial"] = P
    vi = MERFISHVI(ad, n_latent=4, n_hidden=8, spatial_encoder=True, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, r = (torch.from_numpy(rng.uniform(0, 100, (300, 2)).astype(np.float32)).cuda() for _ in range(2))
    cov = torch.rand((300, 300), device="cuda")
    ab = torch.tensor([1e-3, 1e-3, 1e-1, 1.0, 1.0], device="cuda")
    mx = torch.tensor([100.0, 100.0], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ec._train_cast(params, A, Xd, n_epochs=3, generator=gen)
        eg._train_stagate(st_init, mask, Xd, n_epochs=3)
        em._train_vae(vi.params, vi.X, vi.cov, vi.lib, vi.A, vi.batch_oh, vi.Y, vi.lib_pro, n_epochs=3,
                      spatial_mode="encoder", generator=gen)
        es._affine_gd(q, r, cov, 50.0, 0.0, ab, 2.0, 3, False)
        es._bspline_gd(q, r, cov, 50.0, 0.0, 10.0, 2.0, mx, 3, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
