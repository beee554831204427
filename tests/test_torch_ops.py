"""The port's ops held against the JAX package on the CPU.

The same inputs, made from a seed with numpy, go through `spateo_tpu.ops`
and `spateo_tpu_torch.ops`. The Pallas BP kernel runs in interpret mode, as
the JAX package's own tests run it. Tolerances are stated per test:
integer rasters, boolean masks and histogram counts must match exactly;
transcendental chains (lgamma, digamma, log) agree to the stated bound.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spateo_tpu.ops import bp as jbp
from spateo_tpu.ops import bp_pallas as jpal
from spateo_tpu.ops import em as jem
from spateo_tpu.ops import image as jimg
from spateo_tpu.ops import threshold as jthr
from spateo_tpu_torch.ops import _build
from spateo_tpu_torch.ops import bp as tbp
from spateo_tpu_torch.ops import bp_cuda as tcu
from spateo_tpu_torch.ops import em as tem
from spateo_tpu_torch.ops import image as timg
from spateo_tpu_torch.ops import threshold as tthr


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _mask_with_border(rng, shape, p):
    m = rng.uniform(size=shape) < p
    m[0, :] |= rng.uniform(size=shape[1]) < 0.5  # foreground on every border
    m[-1, :] |= rng.uniform(size=shape[1]) < 0.5
    m[:, 0] |= rng.uniform(size=shape[0]) < 0.5
    m[:, -1] |= rng.uniform(size=shape[0]) < 0.5
    return m


# -- image: exact ------------------------------------------------------------


@pytest.mark.parametrize("shape,r", [((7, 9), 1), ((12, 5), 2), ((16, 16), 3), ((4, 6), 0)])
def test_reflect_pad_matches_jax(shape, r):
    """Symmetric padding repeats the edge pixel (numpy 'symmetric'); exact."""
    X = np.random.default_rng(r).integers(0, 20, shape).astype(np.float32)
    ref = np.asarray(jimg._reflect_pad(jnp.asarray(X), r))
    out = timg._reflect_pad(_t(X), r).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("k,padding", [(3, "VALID"), (5, "VALID"), (7, "SAME"), (9, "SAME")])
def test_conv2d_rowsum_matches_jax(k, padding):
    """The prefix-sum circle convolution of an integer raster; exact."""
    rng = np.random.default_rng(k)
    X = rng.negative_binomial(1, 0.4, (37, 53)).astype(np.float32)
    rows = jimg._binary_row_runs(np.asarray(jimg.circle(k), np.float32))
    assert rows == timg._binary_row_runs(np.asarray(timg.circle(k), np.float32))
    r = (k - 1) // 2
    Xj = jimg._reflect_pad(jnp.asarray(X), r) if padding == "VALID" else jnp.asarray(X)
    Xt = timg._reflect_pad(_t(X), r) if padding == "VALID" else _t(X)
    ref = np.asarray(jimg._conv2d_rowsum(Xj, rows, k, k, padding))
    out = timg._conv2d_rowsum(Xt, rows, k, k, padding).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("k,square", [(3, False), (5, False), (7, False), (5, True)])
def test_morphology_matches_jax(k, square):
    """dilate / erode / mclose_mopen on random masks with foreground on the
    borders (cv2 border semantics); exact."""
    rng = np.random.default_rng(10 + k)
    m = _mask_with_border(rng, (31, 44), 0.3)
    for jfn, tfn in ((jimg.dilate, timg.dilate), (jimg.erode, timg.erode)):
        ref = np.asarray(jfn(jnp.asarray(m), k, square))
        np.testing.assert_array_equal(tfn(_t(m), k, square).numpy(), ref)
    ref = np.asarray(jimg.mclose_mopen(m, k, square))
    np.testing.assert_array_equal(timg.mclose_mopen(_t(m), k, square).numpy(), ref)


def test_circle_and_mclose_mopen_argument_check():
    np.testing.assert_array_equal(timg.circle(7), jimg.circle(7))
    with pytest.raises(ValueError):
        timg.mclose_mopen(torch.zeros(4, 4, dtype=torch.bool), 4)


# -- threshold: exact ------------------------------------------------------------


def _otsu_inputs():
    rng = np.random.default_rng(5)
    density = rng.negative_binomial(2, 0.3, 5000).astype(np.float32)
    scores = np.concatenate([rng.beta(2, 8, 3000), rng.beta(8, 2, 600)]).astype(np.float32)
    bimodal = np.concatenate([rng.normal(1, 0.3, 2000), rng.normal(4, 0.5, 1000)]).astype(np.float32)
    return {"density": density, "scores": scores, "bimodal": bimodal}


@pytest.mark.parametrize("name", ["density", "scores", "bimodal"])
def test_otsu_matches_jax(name):
    """Otsu threshold and its 256-bin histogram counts; exact."""
    v = _otsu_inputs()[name]
    vj = jnp.asarray(v)
    ref = float(jthr._otsu_from_values(vj, jnp.min(vj), jnp.max(vj), 256))
    vt = _t(v)
    assert float(tthr._otsu_from_values(vt, vt.min(), vt.max(), 256)) == ref
    assert tthr.threshold_otsu(vt) == jthr.threshold_otsu(v)
    idx = np.clip(((v - v.min()) / (v.max() - v.min()) * 256).astype(np.int32), 0, 255)
    hist_j = np.asarray(jthr._histogram_chunked(jnp.asarray(idx), 256))
    hist_t = torch.bincount(_t(idx), minlength=256).numpy()
    np.testing.assert_array_equal(hist_t, hist_j)


# -- EM --------------------------------------------------------------------------


def test_nb_logpmf_matches_jax():
    """lgamma differs at the ulp level between XLA and PyTorch, so the bound
    is the ulp of the largest lgamma term: atol 1e-5 for counts <= 20 and
    r <= 5, where those terms stay below 64 (at lgamma ~ 200 one f32 ulp is
    already 1.5e-5)."""
    rng = np.random.default_rng(1)
    x = np.minimum(rng.negative_binomial(3, 0.2, 4000), 20).astype(np.float32)
    for r, p in ((0.7, 0.3), (2.0, 0.1), (5.0, 0.05)):
        ref = np.asarray(jem.nb_logpmf(jnp.asarray(x), jnp.float32(r), jnp.float32(p)))
        out = tem.nb_logpmf(_t(x), torch.tensor(r), torch.tensor(p)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def _em_batch():
    """B=3 padded sample rows: two ragged valid fits and one row whose
    initial parameters (var < mu) make its first step invalid."""
    rng = np.random.default_rng(7)
    S = 1500
    X = np.zeros((3, S), np.float32)
    mask = np.zeros((3, S), bool)
    lens = (1500, 1100, 800)
    for b, n in enumerate(lens):
        bg = rng.negative_binomial(2, 0.4, int(n * 0.8))
        fg = rng.negative_binomial(10, 0.25, n - int(n * 0.8))
        X[b, :n] = np.concatenate([bg, fg])
        mask[b, :n] = True
    w0 = np.array([[0.8, 0.2], [0.7, 0.3], [0.5, 0.5]], np.float32)
    mu0 = np.array([[3.0, 30.0], [2.0, 25.0], [5.0, 10.0]], np.float32)
    var0 = np.array([[9.0, 150.0], [6.0, 120.0], [2.0, 4.0]], np.float32)
    return X, mask, w0, mu0, var0


def test_nbn_em_batched_matches_jax():
    """Same samples, same start: w, r, theta agree to rtol 1e-4 (digamma and
    lgamma differ at the ulp level); the invalid row keeps its start."""
    X, mask, w0, mu0, var0 = _em_batch()
    ref = [np.asarray(a) for a in jem._nbn_em_batched(*map(jnp.asarray, (X, mask, w0, mu0, var0)), max_iter=2000, precision=1e-6)]
    stats = {}
    out = [a.numpy() for a in tem._nbn_em_batched(*map(_t, (X, mask, w0, mu0, var0)), max_iter=2000, precision=1e-6, stats=stats)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, rtol=1e-4)
    np.testing.assert_array_equal(out[0][2], w0[2])  # frozen at its start
    assert 0 < stats["n_iter"] <= 2000


def test_nbn_em_max_iter_is_exact():
    """The host reads 'all done' only every 16 steps but never steps past
    max_iter: a 5-step fit equals JAX's 5-step fit."""
    X, mask, w0, mu0, var0 = _em_batch()
    ref = [np.asarray(a) for a in jem._nbn_em_batched(*map(jnp.asarray, (X, mask, w0, mu0, var0)), max_iter=5, precision=1e-6)]
    stats = {}
    out = [a.numpy() for a in tem._nbn_em_batched(*map(_t, (X, mask, w0, mu0, var0)), max_iter=5, precision=1e-6, stats=stats)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, rtol=1e-4)
    assert stats["n_iter"] == 5


def test_nbn_em_and_conditionals_match_jax():
    """Public nbn_em and conditionals (plain and per bin): rtol 1e-4."""
    X, _, _, _, _ = _em_batch()
    x = X[0]
    ref = jem.nbn_em(x, w=(0.8, 0.2), mu=(3.0, 30.0), var=(9.0, 150.0), precision=1e-6)
    out = tem.nbn_em(x, w=(0.8, 0.2), mu=(3.0, 30.0), var=(9.0, 150.0), precision=1e-6, device="cpu")
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, rtol=1e-4)
    raster = x[:1200].reshape(30, 40)
    bg_j, cell_j = jem.conditionals(raster, ref)
    bg_t, cell_t = tem.conditionals(_t(raster), ref)
    np.testing.assert_allclose(bg_t.numpy(), bg_j, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(cell_t.numpy(), cell_j, rtol=1e-4, atol=1e-7)
    bins = (np.arange(1200).reshape(30, 40) % 3).astype(np.int32)
    per_bin = {1: ref, 2: (ref[0], ref[1][::-1].copy(), ref[2][::-1].copy())}
    bg_j, cell_j = jem.conditionals(raster, per_bin, bins)
    bg_t, cell_t = tem.conditionals(_t(raster), per_bin, _t(bins))
    np.testing.assert_allclose(bg_t.numpy(), bg_j, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(cell_t.numpy(), cell_j, rtol=1e-4, atol=1e-7)


# -- BP ----------------------------------------------------------------------------


def _phi_planes(H, W, seed):
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0.05, 0.95, (2, H, W)).astype(np.float32)
    return phi / phi.sum(0, keepdims=True)


@pytest.mark.parametrize("msg_dtype", ["float32", "bfloat16"])
def test_bp_step_reference_matches_pallas(msg_dtype):
    """One fused iteration on 40x72 (ragged against the TPU tiling) against
    the Pallas kernel in interpret mode: f32 atol 1e-6, bf16 at most 1 ulp.
    Delivered edge planes are exactly 0.5."""
    H, W = 40, 72
    phi = _phi_planes(H, W, 0)
    M = np.random.default_rng(1).uniform(0.02, 0.98, (4, H, W)).astype(np.float32)
    Mj = jnp.asarray(M).astype(msg_dtype)
    ref = np.asarray(jpal.bp_step_pallas(jnp.asarray(phi), Mj, 0.6, 0.4, interpret=True).astype(jnp.float32))
    Mt = _t(np.asarray(Mj.astype(jnp.float32))).to(tcu._MSG_DTYPES[msg_dtype])
    out_t = tcu.bp_step_reference(_t(phi), Mt, 0.6, 0.4)
    assert out_t.dtype == Mt.dtype and out_t.shape == (4, H, W)
    out = out_t.float().numpy()
    if msg_dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    else:
        assert np.all(np.abs(out - ref) <= _bf16_ulp(ref))
    for plane, edge in ((0, out[0, -1]), (1, out[1, 0]), (2, out[2, :, -1]), (3, out[3, :, 0])):
        assert np.all(edge == 0.5), plane


@pytest.mark.parametrize("check_every,precision", [(1, 1e-6), (10, 1e-6), (10, 0.0)])
def test_bp_kernel_matches_pallas(check_every, precision):
    """The full loop (blocked delta checks, fixed-iteration mode) against
    bp_kernel_pallas in interpret mode: atol 2e-6 in f32."""
    phi = np.moveaxis(_phi_planes(40, 72, 2), 0, -1).copy()
    ref = np.asarray(jpal.bp_kernel_pallas(jnp.asarray(phi), 0.6, 0.4, precision, 30, check_every=check_every, interpret=True))
    before = tcu.bp_step.launches
    out = tcu.bp_kernel(_t(phi), 0.6, 0.4, precision, 30, check_every=check_every).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=0)
    assert tcu.bp_step.launches == before  # CPU tensors never launch the kernel


@pytest.mark.parametrize("msg_dtype", ["float32", "bfloat16"])
def test_bp_step_delta_on_cpu_is_the_plain_sum(msg_dtype):
    """On CPU tensors `bp_step(..., delta=True)` returns the plain iteration
    and the f32 L2 change of the JAX loop, sqrt(2 sum((new - old)^2)),
    within 1e-5 relative (both sum in f32, in other orders: 3e-6 apart in
    bf16 here), and launches nothing."""
    H, W = 40, 72
    phi = _t(_phi_planes(H, W, 4))
    M = _t(np.random.default_rng(5).uniform(0.02, 0.98, (4, H, W)).astype(np.float32)).to(tcu._MSG_DTYPES[msg_dtype])
    before = (tcu.bp_step.launches, tcu.bp_step.delta_launches)
    out, delta = tcu.bp_step(_t(phi.numpy()), M, 0.6, 0.4, delta=True)
    assert (tcu.bp_step.launches, tcu.bp_step.delta_launches) == before
    assert torch.equal(out, tcu.bp_step_reference(phi, M, 0.6, 0.4))
    diff = np.asarray(jnp.asarray(out.float().numpy()) - jnp.asarray(M.float().numpy()))
    want = np.asarray(jnp.sqrt(2.0 * jnp.sum(jnp.asarray(diff) ** 2)))
    assert delta.shape == () and delta.dtype == torch.float32
    np.testing.assert_allclose(float(delta), float(want), rtol=1e-5)


@pytest.mark.parametrize("square", [True, False])
def test_generic_bp_kernel_matches_jax(square):
    """The generic kernel for the 3x3 square (8 neighbours) and the circle(3)
    4-neighbourhood against JAX's `_bp_kernel`: atol 2e-6."""
    phi = np.moveaxis(_phi_planes(24, 30, 3), 0, -1).copy()
    nb = np.ones((3, 3)) if square else jimg.circle(3)
    offsets = tuple(map(tuple, jbp.create_neighbor_offsets(nb.astype(bool)).tolist()))
    assert offsets == tuple(map(tuple, tbp.create_neighbor_offsets(nb.astype(bool)).tolist()))
    ref = np.asarray(jbp._bp_kernel(jnp.asarray(phi), offsets, 0.6, 0.4, 1e-6, 25))
    out = tbp._bp_kernel(_t(phi), offsets, 0.6, 0.4, 1e-6, 25).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=0)


def test_run_bp_matches_jax():
    """The public run_bp on the CPU (generic path): atol 2e-6."""
    rng = np.random.default_rng(4)
    cell = rng.uniform(0, 1, (20, 26)).astype(np.float32)
    bg = (1 - cell + rng.uniform(0, 0.2, cell.shape)).astype(np.float32)
    ref = jbp.run_bp(bg, cell, max_iter=20)
    out = tbp.run_bp(bg, cell, max_iter=20, device="cpu")
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=0)


def test_bp_dispatch_and_launch_count_on_cpu():
    """`_use_cuda_bp` is False for a CPU tensor and for any other
    neighbourhood; `bp_step` on CPU tensors uses the plain version and
    leaves `launches` unchanged."""
    x = torch.zeros(2, 2)
    assert not tbp._use_cuda_bp(tcu.OFFSETS4, x)
    assert not tbp._use_cuda_bp(((0, 1), (1, 0)), x)
    phi = _t(_phi_planes(8, 9, 5))
    M = torch.full((4, 8, 9), 0.5)
    before = tcu.bp_step.launches
    np.testing.assert_array_equal(tcu.bp_step(phi, M, 0.6, 0.4).numpy(), tcu.bp_step_reference(phi, M, 0.6, 0.4).numpy())
    assert tcu.bp_step.launches == before


def test_bp_step_rejects_non_cuda_devices():
    """A tensor that is neither on the CPU nor on a CUDA device raises; it
    is never handed to the plain version."""
    phi = torch.empty((2, 4, 4), device="meta")
    M = torch.empty((4, 4, 4), device="meta")
    with pytest.raises(ValueError):
        tcu.bp_step(phi, M, 0.6, 0.4)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler raises with a message, not a fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
