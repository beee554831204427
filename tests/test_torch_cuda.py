"""The port's CUDA kernels on the card, held against their plain versions.

Marked `cuda`: each test skips where no NVIDIA GPU is visible (the decision
is made in a fixture, at run time). On a machine with a card and nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from spateo_tpu_torch.ops import bp_cuda, em
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("shape", [(1, 1), (7, 33), (130, 257)])
def test_bp_step_kernel_matches_plain(cuda, dtype, tol, shape):
    """Kernel vs `bp_step_reference` on ragged shapes: f32 atol 1e-6, bf16
    atol 4e-3 (one bf16 ulp on values <= 1); one counted launch."""
    phi, M = _phi_m(*shape, dtype, cuda)
    before = bp_cuda.bp_step.launches
    out = bp_cuda.bp_step(phi, M, 0.6, 0.4)
    torch.cuda.synchronize()
    assert bp_cuda.bp_step.launches == before + 1
    ref = bp_cuda.bp_step_reference(phi, M, 0.6, 0.4)
    assert out.dtype == dtype and out.shape == M.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


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
