"""The coarse-init robust rigid fit on the card: wrapper and plain version.

Counterpart of `spateo_tpu.ops.inlier_pallas`. `inlier_fit` runs the 2-D
inlier EM over NN matches (reference methods/utils.py:1220), all
`max_iter` iterations, in one launch of one thread-block cluster of the
kernel `csrc/inlier.cu` for a CUDA tensor (`inlier_layout` chooses the
cluster, the threads and the rows each thread keeps on chip), or through
`inlier_reference` (the same EM as a Python loop of PyTorch ops, the JAX
package's `math._inlier_from_NN_kernel`) for a CPU tensor. Both take train_x, train_y [N, D], distance and mask [N, 1] and the
valid-row count, and return (P [N, 1], R [D, D], t [D], weight0 [N, 1],
sigma2, gamma). The prologue (distance normalisation, weight0, sigma2_0, the
extent a, the decay) is plain PyTorch (`kernel_inputs`), then `launch` runs
the kernel. `inlier_fit.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..alignment.methods.math import procrustes_rotation


def inlier_reference(train_x, train_y, distance, mask, n_valid, max_iter: int = 100):
    """The plain version: `max_iter` EM iterations as a Python loop over
    device tensors, with no read back to the host.

    `mask` [N, 1] marks valid rows and `n_valid` their count; masked rows
    contribute exact zeros to every reduction. Constants that JAX computes
    in f32 (the decay factor) are computed in f32 here as well."""
    N, D = train_x.shape
    f32 = torch.float32
    n_valid = torch.as_tensor(n_valid, dtype=f32, device=train_x.device)
    alpha0 = 1.0
    distance = torch.clamp_min(distance, 0.0)
    normalize = torch.max(distance) / (math.log(10.0) * 2.0)
    distance = distance / normalize
    weight0 = torch.exp(-distance * alpha0) * mask
    sigma2 = torch.sum(((train_x - train_y) ** 2) * mask) / (D * n_valid)
    a = torch.maximum(
        torch.prod(train_x.max(0).values - train_x.min(0).values),
        torch.prod(train_y.max(0).values - train_y.min(0).values),
    )
    alpha_decrease = _decay(max_iter)

    P = weight0 * torch.ones((N, 1), dtype=f32, device=train_x.device)
    R = torch.eye(D, dtype=f32, device=train_x.device)
    t = torch.zeros((D,), dtype=f32, device=train_x.device)
    y_hat = train_x
    gamma = torch.full((), 0.5, dtype=f32, device=train_x.device)
    alpha = alpha0
    weight = weight0
    Sp = torch.sum(P)
    for it in range(max_iter):
        mu_x = torch.sum(train_x * P, 0) / Sp
        mu_y = torch.sum(train_y * P, 0) / Sp
        X_mu, Y_mu = train_x - mu_x, train_y - mu_y
        A = Y_mu.T @ (X_mu * P)
        R = procrustes_rotation(A)
        t = mu_y - mu_x @ R.T
        y_hat = train_x @ R.T + t
        term1 = torch.exp(-torch.sum((train_y - y_hat) ** 2, 1, keepdim=True) / (2 * sigma2)) * weight
        outlier_part = torch.max(weight) * (1 - gamma) * torch.pow(2 * math.pi * sigma2, D / 2) / (gamma * a)
        P = term1 / (term1 + outlier_part)
        Sp = torch.sum(P)
        gamma = torch.clamp(Sp / n_valid, 0.01, 0.99)
        P = torch.clamp_min(P, 1e-6) * mask
        sigma2 = torch.sum((y_hat - train_y) ** 2 * P) / (D * Sp)
        if it > 20:
            alpha = np.float32(alpha) * np.float32(alpha_decrease)
            weight = torch.exp(-distance * float(alpha)) * mask
            weight = weight / torch.max(weight)

    fix_sigma2, fix_gamma = 1e-2, 0.1
    term1 = torch.exp(-torch.sum((train_y - y_hat) ** 2, 1, keepdim=True) / (2 * fix_sigma2)) * weight
    outlier_part = torch.max(weight) * (1 - fix_gamma) * math.pow(2 * math.pi * fix_sigma2, D / 2) / (fix_gamma * a)
    P = term1 / (term1 + outlier_part) * mask
    gamma = torch.clamp(torch.sum(P) / n_valid, 0.01, 0.99)
    return P, R, t, weight0, sigma2, gamma


def _decay(max_iter: int) -> float:
    """The per-iteration alpha decay, in f32 as the JAX package computes it."""
    return float(np.power(np.float32(0.1), np.float32(1.0 / (max_iter - 20))))


#: Blocks of the fit's one cluster: a power of two up to 16 (above 8 a
#: non-portable cluster size, which an H100 allows).
_INLIER_CLUSTER = 16


def inlier_layout(N: int, cluster: int | None = None, threads: int | None = None):
    """The fit's launch for N rows: (cluster, threads, rows_per_thread,
    per_rank). The rows are split contiguously over the cluster's ranks in
    runs of per_rank = ceil(N / cluster); thread t of a rank holds rows t,
    t + threads, ... of its run in registers, up to rows_per_thread of them,
    and walks the rest of the run from global memory. Threads: 256 while 8
    rows a thread hold a run, else 512; rows_per_thread: the fewest that
    hold the run, at most 8."""
    C = _INLIER_CLUSTER if cluster is None else cluster
    if C not in (1, 2, 4, 8, 16):
        raise ValueError(f"inlier_layout: cluster must be 1, 2, 4, 8 or 16, got {C}")
    per = -(-N // C)
    NT = threads or (256 if per <= 8 * 256 else 512)
    if NT not in (256, 512):
        raise ValueError(f"inlier_layout: threads must be 256 or 512, got {NT}")
    return C, NT, max(1, min(8, -(-per // NT))), per


@functools.cache
def _kernel_fn():
    from ._build import load

    fn = load("inlier").inlier_fit
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_inputs(train_x, train_y, distance, mask, n_valid, max_iter: int = 100):
    """The kernel's prologue on the inputs' device: x, y [N, 2], the
    normalised distance and mask [N], scal [8] = (n_valid, extent a, alpha
    decay, sigma2_0, 0, ...), and weight0 [N, 1]."""
    N, D = train_x.shape
    dev, f32 = train_x.device, torch.float32
    n_valid = torch.as_tensor(n_valid, dtype=f32, device=dev)
    distance = torch.clamp_min(distance, 0.0)
    distance = (distance / (torch.max(distance) / (math.log(10.0) * 2.0))).reshape(N).contiguous()
    weight0 = torch.exp(-distance * 1.0)[:, None] * mask
    scal = torch.zeros(8, dtype=f32, device=dev)
    scal[0] = n_valid
    scal[1] = torch.maximum(
        torch.prod(train_x.max(0).values - train_x.min(0).values),
        torch.prod(train_y.max(0).values - train_y.min(0).values),
    )
    scal[2] = _decay(max_iter)
    scal[3] = torch.sum(((train_x - train_y) ** 2) * mask) / (D * n_valid)
    return train_x.contiguous(), train_y.contiguous(), distance, mask.reshape(N).contiguous(), scal, weight0


def inlier_fit(train_x, train_y, distance, mask, n_valid, max_iter: int = 100):
    """The fit in one kernel launch for CUDA tensors (D = 2 only), the plain
    loop for CPU tensors."""
    if train_x.device.type == "cpu":
        return inlier_reference(train_x, train_y, distance, mask, n_valid, max_iter=max_iter)
    tensors = (train_x, train_y, distance, mask)
    if train_x.device.type != "cuda" or any(t.device != train_x.device for t in tensors):
        raise ValueError("inlier_fit: all inputs must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("inlier_fit: inputs must be float32")
    N, D = train_x.shape
    if D != 2 or train_y.shape != (N, 2) or distance.shape != (N, 1) or mask.shape != (N, 1):
        raise ValueError(
            f"inlier_fit: need train_x/train_y [N, 2] and distance/mask [N, 1], got {tuple(train_x.shape)}, "
            f"{tuple(train_y.shape)}, {tuple(distance.shape)}, {tuple(mask.shape)}"
        )
    x, y, distance, mask_n, scal, weight0 = kernel_inputs(train_x, train_y, distance, mask, n_valid, max_iter)
    p_out, misc = launch(x, y, distance, mask_n, scal, max_iter)
    return p_out[:, None], misc[:4].reshape(2, 2), misc[4:6], weight0, misc[6], misc[7]


def launch(x, y, distance, mask, scal, max_iter: int = 100, layout=None):
    """One launch of the kernel on the inputs `kernel_inputs` prepares:
    returns p_out [N] and misc [8] = (R row-major, t, sigma2, gamma).
    `layout` = (cluster, threads, rows_per_thread), `inlier_layout(N)`'s by
    default. Counts the launch in `inlier_fit.launches`."""
    if x.device.type != "cuda":
        raise ValueError(f"inlier_cuda.launch: tensors on {x.device}; the kernel needs a CUDA device")
    N = x.shape[0]
    cluster, threads, rpt = layout or inlier_layout(N)[:3]
    dev, f32 = x.device, torch.float32
    scratch = torch.empty((2, N), dtype=f32, device=dev)
    p_out = torch.empty(N, dtype=f32, device=dev)
    misc = torch.empty(8, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(x.data_ptr(), y.data_ptr(), distance.data_ptr(), mask.data_ptr(), scal.data_ptr(),
                           scratch[0].data_ptr(), scratch[1].data_ptr(), p_out.data_ptr(), misc.data_ptr(),
                           N, int(max_iter), cluster, threads, rpt, stream)
    if err != 0:
        raise RuntimeError(f"inlier_fit kernel launch failed: CUDA error {err}")
    inlier_fit.launches += 1
    return p_out, misc


inlier_fit.launches = 0
