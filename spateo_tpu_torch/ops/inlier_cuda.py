"""The coarse-init robust rigid fit on the card: wrapper and plain version.

Counterpart of `spateo_tpu.ops.inlier_pallas`. `inlier_fit` runs the 2-D
inlier EM over NN matches (reference methods/utils.py:1220), all
`max_iter` iterations, in one launch of the kernel `csrc/inlier.cu` for a
CUDA tensor, or through `inlier_reference` (the same EM as a Python loop of
PyTorch ops, the JAX package's `math._inlier_from_NN_kernel`) for a CPU
tensor. Both take train_x, train_y [N, D], distance and mask [N, 1] and the
valid-row count, and return (P [N, 1], R [D, D], t [D], weight0 [N, 1],
sigma2, gamma). The prologue (distance normalisation, weight0, sigma2_0, the
extent a, the decay) is plain PyTorch. `inlier_fit.launches` counts kernel
launches.
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


@functools.cache
def _kernel_fn():
    from ._build import load

    fn = load("inlier").inlier_fit
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    dev, f32 = train_x.device, torch.float32
    n_valid = torch.as_tensor(n_valid, dtype=f32, device=dev)
    distance = torch.clamp_min(distance, 0.0)
    distance = (distance / (torch.max(distance) / (math.log(10.0) * 2.0))).reshape(N).contiguous()
    mask_n = mask.reshape(N).contiguous()
    weight0 = torch.exp(-distance * 1.0)[:, None] * mask
    scal = torch.zeros(8, dtype=f32, device=dev)
    scal[0] = n_valid
    scal[1] = torch.maximum(
        torch.prod(train_x.max(0).values - train_x.min(0).values),
        torch.prod(train_y.max(0).values - train_y.min(0).values),
    )
    scal[2] = _decay(max_iter)
    scal[3] = torch.sum(((train_x - train_y) ** 2) * mask) / (D * n_valid)
    x, y = train_x.contiguous(), train_y.contiguous()
    scratch = torch.empty((2, N), dtype=f32, device=dev)
    p_out = torch.empty(N, dtype=f32, device=dev)
    misc = torch.empty(8, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(x.data_ptr(), y.data_ptr(), distance.data_ptr(), mask_n.data_ptr(), scal.data_ptr(),
                           scratch[0].data_ptr(), scratch[1].data_ptr(), p_out.data_ptr(), misc.data_ptr(),
                           N, int(max_iter), stream)
    if err != 0:
        raise RuntimeError(f"inlier_fit kernel launch failed: CUDA error {err}")
    inlier_fit.launches += 1
    return p_out[:, None], misc[:4].reshape(2, 2), misc[4:6], weight0, misc[6], misc[7]


inlier_fit.launches = 0
