"""Statistics kernels over raw CSR buffers (parity surface: reference
spateo/preprocessing/_fast_utils.py — numba-JIT loops there; vectorized
numpy here, same signatures over (M, N, data, indices, indptr)).

A copy of `spateo_tpu.preprocessing._fast_utils`; these exist for the
reference's raw-buffer calling convention."""

from __future__ import annotations

import numpy as np


def calc_mean_and_var_sparse(M, N, data, indices, indptr, axis):
    """Per-column (axis=0) or per-row (axis=1) mean and ddof-1 variance of
    an M x N CSR matrix given its raw buffers (reference _fast_utils.py:4)."""
    data = np.asarray(data, np.float64)
    indices = np.asarray(indices)
    indptr = np.asarray(indptr)
    if axis == 0:
        mean = np.bincount(indices, weights=data, minlength=N).astype(np.float64)
        var = np.bincount(indices, weights=data * data, minlength=N).astype(np.float64)
        size = M
    else:
        row_ids = np.repeat(np.arange(M), np.diff(indptr))
        mean = np.bincount(row_ids, weights=data, minlength=M).astype(np.float64)
        var = np.bincount(row_ids, weights=data * data, minlength=M).astype(np.float64)
        size = N
    mean /= size
    var = (var - size * mean * mean) / (size - 1)
    return mean, var


def calc_stat_per_batch_sparse(M, N, data, indices, indptr, nbatch, codes):
    """Per-batch cell counts, per-gene means and centered partial sums of
    squares for a CSR matrix (reference _fast_utils.py:35)."""
    data = np.asarray(data, np.float64)
    indices = np.asarray(indices)
    indptr = np.asarray(indptr)
    codes = np.asarray(codes)
    ncells = np.bincount(codes, minlength=nbatch).astype(np.int32)
    row_ids = np.repeat(np.arange(M), np.diff(indptr))
    row_codes = codes[row_ids]
    flat = indices.astype(np.int64) * nbatch + row_codes
    means = np.bincount(flat, weights=data, minlength=N * nbatch).reshape(N, nbatch)
    partial_sum = np.bincount(flat, weights=data * data, minlength=N * nbatch).reshape(N, nbatch)
    ok = ncells > 1
    means[:, ok] /= ncells[ok]
    partial_sum[:, ok] = partial_sum[:, ok] - ncells[ok] * means[:, ok] ** 2
    return ncells, means, partial_sum


def calc_mean_and_var_dense(M, N, X, axis):
    """Dense counterpart of `calc_mean_and_var_sparse`
    (reference _fast_utils.py:68)."""
    X = np.asarray(X, np.float64)
    mean = X.mean(axis=axis)
    size = M if axis == 0 else N
    var = (np.sum(X * X, axis=axis) - size * mean * mean) / (size - 1)
    return mean, var


def calc_stat_per_batch_dense(M, N, X, nbatch, codes):
    """Dense counterpart of `calc_stat_per_batch_sparse`
    (reference _fast_utils.py:99)."""
    X = np.asarray(X, np.float64)
    codes = np.asarray(codes)
    ncells = np.bincount(codes, minlength=nbatch).astype(np.int32)
    onehot = np.zeros((M, nbatch))
    onehot[np.arange(M), codes] = 1.0
    means = X.T @ onehot  # [N, nbatch] sums
    partial_sum = (X * X).T @ onehot
    ok = ncells > 1
    means[:, ok] /= ncells[ok]
    partial_sum[:, ok] = partial_sum[:, ok] - ncells[ok] * means[:, ok] ** 2
    return ncells, means, partial_sum
