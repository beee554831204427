"""Graph-based expression smoothing/imputation (capability parity: reference
spateo/tools/spatial_smooth.py:16-497).

Two smoothing modes, matching the reference exactly:

- ``normalize_W=True``: row-normalize the (masked) weights and take the
  weighted neighborhood average ``W @ X`` (reference spatial_smooth.py:155-178);
  returns the row sums ``d`` alongside.
- ``normalize_W=False``: probabilistic imputation — for every cell that does
  NOT express a gene but has more than ``threshold`` expressing neighbors,
  draw one neighbor's value with probability proportional to its weight, then
  restore the original nonzero entries (reference :180-208, helpers :312-420).
  The reference fans this out over a multiprocessing Pool per column; here the
  per-row sampling is a vectorized inverse-CDF over the CSR row segments.

Counterpart of `spateo_tpu.tools.spatial_smooth`: host scipy.sparse, copied.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import scipy.sparse
from scipy.sparse import csr_matrix, issparse

from ..logging import logger_manager as lm


def compute_jaccard_similarity_matrix(data, chunk_size: int = 1000, min_jaccard: float = 0.1):
    """Pairwise Jaccard similarity of binarized expression (parity:
    spatial_smooth.py:210-268), chunked matmuls. Returns CSR for sparse
    input, dense ndarray otherwise (the reference's contract)."""
    was_sparse = issparse(data)
    B = (np.asarray(data.todense()) if was_sparse else np.asarray(data)) > 0
    B = B.astype(np.float32)
    n = B.shape[0]
    J = np.zeros((n, n), np.float64)
    sizes = B.sum(axis=1)
    for s in range(0, n, chunk_size):
        e = min(s + chunk_size, n)
        inter = B[s:e] @ B.T
        union = sizes[s:e, None] + sizes[None, :] - inter
        chunk = inter / np.maximum(union, 1)
        chunk[chunk < min_jaccard] = 0.0
        J[s:e] = chunk
    if np.any(np.isnan(J)) or np.any(np.isinf(J)):
        raise ValueError("jaccard_matrix contains NaN or Inf values")
    return csr_matrix(J) if was_sparse else J


def sparse_matrix_median(spmat: csr_matrix, nonzero_only: bool = False) -> float:
    """Median of a sparse matrix without densifying (parity:
    spatial_smooth.py:274-310): with ``nonzero_only`` the middle of the
    sorted stored values, otherwise the true median counting zeros."""
    data_sorted = np.sort(spmat.data)
    if nonzero_only:
        if spmat.nnz == 0:
            return 0.0
        mid = spmat.nnz // 2
        if spmat.nnz % 2 == 0:
            return float((data_sorted[mid - 1] + data_sorted[mid]) / 2)
        return float(data_sorted[mid])
    total = spmat.shape[0] * spmat.shape[1]
    num_zeros = total - spmat.nnz
    median_idx = total // 2
    if num_zeros > median_idx:
        return 0.0
    return float(data_sorted[median_idx - num_zeros])


def get_eligible_rows(W, feat, threshold: float) -> np.ndarray:
    """Rows with more than ``threshold`` neighbors expressing the feature,
    excluding rows that already express it (parity: spatial_smooth.py:341-378)."""
    feat = np.asarray(feat.todense()).ravel() if issparse(feat) else np.asarray(feat).ravel()
    Wc = csr_matrix(W)
    Wf = Wc.multiply(csr_matrix((feat != 0).astype(float)))  # zero out non-expressing cols
    nnz_new = Wf.getnnz(axis=1)
    eligible = np.where(nnz_new > threshold)[0]
    return np.setdiff1d(eligible, np.where(feat != 0)[0])


def sample_from_eligible_neighbors(W, feat, eligible_rows: np.ndarray) -> np.ndarray:
    """For each eligible row, draw one expressing neighbor's value with
    probability proportional to its weight (parity: spatial_smooth.py:381-420).
    Vectorized: one inverse-CDF search over the CSR row segments instead of
    the reference's per-row np.random.choice loop."""
    feat = np.asarray(feat.todense()).ravel() if issparse(feat) else np.asarray(feat).ravel()
    sampled_values = np.zeros(W.shape[0])
    eligible_rows = np.asarray(eligible_rows, int)
    if eligible_rows.size == 0:
        return sampled_values
    Wv = csr_matrix(W).multiply(csr_matrix((feat != 0).astype(float))).tocsr()
    sub = Wv[eligible_rows]
    rowsum = np.asarray(sub.sum(axis=1)).ravel()
    ok = rowsum > 0
    if not ok.any():
        return sampled_values
    cs = np.cumsum(sub.data)
    seg_start = sub.indptr[:-1]
    base = np.where(seg_start > 0, cs[seg_start - 1], 0.0)
    u = base + np.random.random(len(eligible_rows)) * rowsum
    pick = np.searchsorted(cs, u, side="right")
    pick = np.minimum(pick, np.maximum(sub.indptr[1:] - 1, 0))
    cols = sub.indices[pick]
    sampled_values[eligible_rows[ok]] = feat[cols[ok]]
    return sampled_values


def smooth_process_column(i: int, X, W, threshold: float) -> csr_matrix:
    """Probabilistic smoothing of one gene column (parity:
    spatial_smooth.py:312-338): eligible rows sampled from expressing
    neighbors; everything else zero (original values restored by the caller)."""
    feat = X[:, i].toarray().ravel() if issparse(X) else np.asarray(X[:, i]).ravel()
    eligible_rows = get_eligible_rows(W, feat, threshold)
    sampled = sample_from_eligible_neighbors(W, feat, eligible_rows)
    return csr_matrix(sampled.reshape(-1, 1))


def subsample_neighbors_dense(W: np.ndarray, n: int, verbose: bool = False) -> np.ndarray:
    """Keep at most n random neighbors per row (parity: spatial_smooth.py:429)."""
    logger = lm
    W_new = np.asarray(W).copy()
    num_nonzeros = np.count_nonzero(W_new, axis=1)
    for i in np.where(num_nonzeros > n)[0]:
        nonzero_indices = np.flatnonzero(W_new[i])
        np.random.shuffle(nonzero_indices)
        W_new[i, nonzero_indices[n:]] = 0
    if verbose:
        for i in np.where(num_nonzeros <= n)[0]:
            logger.main_warning(f"Cell {i} has fewer than {n} neighbors to sample from. Subsampling not performed.")
    return W_new


def subsample_neighbors_sparse(W: csr_matrix, n: int, verbose: bool = False) -> csr_matrix:
    """Sparse variant (parity: spatial_smooth.py:461): per-row random keep-n
    on the CSR data, then eliminate_zeros."""
    logger = lm
    W_new = W.copy().tocsr()
    row_nnz = W_new.getnnz(axis=1)
    for row in np.where(row_nnz > n)[0]:
        seg = slice(W_new.indptr[row], W_new.indptr[row + 1])
        cols = W_new.indices[seg].copy()
        np.random.shuffle(cols)
        keep = cols[:n]
        mask = np.isin(W_new.indices[seg], keep, assume_unique=True, invert=True)
        W_new.data[seg][mask] = 0
    if verbose:
        for i in np.where(row_nnz <= n)[0]:
            logger.main_warning(f"Cell {i} has fewer than {n} neighbors to sample from. Subsampling not performed.")
    W_new.eliminate_zeros()
    return W_new


def smooth(
    X,
    W,
    ct: Optional[np.ndarray] = None,
    gene_expr_subset=None,
    min_jaccard: Optional[float] = 0.05,
    manual_mask: Optional[np.ndarray] = None,
    normalize_W: bool = True,
    return_discrete: bool = False,
    smoothing_threshold: Optional[float] = None,
    n_subsample: Optional[int] = None,
    return_W: bool = False,
):
    """Leverage neighborhood information to smooth/impute expression (parity:
    spatial_smooth.py:16-208 — same masking precedence, threshold
    interpretation and return contract).

    Returns (matching the reference):
      - ``normalize_W=True``: ``(x_new, d)`` or ``(x_new, W, d)`` with
        ``return_W`` — ``d`` is the pre-normalization row-sum vector.
      - ``normalize_W=False``: ``x_new`` or ``(x_new, W)`` — the
        probabilistic imputation path.
    """
    logger = lm
    was_sparse = issparse(X)
    X_in = csr_matrix(X) if not was_sparse else X.copy()
    W = csr_matrix(W).astype(np.float64)
    logger.main_info(f"Initial sparsity of array: {X_in.count_nonzero()}")

    if n_subsample is not None:
        W = subsample_neighbors_sparse(W, n_subsample)

    threshold = smoothing_threshold if smoothing_threshold is not None else 0

    # a manual mask OVERRIDES cell-type / expression conditioning
    # (reference :93-99)
    if manual_mask is not None:
        W = csr_matrix(W.multiply(csr_matrix(np.asarray(manual_mask, dtype=float))))
    else:
        if ct is not None:
            ct = np.asarray(ct).ravel()
            rows, cols = np.where(ct[:, None] == ct)
            same = csr_matrix((np.ones_like(rows, dtype=float), (rows, cols)), shape=(len(ct), len(ct)))
            W = csr_matrix(W.multiply(same))
        if gene_expr_subset is not None:
            J = compute_jaccard_similarity_matrix(gene_expr_subset, min_jaccard=min_jaccard or 0.0)
            if issparse(J):
                jaccard_threshold = sparse_matrix_median(J, nonzero_only=True)
            else:
                nz = J[J != 0]
                jaccard_threshold = float(np.percentile(nz, 50)) if nz.size else 0.0
            logger.main_info(f"Threshold Jaccard score: {jaccard_threshold}")
            mask = (J >= jaccard_threshold) if issparse(J) else csr_matrix((J >= jaccard_threshold).astype(float))
            W = csr_matrix(W.multiply(mask))

    # fractional threshold = proportion of the average non-zero neighbor
    # count (reference :133-146)
    average_nonzeros = float(W.getnnz(axis=1).mean())
    logger.main_info(f"Average number of non-zero weights per cell: {average_nonzeros}")
    if 0 < threshold < 1:
        threshold = int(average_nonzeros * threshold)
        logger.main_info(f"Threshold set to {threshold} based on the average number of non-zero weights.")

    # original nonzero entries (restored verbatim on the probabilistic path)
    initial_nz_rows, initial_nz_cols = X_in.nonzero()
    initial_nz_vals = np.asarray(X_in[initial_nz_rows, initial_nz_cols]).ravel()

    if normalize_W:
        d = np.asarray(W.sum(axis=1)).ravel()
        with np.errstate(divide="ignore"):
            inv_d = np.where(d > 0, 1.0 / np.maximum(d, 1e-300), 0.0)
        W = csr_matrix(scipy.sparse.diags(inv_d) @ W)
        # dense in -> dense out, sparse in -> csr out (reference :162)
        x_new = csr_matrix(W @ X_in) if was_sparse else np.asarray((W @ X_in).todense())
        if return_discrete:
            # fractional averages of count data round UP to presence
            # (reference :165-169: (0, 1) -> 1, else round)
            if was_sparse:
                data = x_new.data
                data[:] = np.where((0 < data) & (data < 1), 1, np.round(data))
            else:
                x_new = np.where((0 < x_new) & (x_new < 1), 1, np.round(x_new))
        nnz = x_new.count_nonzero() if was_sparse else np.count_nonzero(x_new)
        logger.main_info(f"Sparsity of smoothed array: {nnz}")
        if return_W:
            return x_new, W, d
        return x_new, d

    # probabilistic path: per-gene neighbor sampling + original values back
    cols = [smooth_process_column(i, X_in, W, threshold) for i in range(X_in.shape[1])]
    x_new = scipy.sparse.hstack(cols).tocsr()
    x_new = x_new + csr_matrix((initial_nz_vals, (initial_nz_rows, initial_nz_cols)), shape=X_in.shape)
    if return_discrete:
        x_new.data[:] = np.round(x_new.data)
    logger.main_info(f"Sparsity of smoothed array: {x_new.count_nonzero()}")
    if return_W:
        return x_new, W
    return x_new
