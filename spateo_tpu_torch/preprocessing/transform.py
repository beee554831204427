"""Expression transforms: log1p, scale (parity: reference spateo/preprocessing/transform.py:18,118).

A copy of `spateo_tpu.preprocessing.transform` (numpy, host side), so that
MuSIC's `log_transform=True` runs without the JAX package. Sparse row and
column scalings are exact scalings of the CSR/CSC `.data`, as
`sklearn.utils.sparsefuncs.inplace_{row,column}_scale` do them (the GPU
machine has no scikit-learn)."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import scipy.sparse

from ..core.anndata import AnnData
from ..logging import logger_manager as lm


def inplace_row_scale(X, scale: np.ndarray) -> None:
    """Multiply row i of a CSR or CSC matrix by ``scale[i]``, in place."""
    if scipy.sparse.isspmatrix_csr(X) or isinstance(X, scipy.sparse.csr_array):
        X.data *= np.repeat(scale, np.diff(X.indptr))
    elif scipy.sparse.isspmatrix_csc(X) or isinstance(X, scipy.sparse.csc_array):
        X.data *= scale.take(X.indices, mode="clip")
    else:
        raise TypeError(f"Expected a CSR or CSC sparse matrix, got {type(X)}.")


def inplace_column_scale(X, scale: np.ndarray) -> None:
    """Multiply column j of a CSR or CSC matrix by ``scale[j]``, in place."""
    if scipy.sparse.isspmatrix_csr(X) or isinstance(X, scipy.sparse.csr_array):
        X.data *= scale.take(X.indices, mode="clip")
    elif scipy.sparse.isspmatrix_csc(X) or isinstance(X, scipy.sparse.csc_array):
        X.data *= np.repeat(scale, np.diff(X.indptr))
    else:
        raise TypeError(f"Expected a CSR or CSC sparse matrix, got {type(X)}.")


def log1p_array(X, base: Optional[float] = None, copy: bool = False):
    X = X.astype(float) if not np.issubdtype(X.dtype, np.floating) else (X.copy() if copy else X)
    np.log1p(X, out=X)
    if base is not None:
        np.divide(X, np.log(base), out=X)
    return X


def log1p_sparse(X, base: Optional[float] = None, copy: bool = False):
    X = X.copy() if copy else X
    X = X.astype(float) if not np.issubdtype(X.dtype, np.floating) else X
    X.data = np.log1p(X.data)
    if base is not None:
        X.data /= np.log(base)
    return X


def log1p(adata_or_X, base: Optional[float] = None, copy: bool = False, layer: Optional[str] = None):
    """log(1+x) transform of an AnnData layer or raw matrix."""
    if isinstance(adata_or_X, AnnData):
        return log1p_anndata(adata_or_X, base=base, copy=copy, layer=layer)
    X = adata_or_X
    if scipy.sparse.issparse(X):
        return log1p_sparse(X, base=base, copy=copy)
    return log1p_array(np.asarray(X), base=base, copy=copy)


def log1p_anndata(adata: AnnData, base: Optional[float] = None, copy: bool = False, layer: Optional[str] = None):
    if copy:
        adata = adata.copy()
    X = adata.layers[layer] if layer is not None else adata.X
    out = log1p(X, base=base, copy=False)
    if layer is not None:
        adata.layers[layer] = out
    else:
        adata.X = out
    adata.uns.setdefault("pp", {})["log1p"] = {"base": base}
    return adata if copy else None


def _get_mean_var(X, axis: int = 0):
    if scipy.sparse.issparse(X):
        mean = np.asarray(X.mean(axis=axis)).ravel()
        sq = X.copy()
        sq.data **= 2
        ex2 = np.asarray(sq.mean(axis=axis)).ravel()
        var = ex2 - mean**2
        var *= X.shape[axis] / max(X.shape[axis] - 1, 1)
    else:
        mean = np.mean(X, axis=axis, dtype=np.float64)
        var = np.var(X, axis=axis, dtype=np.float64, ddof=1)
    return mean, var


def scale_array(
    X: np.ndarray,
    zero_center: bool = True,
    max_value: Optional[float] = None,
    copy: bool = False,
    return_mean_std: bool = False,
):
    X = X.copy() if copy else X
    X = X.astype(float) if not np.issubdtype(X.dtype, np.floating) else X
    mean, var = _get_mean_var(X)
    std = np.sqrt(var)
    std[std == 0] = 1
    if zero_center:
        X -= mean
    X /= std
    if max_value is not None:
        X[X > max_value] = max_value
    if return_mean_std:
        return X, mean, std
    return X


def scale_sparse(
    X, zero_center: bool = True, max_value: Optional[float] = None, copy: bool = False, return_mean_std: bool = False
):
    if zero_center:
        # centering densifies, as in the reference (transform.py:159-164)
        return scale_array(
            np.asarray(X.todense()), zero_center=True, max_value=max_value, return_mean_std=return_mean_std
        )
    X = X.copy() if copy else X
    mean, var = _get_mean_var(X)
    std = np.sqrt(var)
    std[std == 0] = 1
    inplace_column_scale(X, 1 / std)
    if max_value is not None:
        X.data[X.data > max_value] = max_value
    if return_mean_std:
        return X, mean, std
    return X


def scale(
    X,
    zero_center: bool = True,
    max_value: Optional[float] = None,
    copy: bool = False,
    layer: Optional[str] = None,
    obsm: Optional[str] = None,
    return_mean_std: bool = False,
):
    """Scale variables to unit variance, optionally zero mean (parity:
    reference preprocessing/transform.py:118-146 — same AnnData/matrix
    dispatch, layer-over-obsm priority, .var['mean']/['std'] annotations,
    and the return_mean_std return)."""
    if isinstance(X, AnnData):
        return scale_anndata(
            X, zero_center=zero_center, max_value=max_value, copy=copy,
            layer=layer, obsm=obsm, return_mean_std=return_mean_std,
        )
    if scipy.sparse.issparse(X):
        return scale_sparse(X, zero_center=zero_center, max_value=max_value, copy=copy, return_mean_std=return_mean_std)
    return scale_array(np.asarray(X), zero_center=zero_center, max_value=max_value, copy=copy, return_mean_std=return_mean_std)


def scale_anndata(
    adata: AnnData,
    zero_center: bool = True,
    max_value: Optional[float] = None,
    copy: bool = False,
    layer: Optional[str] = None,
    obsm: Optional[str] = None,
    return_mean_std: bool = False,
):
    """AnnData-level scale: `layer` takes priority over `obsm`, else .X
    (reference transform.py:135-137); means/stds land in .var when the
    scaled matrix is feature-shaped."""
    if copy:
        adata = adata.copy()
    if layer is not None:
        X = adata.layers[layer]
    elif obsm is not None:
        X = adata.obsm[obsm]
    else:
        X = adata.X
    out, mean, std = scale(X, zero_center=zero_center, max_value=max_value, copy=False, return_mean_std=True)
    if layer is not None:
        adata.layers[layer] = out
    elif obsm is not None:
        adata.obsm[obsm] = out
    else:
        adata.X = out
        adata.var["mean"] = mean
        adata.var["std"] = std
    if return_mean_std:
        return (adata, mean, std) if copy else (None, mean, std)
    return adata if copy else None


def sparse_mean_var_minor_axis(data, indices, major_len: int, minor_len: int, dtype=np.float64):
    """Mean/variance over the minor (indexed) axis of a CSR-like buffer
    (parity: reference preprocessing/_fast_utils numba kernel, vectorized)."""
    means = np.zeros(minor_len, dtype)
    sq = np.zeros(minor_len, dtype)
    np.add.at(means, indices, data)
    np.add.at(sq, indices, np.asarray(data, dtype) ** 2)
    means /= major_len
    var = sq / major_len - means**2
    var *= major_len / max(major_len - 1, 1)
    return means, var


def sparse_mean_var_major_axis(data, indptr, major_len: int, minor_len: int, dtype=np.float64):
    """Mean/variance over the major (indptr) axis (parity: reference
    _fast_utils kernel)."""
    counts = np.diff(indptr)
    sums = np.add.reduceat(np.asarray(data, dtype), indptr[:-1]) * (counts > 0)
    sq = np.add.reduceat(np.asarray(data, dtype) ** 2, indptr[:-1]) * (counts > 0)
    means = sums / minor_len
    var = sq / minor_len - means**2
    var *= minor_len / max(minor_len - 1, 1)
    return means, var


def sparse_mean_variance_axis(mtx, axis: int):
    """scanpy-compatible sparse mean/variance along an axis (parity:
    reference _fast_utils sparse_mean_variance_axis)."""
    from scipy.sparse import csc_matrix, csr_matrix

    if isinstance(mtx, csr_matrix):
        if axis == 0:
            return sparse_mean_var_minor_axis(mtx.data, mtx.indices, mtx.shape[0], mtx.shape[1])
        return sparse_mean_var_major_axis(mtx.data, mtx.indptr, mtx.shape[0], mtx.shape[1])
    if isinstance(mtx, csc_matrix):
        if axis == 0:
            return sparse_mean_var_major_axis(mtx.data, mtx.indptr, mtx.shape[1], mtx.shape[0])
        return sparse_mean_var_minor_axis(mtx.data, mtx.indices, mtx.shape[1], mtx.shape[0])
    M = np.asarray(mtx, float)
    return M.mean(axis=axis), M.var(axis=axis, ddof=1)
