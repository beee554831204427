"""Count normalization: total-count, edgeR-style TMM/TMMwsp/RLE/upperquartile
(counterpart of `spateo_tpu.preprocessing.normalize`; reference
spateo/preprocessing/normalize.py:74-620).

Host numpy as in the JAX package, but for the TMM factors: `_tmm_batched`
computes every sample's factor at once on `device` in float64 (masked ranks,
masked weighted sums), as the JAX package's vmapped kernel does, from
logarithms taken on the host. Sparse row scaling is an exact scaling of the CSR's
`.data` (`transform.inplace_row_scale`).
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Optional, Union

import numpy as np
import scipy.sparse
import torch

from ..core.anndata import AnnData
from ..logging import logger_manager as lm
from .transform import inplace_column_scale, inplace_row_scale


def _normalize_data(X, counts, after=None, copy: bool = False, rows: bool = True, round: bool = False):
    """Scale rows (or columns) of X so each sums to `after`."""
    X = X.copy() if copy else X
    if issubclass(X.dtype.type, (int, np.integer)):
        X = X.astype(np.float32)
    counts = np.asarray(counts, dtype=float).ravel()
    after = np.median(counts[counts > 0]) if after is None else after
    counts = counts / after
    counts[counts == 0] = 1
    if scipy.sparse.issparse(X):
        if rows:
            inplace_row_scale(X, 1 / counts)
        else:
            inplace_column_scale(X, 1 / counts)
    else:
        if rows:
            X = X / counts[:, None]
        else:
            X = X / counts[None, :]
    if round:
        if scipy.sparse.issparse(X):
            X.data = np.round(X.data)
        else:
            X = np.round(X)
    return X


def normalize_total(
    adata: AnnData,
    target_sum: Optional[float] = None,
    norm_factor: Optional[np.ndarray] = None,
    exclude_highly_expressed: bool = False,
    max_fraction: float = 0.05,
    key_added: Optional[str] = None,
    layer: Optional[str] = None,
    inplace: bool = True,
    copy: bool = False,
) -> Union[AnnData, Dict[str, np.ndarray], None]:
    """Normalize counts per cell to a common total (parity: normalize.py:74)."""
    logger = lm.get_main_logger()
    if copy:
        if not inplace:
            logger.error("`copy=True` cannot be used with `inplace=False`.")
        adata = adata.copy()
    if max_fraction < 0 or max_fraction > 1:
        logger.error("Choose max_fraction between 0 and 1.")

    X = adata.layers[layer] if layer is not None else adata.X

    if target_sum is None:
        library_size = float(np.mean(np.asarray(adata.X.sum(axis=1)).ravel()))
        target_sum = 10 ** math.ceil(math.log10(max(library_size, 1e-12)))

    if exclude_highly_expressed:
        counts_per_cell = np.asarray(X.sum(axis=1)).ravel()
        gene_subset = np.asarray((X > counts_per_cell[:, None] * max_fraction).sum(axis=0)).ravel() == 0
        counts_per_cell = np.asarray(X[:, gene_subset].sum(axis=1)).ravel()
    else:
        counts_per_cell = np.asarray(X.sum(axis=1)).ravel()

    if norm_factor is not None:
        scale_factor = np.ravel(np.multiply(counts_per_cell, norm_factor.reshape(-1)))
        X = _normalize_data(X, scale_factor, after=1.0, copy=not inplace)
        counts_per_cell = np.asarray(X.sum(axis=1)).ravel()

    if not np.all(counts_per_cell > 0):
        logger.warning("Some cells have zero counts")

    if inplace:
        if key_added is not None:
            adata.obs[key_added] = counts_per_cell
        X = _normalize_data(X, counts_per_cell, target_sum)
        if layer is not None:
            adata.layers[layer] = X
        else:
            adata.X = X
    else:
        return dict(
            X=_normalize_data(X, counts_per_cell, target_sum, copy=True),
            norm_factor=counts_per_cell,
        )
    if copy:
        return adata


# ---------------------------------------------------------------------------
# edgeR-style scale factors
# ---------------------------------------------------------------------------
def calcFactorRLE(data: np.ndarray) -> np.ndarray:
    """Relative Log Expression factors (edgeR; parity: normalize.py:213)."""
    with np.errstate(divide="ignore"):
        gm = np.exp(np.mean(np.log(data), axis=0))
    return np.apply_along_axis(lambda u: np.median(u / gm[gm > 0]), axis=1, arr=data)


def calcFactorQuantile(data: np.ndarray, lib_size, p: float = 0.95) -> np.ndarray:
    """Quantile factors (edgeR; parity: normalize.py:232)."""
    factors = np.percentile(data, p * 100, axis=1)
    if np.min(factors) == 0:
        lm.main_warning(f"Quantile method: {p * 100}th percentile is zero for one or more cells.")
    return factors / lib_size


def _tmm_batched(
    counts: np.ndarray,
    lib_size: np.ndarray,
    ref: np.ndarray,
    libsize_ref: float,
    logratio_trim: float = 0.3,
    sum_trim: float = 0.05,
    do_weighting: bool = True,
    a_cutoff: float = -1e10,
    device="cuda",
) -> torch.Tensor:
    """All TMM factors at once: one row of `counts` [S, G] a sample against
    `ref` [G]; the [S] factors on `device`.

    edgeR's calcFactorTMM with static shapes, as the JAX package computes
    it: invalid genes are masked (not dropped), the trims keep the genes whose
    rank among the valid ones (a stable argsort, invalid genes pushed to
    +inf) is at least ``floor(n * trim) + 1``, and the weighted mean uses
    masked sums. The ranks, the variances and the sums run on `device`. The
    logarithms are numpy's, taken on the host: a card's ``log2`` rounds about
    a quarter of them one ulp away from the CPU's, and on counts, where many
    genes share a ratio, that reorders tied genes at a trim's edge."""
    nO = np.asarray(lib_size, float)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        logR_h = np.log2((counts / nO) / (ref / libsize_ref))
        absE_h = (np.log2(counts / nO) + np.log2(ref / libsize_ref)) / 2.0
    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)  # noqa: E731
    logR, absE, C, nO, R = t(logR_h), t(absE_h), t(counts), t(nO), t(ref)
    v = (nO - C) / nO / C + (libsize_ref - R) / libsize_ref / R
    fin = torch.isfinite(logR) & torch.isfinite(absE) & (absE > a_cutoff)
    n = fin.sum(1, keepdim=True).double()
    loL = torch.floor(n * logratio_trim).long() + 1
    loS = torch.floor(n * sum_trim).long() + 1
    pos = torch.arange(counts.shape[1], device=device).expand_as(logR)

    def rank_in_mask(x):
        order = torch.argsort(torch.where(fin, x, torch.inf), dim=1, stable=True)
        return torch.empty_like(order).scatter_(1, order, pos)

    keep = fin & (rank_in_mask(logR) >= loL) & (rank_in_mask(absE) >= loS)
    logR_m = torch.where(keep, logR, 0.0)
    if do_weighting:
        w = torch.where(keep, 1.0 / v, 0.0)
        f = (logR_m * w).sum(1) / w.sum(1)
    else:
        f = logR_m.sum(1) / keep.sum(1).clamp_min(1)
    f = torch.where(torch.isnan(f), 0.0, f)
    trivial = torch.where(fin, logR.abs(), 0.0).amax(1) < 1e-6
    return torch.where(trivial, 1.0, 2.0**f)


def calcFactorTMM(
    obs,
    ref,
    libsize_obs: Optional[float] = None,
    libsize_ref: Optional[float] = None,
    logratioTrim: float = 0.3,
    sumTrim: float = 0.05,
    doWeighting: bool = True,
    Acutoff: float = -1e10,
    device="cuda",
) -> float:
    """Single-pair TMM factor (edgeR semantics; parity: normalize.py:257),
    on `device`."""
    obs = np.asarray(obs, dtype=float)
    ref = np.asarray(ref, dtype=float)
    nO = [float(np.sum(obs)) if libsize_obs is None else libsize_obs]
    nR = float(np.sum(ref)) if libsize_ref is None else libsize_ref
    return float(_tmm_batched(obs[None, :], np.asarray(nO), ref, nR, logratioTrim, sumTrim, doWeighting, Acutoff,
                              device)[0])


def calcFactorTMMwsp(
    obs,
    ref,
    libsize_obs: Optional[float] = None,
    libsize_ref: Optional[float] = None,
    logratioTrim: float = 0.3,
    sumTrim: float = 0.05,
    doWeighting: bool = True,
) -> float:
    """TMM with singleton pairing (edgeR semantics; parity: normalize.py:325).

    Host numpy: the singleton-pairing re-sort is data-dependent and the inputs
    are single library pairs (small), so there is nothing for the TPU to win.
    """
    obs = np.asarray(obs, dtype=float)
    ref = np.asarray(ref, dtype=float)
    eps = 1e-14
    npos = 2 * (obs > eps) + (ref > eps)
    drop = (npos == 0) | np.isnan(npos)
    obs, ref, npos = obs[~drop], ref[~drop], npos[~drop]
    if libsize_obs is None:
        libsize_obs = np.sum(obs)
    if libsize_ref is None:
        libsize_ref = np.sum(ref)
    zero_obs = npos == 1
    zero_ref = npos == 2
    k = zero_obs | zero_ref
    n_singles = min(np.sum(zero_obs), np.sum(zero_ref))
    if n_singles > 0:
        refk = np.sort(ref[k])[::-1][:n_singles]
        obsk = np.sort(obs[k])[::-1][:n_singles]
        obs = np.concatenate([obs[~k], obsk])
        ref = np.concatenate([ref[~k], refk])
    else:
        obs, ref = obs[~k], ref[~k]
    n = len(obs)
    if n == 0:
        return 1.0
    obs_p, ref_p = obs / libsize_obs, ref / libsize_ref
    M = np.log2(obs_p / ref_p)
    if np.max(np.abs(M)) < 1e-6:
        return 1.0
    obs_ps = (obs + 0.5) / (libsize_obs + 0.5)
    ref_ps = (ref + 0.5) / (libsize_ref + 0.5)
    M_shrunk = np.log2(obs_ps / ref_ps)
    o_M = np.lexsort((M_shrunk, M))
    A = 0.5 * np.log2(obs_p * ref_p)
    o_A = np.argsort(A)
    loM = int(n * logratioTrim) + 1
    hiM = n + 1 - loM
    keep_M = np.zeros(n, dtype=bool)
    keep_M[o_M[loM:hiM]] = True
    loA = int(n * sumTrim) + 1
    hiA = n + 1 - loA
    keep_A = np.zeros(n, dtype=bool)
    keep_A[o_A[loA:hiA]] = True
    keep = keep_M & keep_A
    Mk = M[keep]
    if doWeighting:
        op, rp = obs_p[keep], ref_p[keep]
        v = (1 - op) / op / libsize_obs + (1 - rp) / rp / libsize_ref
        w = (1 + 1e-6) / (v + 1e-6)
        TMM = np.sum(w * Mk) / np.sum(w)
    else:
        TMM = np.mean(Mk)
    return float(2**TMM)


def calcNormFactors(
    counts,
    lib_size: Optional[np.ndarray] = None,
    method: str = "TMM",
    refColumn: Optional[int] = None,
    logratioTrim: float = 0.3,
    sumTrim: float = 0.05,
    doWeighting: bool = True,
    Acutoff: float = -1e10,
    p: float = 0.75,
    device="cuda",
) -> np.ndarray:
    """edgeR calcNormFactors (parity: normalize.py:429); TMM runs batched on
    `device`, the other methods on the host."""
    if scipy.sparse.issparse(counts):
        counts = counts.toarray()
    counts = np.asarray(counts, dtype=float)
    if np.any(np.isnan(counts)):
        raise ValueError("NA counts not permitted")
    nsamples = counts.shape[0]
    if lib_size is None:
        lib_size = np.sum(counts, axis=1)
    else:
        lib_size = np.asarray(lib_size, dtype=float)
        if np.any(np.isnan(lib_size)):
            raise ValueError("NA lib sizes not permitted")
        if len(lib_size) != nsamples:
            lib_size = np.repeat(lib_size, nsamples)

    allzero = np.sum(counts > 0, axis=0) == 0
    if np.any(allzero):
        counts = counts[:, ~allzero]

    if method == "TMM":
        if refColumn is None:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                f95 = calcFactorQuantile(counts, lib_size, p=0.95)
                if np.median(f95) < 1e-20:
                    refColumn = int(np.argmax(np.sum(np.sqrt(counts), axis=1)))
                else:
                    refColumn = int(np.argmin(np.abs(f95 - np.mean(f95))))
        factors = _tmm_batched(
            counts, lib_size, counts[refColumn], float(lib_size[refColumn]),
            logratioTrim, sumTrim, doWeighting, Acutoff, device,
        )
        return factors.cpu().numpy()
    elif method == "TMMwsp":
        if refColumn is None:
            refColumn = int(np.argmax(np.sum(np.sqrt(counts), axis=1)))
        factors = np.array(
            [
                calcFactorTMMwsp(
                    counts[i], counts[refColumn], lib_size[i], lib_size[refColumn], logratioTrim, sumTrim, doWeighting
                )
                for i in range(nsamples)
            ]
        )
    elif method == "RLE":
        factors = calcFactorRLE(counts) / lib_size
    elif method == "upperquartile":
        factors = calcFactorQuantile(counts, lib_size, p=p)
    else:
        raise ValueError("Invalid method: " + method)
    return factors / np.exp(np.mean(np.log(factors)))


def factor_normalization(adata: AnnData, norm_factors: Optional[np.ndarray] = None, **kwargs) -> AnnData:
    """Normalize by edgeR factors then per-cell totals (parity: normalize.py:547)."""
    if norm_factors is None:
        norm_factors = calcNormFactors(adata.X, **{k: v for k, v in kwargs.items() if k in {
            "lib_size", "method", "refColumn", "logratioTrim", "sumTrim", "doWeighting", "Acutoff", "p", "device"}})
    normalize_total(adata, norm_factor=norm_factors, **{k: v for k, v in kwargs.items() if k in {
        "target_sum", "exclude_highly_expressed", "max_fraction", "key_added", "layer"}})
    return adata


def calc_mean_and_var(X, axis: int):
    """Mean and variance along an axis for dense/sparse matrices."""
    if scipy.sparse.issparse(X):
        mean = np.asarray(X.mean(axis=axis)).ravel()
        sq = X.copy()
        sq.data **= 2
        ex2 = np.asarray(sq.mean(axis=axis)).ravel()
        n = X.shape[axis]
        var = (ex2 - mean**2) * n / max(n - 1, 1)
    else:
        mean = np.mean(X, axis=axis)
        var = np.var(X, axis=axis, ddof=1)
    return mean, var


def calc_expm1(X):
    """expm1 for dense/sparse matrices."""
    if scipy.sparse.issparse(X):
        out = X.copy()
        out.data = np.expm1(out.data)
        return out
    return np.expm1(X)


def select_hvf_seurat_single(
    X,
    n_top: Optional[int] = 2000,
    min_disp: float = 0.5,
    max_disp: float = np.inf,
    min_mean: float = 0.0125,
    max_mean: float = 7,
) -> np.ndarray:
    """Single-matrix Seurat HVF selection (parity: reference
    normalize.py:646-693, same statistic and return): expm1 the (logged)
    expression, log1p the means and log the dispersions, z-score the log
    dispersions within 20 mean bins (ddof=1), and return integer HVF ranks —
    rank by descending z-score for the top n_top, or -1; with n_top=None all
    features inside the min/max mean+dispersion window are ranked."""
    import pandas as pd

    Xe = calc_expm1(X)
    mean, var = calc_mean_and_var(Xe, axis=0)
    dispersion = np.full(np.shape(Xe)[1], np.nan)
    idx_valid = (mean > 0.0) & (var > 0.0)
    dispersion[idx_valid] = var[idx_valid] / mean[idx_valid]
    mean = np.log1p(mean)
    with np.errstate(divide="ignore", invalid="ignore"):
        dispersion = np.log(dispersion)

    df = pd.DataFrame({"log_dispersion": dispersion, "bin": pd.cut(mean, bins=20)})
    groups = df.groupby("bin", observed=False)["log_dispersion"]
    log_disp_mean = groups.mean()
    log_disp_std = groups.std(ddof=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (df["log_dispersion"].values - log_disp_mean.loc[df["bin"]].values) / log_disp_std.loc[df["bin"]].values
    z = np.asarray(z, float)
    z[np.isnan(z)] = 0.0

    hvf_rank = np.full(np.shape(Xe)[1], -1, dtype=int)
    ords = np.argsort(z)[::-1]
    if n_top is None:
        hvf_rank[ords] = range(np.shape(Xe)[1])
        idx = (mean > min_mean) & (mean < max_mean) & (z > min_disp) & (z < max_disp)
        hvf_rank[~idx] = -1
    else:
        hvf_rank[ords[:n_top]] = range(min(n_top, len(ords)))
    return hvf_rank


def select_hvf_seurat(
    data: AnnData,
    n_top: Optional[int] = 2000,
    min_disp: float = 0.5,
    max_disp: float = np.inf,
    min_mean: float = 0.0125,
    max_mean: float = 7,
) -> np.ndarray:
    """Seurat-style highly-variable feature selection (parity: reference
    normalize.py:695-727 — same var annotations: 'robust', 'hvf_rank',
    'highly_variable_features'; 'highly_variable' is additionally written
    for downstream consumers, and the boolean mask is returned)."""
    data.var["robust"] = True
    hvf_rank = select_hvf_seurat_single(
        data.X, n_top=n_top, min_disp=min_disp, max_disp=max_disp, min_mean=min_mean, max_mean=max_mean
    )
    hvf_index = hvf_rank >= 0
    data.var["hvf_rank"] = hvf_rank
    data.var["highly_variable_features"] = hvf_index
    data.var["highly_variable"] = hvf_index
    return hvf_index
