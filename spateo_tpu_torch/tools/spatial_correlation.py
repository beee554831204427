"""Bivariate spatial correlation (capability parity: reference
spateo/tools/spatial_correlation.py:12-282).

The reference delegates to esda's ``Moran_BV`` / ``Moran_Local_BV``
(esda is not in this image); the same statistics are computed here
directly, following esda's definitions:

- global bivariate Moran: ``I = zx' W zy / (n - 1)`` with z-scores using
  ddof=1 and row-standardized weights; permutation inference permutes y and
  uses esda's "extreme-side" p-value fold.
- local bivariate Moran: ``I_i = (n-1) * zx_i * (W zy)_i / sum(zx^2)`` with
  ddof=0 z-scores, quadrant codes from the signs of ``zx`` and ``W zy``, and
  permutation inference.

Counterpart of `spateo_tpu.tools.spatial_correlation`. W comes from the
port's `find_neighbors.neighbors` (on `device`) when `.obsp` lacks it, is
row-standardised on the host as in the JAX package, and goes to `device` as
a neighbour table of its rows (`_csr_table`) and a float64 CSR tensor of
its transpose. A lag ``W @ z`` adds each row's terms in CSR order, as
scipy's product does (`lisa._neighbour_sum`), so the local statistic and its
null equal the JAX package's bit for bit where scipy multiplies and adds
without contraction. The 999 permutations are drawn on the host in the JAX
package's order (`_moran_bv` reseeds with 0 for every gene, so every gene
takes the same draws) and go up as one index tensor. The global statistic's
null is one [P, n] gather and product for all genes at once; the local
statistic's [P, n] null is computed `PERM_CHUNK` permutations at a time.
The z-scores and the statistics drawn from the null are the JAX package's
host numpy.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import pandas as pd
import torch
from scipy import stats
from scipy.sparse import csr_matrix, issparse

from ..core.anndata import AnnData
from ..core.bridge import _to_device
from .lisa import _neighbour_sum

#: Permutations of one block of `spatial_bv_local_moran`'s null.
PERM_CHUNK = 128


def _row_standardize(W) -> csr_matrix:
    W = csr_matrix(W, dtype=np.float64)
    d = np.asarray(W.sum(axis=1)).ravel()
    inv = np.where(d > 0, 1.0 / np.maximum(d, 1e-300), 0.0)
    from scipy.sparse import diags

    return csr_matrix(diags(inv) @ W)


def _get_connectivities(adata: AnnData, connectivity_key: str, n_neighbors: int, device="cuda") -> csr_matrix:
    if connectivity_key not in adata.obsp:
        from .find_neighbors import neighbors

        neighbors(
            adata,
            basis="spatial",
            spatial_key="spatial",
            n_neighbors_method="ball_tree",
            n_neighbors=n_neighbors,
            device=device,
        )
        connectivity_key = "spatial_connectivities"
    return csr_matrix(adata.obsp[connectivity_key], dtype=np.float64)


def _csr_tensor(W: csr_matrix, device) -> torch.Tensor:
    """A scipy CSR matrix as a float64 sparse CSR tensor on `device`."""
    W = csr_matrix(W)
    return torch.sparse_csr_tensor(
        torch.from_numpy(W.indptr.astype(np.int64)), torch.from_numpy(W.indices.astype(np.int64)),
        torch.from_numpy(np.asarray(W.data, np.float64)), size=W.shape, dtype=torch.float64,
    ).to(device)


def _csr_table(W: csr_matrix, device):
    """W's rows as a neighbour table on `device`: (idx [n, m] int64,
    w [n, m] float64), each row's stored entries in CSR order, padded with
    weight 0 at column 0. `lisa._neighbour_sum` over it adds the terms in
    the order scipy's CSR product adds them."""
    W = csr_matrix(W)
    counts = np.diff(W.indptr)
    n, m = W.shape[0], max(int(counts.max()) if len(counts) else 0, 1)
    rows = np.repeat(np.arange(n), counts)
    pos = np.arange(W.nnz) - np.repeat(W.indptr[:-1], counts)
    idx, w = np.zeros((n, m), np.int64), np.zeros((n, m))
    idx[rows, pos], w[rows, pos] = W.indices, W.data
    return _to_device(idx, device), _to_device(w, device)


def _permutations(n: int, permutations: int, seed: int, device) -> torch.Tensor:
    """[permutations, n] draws of `default_rng(seed).permutation(n)`, in
    order, on `device`."""
    rng = np.random.default_rng(seed)
    return _to_device(np.stack([rng.permutation(n) for _ in range(permutations)]), device)


def _feature_values(adata: AnnData, key: str) -> np.ndarray:
    if key in adata.obs:
        return np.asarray(adata.obs[key].values, dtype=np.float64)
    idx = list(adata.var_names).index(key)
    col = adata.X[:, idx]
    col = col.toarray() if issparse(col) else np.asarray(col)
    return np.asarray(col).ravel().astype(np.float64)


def _moran_bv_stats(I: float, sim: np.ndarray, permutations: int):
    """esda Moran_BV's inference from the null `sim`: (EI_sim, p_sim,
    p_z_sim, z_sim)."""
    larger = int((sim >= I).sum())
    if (permutations - larger) < larger:
        larger = permutations - larger
    p_sim = (larger + 1.0) / (permutations + 1.0)
    EI_sim = sim.mean()
    se = sim.std()
    z_sim = (I - EI_sim) / max(se, 1e-300)
    p_z_sim = 1 - stats.norm.cdf(z_sim) if z_sim > 0 else stats.norm.cdf(z_sim)
    return EI_sim, p_sim, p_z_sim, z_sim


def _moran_bv(X: np.ndarray, y: np.ndarray, W: csr_matrix, permutations: Optional[int], seed: int = 0,
              device="cuda"):
    """esda Moran_BV statistics of each column of X [n, G] against y:
    (I [G], the null sim [G, P] on the host, or None without permutations)."""
    n = len(y)
    den = n - 1.0
    zy = (y - y.mean()) / y.std(ddof=1)
    ZX = np.stack([(x - x.mean()) / x.std(ddof=1) for x in (np.ascontiguousarray(c) for c in X.T)], axis=1)
    zxd = _to_device(ZX, device)
    zyd = _to_device(zy, device)
    idx, w = _csr_table(W, device)
    I = ((zxd * _neighbour_sum(zyd[None], idx, w)[0][:, None]).sum(0) / den).cpu().numpy()
    if not permutations:
        return I, None
    # I(perm) = zx' W zy_perm = (W' zx)' zy_perm
    WTzx = _csr_tensor(W.T.tocsr(), device) @ zxd  # [n, G]
    perms = _permutations(n, permutations, seed, device)
    sim = (zyd[perms] @ WTzx / den).T  # [G, P]
    return I, sim.cpu().numpy()


def spatial_bv_moran_obs_genes(
    adata: AnnData,
    obs_key: str,
    connectivity_key: str = "spatial_connectivities",
    genes: Union[str, int, Sequence[str], Sequence[int], None] = None,
    n_neighbors: int = 10,
    mode: str = "moran",
    transformation: str = "r",
    permutations: Optional[int] = 999,
    copy: bool = False,
    device="cuda",
) -> Optional[pd.DataFrame]:
    """Global bivariate Moran's I between an obs variable and gene expression
    (parity: spatial_correlation.py:12-158 — same result columns
    I/EI_sim/pval_sim/pval_z_sim/z_sim, same uns key, same gene selection),
    the products and the null on `device`."""
    if mode != "moran":
        raise ValueError(f"Unsupported mode: {mode}. Only 'moran' is currently supported")
    if obs_key not in adata.obs:
        raise KeyError(f"'{obs_key}' not found in adata.obs")

    W = _get_connectivities(adata, connectivity_key, n_neighbors, device)
    if transformation == "r":
        W = _row_standardize(W)
    y = np.asarray(adata.obs[obs_key].values, dtype=np.float64)

    var_names = list(adata.var_names)
    if genes is None:
        gene_names = var_names
        gene_indices = list(range(adata.n_vars))
    elif isinstance(genes, (str, int)):
        gene_indices = [var_names.index(genes)] if isinstance(genes, str) else [genes]
        gene_names = [genes] if isinstance(genes, str) else [var_names[genes]]
    else:
        gene_names, gene_indices = [], []
        for gene in genes:
            if isinstance(gene, str):
                gene_names.append(gene)
                gene_indices.append(var_names.index(gene))
            else:
                gene_names.append(var_names[gene])
                gene_indices.append(gene)

    X = adata.X[:, gene_indices]
    X = np.asarray(X.toarray() if hasattr(X, "toarray") else X).astype(np.float64)
    I, sim = _moran_bv(X, y, W, permutations, device=device)
    results = {"I": list(I)}
    if permutations is not None:
        results.update({"EI_sim": [], "pval_sim": [], "pval_z_sim": [], "z_sim": []})
        for g in range(len(gene_indices)):
            if sim is None:
                EI_sim = p_sim = p_z_sim = z_sim = None
            else:
                EI_sim, p_sim, p_z_sim, z_sim = _moran_bv_stats(I[g], np.ascontiguousarray(sim[g]), permutations)
            results["EI_sim"].append(EI_sim)
            results["pval_sim"].append(p_sim)
            results["pval_z_sim"].append(p_z_sim)
            results["z_sim"].append(z_sim)

    df = pd.DataFrame(results, index=gene_names)
    if copy:
        return df
    adata.uns[f"{obs_key}_gene_bv_moranI"] = df
    return None


def spatial_bv_local_moran(
    adata: AnnData,
    feature1_key: str,
    feature2_key: str,
    connectivity_key: str = "spatial_connectivities",
    n_neighbors: int = 10,
    mode: str = "moran",
    transformation: str = "r",
    permutations: Optional[int] = 999,
    copy: bool = False,
    seed: int = 0,
    device="cuda",
) -> Optional[pd.DataFrame]:
    """Local bivariate Moran between two features (obs columns or genes)
    (parity: spatial_correlation.py:160-282 — same per-site columns
    I/q/EI_sim/pval_sim/pval_z_sim/z_sim and uns key), the lag and the
    [P, n] null on `device`. Quadrant codes: 1 HH, 2 LH, 3 LL, 4 HL."""
    if mode != "moran":
        raise ValueError(f"Unsupported mode: {mode}. Only 'moran' is currently supported")
    for key in (feature1_key, feature2_key):
        if key not in adata.obs and key not in list(adata.var_names):
            raise KeyError(f"'{key}' not found in adata.obs and a gene name")

    W = _get_connectivities(adata, connectivity_key, n_neighbors, device)
    if transformation == "r":
        W = _row_standardize(W)
    x = _feature_values(adata, feature1_key)
    y = _feature_values(adata, feature2_key)
    n = len(x)
    n_1 = n - 1
    zx = (x - x.mean()) / x.std()  # esda Moran_Local_BV uses ddof=0
    zy = (y - y.mean()) / y.std()
    den = float((zx * zx).sum())
    idx, w = _csr_table(W, device)
    zxd, zyd = _to_device(zx, device), _to_device(zy, device)
    # a tensor divisor: the card divides by a scalar through its reciprocal
    den_d = torch.tensor(den, dtype=torch.float64, device=zxd.device)
    lag_d = _neighbour_sum(zyd[None], idx, w)[0]
    Is_d = n_1 * zxd * lag_d / den_d
    Is, lag = Is_d.cpu().numpy(), lag_d.cpu().numpy()

    df = pd.DataFrame(index=adata.obs_names)
    df["I"] = Is
    if permutations:
        # quadrants from the signs of zx and the spatial lag of zy
        zp = zx > 0
        lp = lag > 0
        q = np.where(zp & lp, 1, np.where(~zp & lp, 2, np.where(~zp & ~lp, 3, 4)))
        perms = _permutations(n, permutations, seed, device)
        sim = torch.empty((permutations, n), dtype=torch.float64, device=zxd.device)
        for s in range(0, permutations, PERM_CHUNK):
            sim[s : s + PERM_CHUNK] = n_1 * zxd * _neighbour_sum(zyd[perms[s : s + PERM_CHUNK]], idx, w) / den_d
        larger = (sim >= Is_d[None, :]).sum(0).cpu().numpy()
        low_extreme = (permutations - larger) < larger
        larger[low_extreme] = permutations - larger[low_extreme]
        EI_sim = sim.mean(0)
        se = sim.std(0, correction=0)
        df["q"] = q
        df["EI_sim"] = EI_sim.cpu().numpy()
        df["pval_sim"] = (larger + 1.0) / (permutations + 1.0)
        z_sim = ((Is_d - EI_sim) / torch.clamp_min(se, 1e-300)).cpu().numpy()
        df["pval_z_sim"] = 1 - stats.norm.cdf(np.abs(z_sim))
        df["z_sim"] = z_sim

    if copy:
        return df
    adata.uns[f"{feature1_key}_{feature2_key}_bv_local_moranI"] = df
    return None
