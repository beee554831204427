"""LISA (Local Indicators of Spatial Association) analyses
(capability parity: reference spateo/tools/lisa.py:21,90,322) — pysal-free.

Counterpart of `spateo_tpu.tools.lisa`. The JAX package builds the
row-standardised kNN weights as a dense [n, n] matrix from scikit-learn's
`kneighbors_graph` (3.2 GB at 20,000 cells) and forms a dense [n, n]
projection for each gene in `GM_lag_model`. The port forms neither:

- The graph is `find_neighbors.knn` on `device`: each cell's k + 1 nearest
  by (distance, index), its own entry weighted 0 where it is among them
  (else all k + 1 kept), the rest weighted 1 / count, which is what the
  zeroed diagonal and the row sums of the dense matrix give. A lag
  ``W @ z`` is then a gather and a sum over the [n, k + 1] neighbour table,
  added one neighbour column at a time (`_neighbour_sum`), so that the card
  and the CPU give the same bits.
- `_local_moran`'s permutations are drawn on the host in the JAX package's
  order. It reseeds with 0 for every gene, so every gene takes the same
  draws, drawn once here; its "conditional" permutations are full
  permutations, as in the JAX package. Lags, I, quadrants and the
  pseudo p-values of all genes are computed on `device` in float64, the
  permuted lags in [genes, permutations, cells] blocks of at most
  `LISA_CHUNK_ELEMS` entries.
- `GM_lag_model` computes ``Z_hat = H (pinv(H'H) (H'Z))`` with ``H'H`` and
  its pseudo-inverse formed once, all genes at a time in blocks.

The sums run in another order than the dense matrix products, so values
agree with the JAX package to rounding; a permuted I that ties the observed
one in exact arithmetic can fall on either side of it in either package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pandas as pd
import torch
from scipy import stats
from scipy.sparse import issparse

from ..configuration import SKM
from ..core.anndata import AnnData
from ..core.bridge import _to_device

#: Entries of one [genes, permutations, cells] block of permuted lags.
LISA_CHUNK_ELEMS = 1 << 26


def _row_std_knn_w(coords: np.ndarray, k: int, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """The row-standardised kNN weights as (neighbours [n, m] int64,
    weights [n, m] float64) on `device`, m = min(k + 1, n)."""
    from .find_neighbors import knn

    idx, _ = knn(coords, min(k + 1, len(coords)), device=device)
    nbr = _to_device(idx, device)
    not_self = nbr != torch.arange(len(idx), device=nbr.device)[:, None]
    count = not_self.sum(1, keepdim=True).to(torch.float64)
    w = not_self.to(torch.float64) / torch.clamp_min(count, 1e-12)
    return nbr, w


def _neighbour_sum(Z: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_k w[:, k] * Z[:, idx[..., k]]`` for Z [G, n] and a neighbour
    table idx [..., n, m] with weights w [n, m]: [G, ..., n]. The terms are
    added one neighbour column at a time, in column order, by elementwise
    operations only, so the card and the CPU give the same bits (a
    reduction kernel's order can differ between tensor shapes on the card,
    which breaks exact ties between an observed lag and a permuted one)."""
    out = Z[:, idx[..., 0]] * w[:, 0]
    for k in range(1, idx.shape[-1]):
        out = out + Z[:, idx[..., k]] * w[:, k]
    return out


def _lag(nbr: torch.Tensor, w: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """``W @ z`` for each row of Z [G, n]: [G, n]."""
    rows = max(1, LISA_CHUNK_ELEMS // max(Z.shape[1], 1))
    return torch.cat([_neighbour_sum(Z[s : s + rows], nbr, w) for s in range(0, len(Z), rows)])


def _zscores(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each column's z-score and second moment, computed as the JAX package
    computes one gene's (numpy's sums over a contiguous vector)."""
    n = X.shape[0]
    Z = np.empty((X.shape[1], n))
    m2 = np.empty(X.shape[1])
    for j in range(X.shape[1]):
        x = np.ascontiguousarray(X[:, j], dtype=np.float64)
        Z[j] = (x - x.mean()) / max(x.std(), 1e-30)
        m2[j] = (Z[j] ** 2).sum() / n
    return Z, m2


def _local_moran(X: np.ndarray, nbr: torch.Tensor, w: torch.Tensor, permutations: int = 199, seed: int = 0):
    """Local Moran's I of each column of X [n, G] with permutation pseudo
    p-values and quadrants: host (Is, q, p_sim, z, lag), each [G, n]."""
    n, G = X.shape
    dev = nbr.device
    Zh, m2h = _zscores(X)
    Z = _to_device(Zh, dev)
    m2 = _to_device(m2h, dev)[:, None]
    lag = _lag(nbr, w, Z)
    Is = Z * lag / m2
    # quadrants: 1=HH, 2=LH, 3=LL, 4=HL
    q = torch.where(Z > 0, torch.where(lag > 0, 1, 4), torch.where(lag > 0, 2, 3))
    rng = np.random.default_rng(seed)
    perms = _to_device(np.stack([rng.permutation(n) for _ in range(permutations)]), dev)
    pn = perms[:, nbr]  # [P, n, m]: the permuted position of each neighbour
    larger = torch.zeros((G, n), dtype=torch.int64, device=dev)
    low = torch.zeros_like(larger)
    gc = max(1, LISA_CHUNK_ELEMS // max(permutations * n, 1))
    pc = max(1, min(permutations, LISA_CHUNK_ELEMS // max(gc * n, 1)))
    for g in range(0, G, gc):
        zg, mg, ig = Z[g : g + gc], m2[g : g + gc, :, None], Is[g : g + gc, None, :]
        for p in range(0, permutations, pc):
            I_perm = zg[:, None, :] * _neighbour_sum(zg, pn[p : p + pc], w) / mg
            larger[g : g + gc] += (I_perm >= ig).sum(1)
            low[g : g + gc] += (I_perm <= ig).sum(1)
    # on the host, as the JAX package divides: the card divides by a scalar
    # through its reciprocal, one ulp away
    p_sim = (np.minimum(larger.cpu().numpy(), low.cpu().numpy()) + 1) / (permutations + 1)
    return Is.cpu().numpy(), q.cpu().numpy(), p_sim, Zh, lag.cpu().numpy()


class _LisaResult:
    def __init__(self, Is, q, p_sim):
        self.Is = Is
        self.q = q
        self.p_sim = p_sim


def lisa_geo_df(
    adata: AnnData,
    gene: str,
    spatial_key: str = "spatial",
    n_neighbors: int = 8,
    layer: Optional[str] = None,
    device="cuda",
) -> Tuple[object, pd.DataFrame]:
    """LISA quantile/hot-cold-spot table for one gene (parity: lisa.py:21),
    the graph and statistics on `device`. Returns a plain DataFrame with x/y
    columns (no geopandas dependency)."""
    coords = np.asarray(adata.obsm[spatial_key], dtype=float)
    nbr, w = _row_std_knn_w(coords, n_neighbors, device)
    df = pd.DataFrame(coords[:, :2], columns=["x", "y"])
    col = adata[:, gene].X if layer is None else adata[:, gene].layers[layer]
    vals = np.asarray(col.toarray() if issparse(col) else col, dtype=np.float64).ravel()
    if layer is not None:
        vals = np.log1p(vals)
    df["exp"] = vals
    df["w_exp"] = _lag(nbr, w, _to_device(vals[None], nbr.device))[0].cpu().numpy()
    df["exp_zscore"] = (df["exp"] - df["exp"].mean()) / df["exp"].std()
    df["w_exp_zscore"] = (df["w_exp"] - df["w_exp"].mean()) / df["w_exp"].std()
    Is, q, p_sim, _, _ = (a[0] for a in _local_moran(vals[:, None], nbr, w))
    lisa = _LisaResult(Is, q, p_sim)
    df = df.assign(Is=Is)
    q_labels = ["Q1", "Q2", "Q3", "Q4"]
    df = df.assign(labels=[q_labels[i - 1] for i in q])
    sig = 1 * (p_sim < 0.05)
    df = df.assign(sig=sig)
    spots = (
        1 * (sig * q == 1) + 3 * (sig * q == 3) + 2 * (sig * q == 2) + 4 * (sig * q == 4)
    )
    spot_labels = ["0 ns", "1 hot spot", "2 doughnut", "3 cold spot", "4 diamond"]
    df = df.assign(group=[spot_labels[i] for i in spots])
    return (lisa, df)


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def local_moran_i(
    adata: AnnData,
    group: str,
    spatial_key: str = "spatial",
    genes: Optional[list] = None,
    layer: Optional[str] = None,
    n_neighbors: int = 5,
    copy: bool = False,
    n_jobs: int = 1,
    device="cuda",
):
    """Cell-type-specific genes via local Moran hot/cold-spot composition
    (parity: lisa.py:90), every gene's statistics on `device` at once. Adds
    {spot}_num/frac/spec columns to `.var`."""
    adata = adata.copy() if copy else adata
    coords = np.asarray(adata.obsm[spatial_key], dtype=float)
    nbr, w = _row_std_knn_w(coords, n_neighbors, device)
    group_names = np.asarray(adata.obs[group])
    uniq_g = pd.unique(group_names)
    if genes is None:
        genes = (
            list(adata.var.index[adata.var["use_for_pca"]])
            if "use_for_pca" in adata.var.columns
            else list(adata.var_names)
        )
    else:
        genes = list(adata.var_names.intersection(genes))

    spot_types = {"hotspot": 1, "doughnut": 2, "coldspot": 3, "diamond": 4}
    results = {f"{s}_{suf}": [] for s in spot_types for suf in ("num_val", "frac_val", "spec_val", "num_group", "frac_group", "spec_group")}

    X = adata[:, np.asarray(genes)].X if layer is None else adata[:, np.asarray(genes)].layers[layer]
    X = X.toarray() if issparse(X) else np.asarray(X, dtype=float)
    group_sizes = {g: (group_names == g).sum() for g in uniq_g}
    _, Q, P_SIM, _, _ = _local_moran(X, nbr, w, permutations=99)
    for j, gene in enumerate(genes):
        q, p_sim = Q[j], P_SIM[j]
        sig = p_sim < 0.05
        for s_name, s_q in spot_types.items():
            in_spot = sig & (q == s_q)
            nums, fracs, specs = {}, {}, {}
            total_spot = max(in_spot.sum(), 1)
            for g in uniq_g:
                cnt = int((in_spot & (group_names == g)).sum())
                nums[g] = cnt
                fracs[g] = cnt / group_sizes[g]
                specs[g] = cnt / total_spot
            for metric, d in (("num", nums), ("frac", fracs), ("spec", specs)):
                best = max(d, key=d.get)
                results[f"{s_name}_{metric}_val"].append(d[best])
                results[f"{s_name}_{metric}_group"].append(best)
    for key, vals in results.items():
        col = pd.Series(index=adata.var_names, dtype=object)
        col.loc[genes] = vals
        adata.var[key] = col
    if copy:
        return adata


def _gm_lag_fits(H: torch.Tensor, Xbase: torch.Tensor, Y: torch.Tensor, Wy: torch.Tensor):
    """Spatial 2SLS of each column of Y on [Xbase, Wy] with instruments H,
    all columns at once in blocks: (beta [G, p], zstat [G, p]) on the host."""
    n, G = Y.shape
    HtH_inv = torch.linalg.pinv(H.T @ H, rtol=1e-15)
    p = Xbase.shape[1] + 1
    beta_out, z_out = np.empty((G, p)), np.empty((G, p))
    gc = max(1, LISA_CHUNK_ELEMS // max(4 * n * p, 1))
    for s in range(0, G, gc):
        y = Y[:, s : s + gc].T  # [g, n]
        Z = torch.cat([Xbase.expand(len(y), -1, -1), Wy[:, s : s + gc].T[:, :, None]], dim=2)  # [g, n, p]
        Z_hat = H @ (HtH_inv @ (H.T @ Z))
        Zt_hat = Z_hat.transpose(1, 2)
        beta = (torch.linalg.pinv(Zt_hat @ Z, rtol=1e-15) @ (Zt_hat @ y[:, :, None]))[:, :, 0]
        resid = y - (Z @ beta[:, :, None])[:, :, 0]
        sigma2 = (resid**2).sum(1) / max(n - p, 1)
        var_beta = sigma2[:, None, None] * torch.linalg.pinv(Zt_hat @ Z_hat, rtol=1e-15)
        se = torch.sqrt(torch.clamp_min(torch.diagonal(var_beta, dim1=1, dim2=2), 1e-30))
        beta_out[s : s + gc] = beta.cpu().numpy()
        z_out[s : s + gc] = (beta / se).cpu().numpy()
    return beta_out, z_out


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def GM_lag_model(
    adata: AnnData,
    group: str,
    spatial_key: str = "spatial",
    genes: Optional[list] = None,
    drop_dummy: Optional[str] = None,
    n_neighbors: int = 5,
    layer: Optional[str] = None,
    copy: bool = False,
    n_jobs: int = 1,
    seed: int = 0,
    device="cuda",
):
    """Spatial-lag regression y = rho W y + X beta + eps by spatial 2SLS
    (parity: lisa.py:322; native S2SLS with instruments [X, WX, W^2 X]), all
    genes on `device` in float64 with no [n, n] matrix. Adds
    {group}_GM_lag_coeff/zstat/pval columns to `.var`."""
    adata = adata.copy() if copy else adata
    rng = np.random.default_rng(seed)
    coords = np.asarray(adata.obsm[spatial_key], dtype=float)
    nbr, w = _row_std_knn_w(coords, n_neighbors, device)
    group_names = pd.Series(np.asarray(adata.obs[group]).astype(str))
    categories = list(pd.unique(group_names)) + ["others"]
    db = group_names.copy()
    group_num = group_names.value_counts()
    min_group_ncells = group_num.values[-1]
    if drop_dummy is None:
        idx = rng.choice(adata.n_obs, min_group_ncells, replace=False)
        db.iloc[idx] = "others"
    else:
        db[db == drop_dummy] = "others"
    dummies = pd.get_dummies(pd.Categorical(db, categories=categories), dtype=float)
    dummies = dummies.drop(columns=["others"], errors="ignore")
    keep_cols = list(dummies.columns)

    if genes is None:
        genes = list(adata.var_names)
    else:
        genes = list(adata.var_names.intersection(genes))
    expr = adata[:, np.asarray(genes)].X if layer is None else adata[:, np.asarray(genes)].layers[layer]
    expr = expr.toarray() if issparse(expr) else np.asarray(expr, dtype=float)
    n = adata.n_obs

    for cat in keep_cols:
        adata.var[f"{cat}_GM_lag_coeff"] = np.nan
        adata.var[f"{cat}_GM_lag_zstat"] = np.nan
        adata.var[f"{cat}_GM_lag_pval"] = np.nan

    Xd = _to_device(np.asarray(dummies.values, np.float64), nbr.device)  # [n, K]
    ones = torch.ones((n, 1), dtype=torch.float64, device=nbr.device)
    Xbase = torch.cat([ones, Xd], dim=1)
    WX = _lag(nbr, w, Xd.T).T
    WWX = _lag(nbr, w, WX.T).T
    H = torch.cat([ones, Xd, WX, WWX], dim=1)  # instruments
    Y = torch.log1p(_to_device(np.asarray(expr, np.float64), nbr.device))
    Wy = _lag(nbr, w, Y.T).T
    beta, zstat = _gm_lag_fits(H, Xbase, Y, Wy)
    pvals = 2 * stats.norm.sf(np.abs(zstat))
    for i, cat in enumerate(keep_cols):
        adata.var.loc[genes, f"{cat}_GM_lag_coeff"] = beta[:, 1 + i]
        adata.var.loc[genes, f"{cat}_GM_lag_zstat"] = zstat[:, 1 + i]
        adata.var.loc[genes, f"{cat}_GM_lag_pval"] = pvals[:, 1 + i]
    if copy:
        return adata
