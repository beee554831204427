"""Cluster marker genes (capability parity: reference
spateo/tools/cluster_degs.py:26,109,389,506).

Vectorized redesign: all per-gene statistics (expression ratios, log2 fold
changes, specificity scores, Mann-Whitney U with tie-corrected normal
p-values) are computed for EVERY gene at once with rank matrices — replacing
the reference's per-gene Python loop (cluster_degs.py:211-300).

Counterpart of `spateo_tpu.tools.cluster_degs`: host code, copied, but for
the spatial kNN of `find_spatial_cluster_degs`, which is
`find_neighbors.knn` on `device` in place of scikit-learn's
`NearestNeighbors`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pandas as pd
from scipy import stats
from scipy.sparse import issparse

from ..core.anndata import AnnData
from ..logging import logger_manager as lm
from ..svg.utils import multipletests_bh


def _dense(X):
    return X.toarray() if issparse(X) else np.asarray(X, dtype=float)


def _mannwhitney_batch(X_test: np.ndarray, X_control: np.ndarray) -> np.ndarray:
    """Two-sided Mann-Whitney U p-values for every column (normal approx with
    tie correction)."""
    n1, n2 = X_test.shape[0], X_control.shape[0]
    combined = np.concatenate([X_test, X_control], axis=0)
    ranks = stats.rankdata(combined, axis=0)
    R1 = ranks[:n1].sum(axis=0)
    U1 = R1 - n1 * (n1 + 1) / 2
    mu = n1 * n2 / 2
    n = n1 + n2
    # tie correction per gene
    tie_term = np.zeros(combined.shape[1])
    for j in range(combined.shape[1]):
        _, counts = np.unique(combined[:, j], return_counts=True)
        tie_term[j] = (counts**3 - counts).sum()
    sigma = np.sqrt(n1 * n2 / 12 * ((n + 1) - tie_term / (n * (n - 1))))
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (U1 - mu) / np.maximum(sigma, 1e-12)
    p = 2 * stats.norm.sf(np.abs(z))
    p[sigma == 0] = 1.0
    return np.clip(p, 0, 1)


def _specificity_scores(all_vals: np.ndarray, mask: np.ndarray) -> tuple:
    """(pearson, cosine) similarity of each gene to an indicator pattern."""
    v = all_vals
    ind = mask.astype(float)[:, None]
    vc = v - v.mean(0, keepdims=True)
    ic = ind - ind.mean()
    denom = np.sqrt((vc**2).sum(0)) * np.sqrt((ic**2).sum())
    pearson = np.where(denom > 0, (vc * ic).sum(0) / np.maximum(denom, 1e-30), 0.0)
    denom_c = np.sqrt((v**2).sum(0)) * np.sqrt((ind**2).sum())
    cosine = np.where(denom_c > 0, (v * ind).sum(0) / np.maximum(denom_c, 1e-30), 0.0)
    return pearson, cosine


def find_cluster_degs(
    adata: AnnData,
    test_group: str,
    control_groups: List[str],
    genes: Optional[List[str]] = None,
    layer: Optional[str] = None,
    X_data: Optional[np.ndarray] = None,
    group: Optional[str] = None,
    qval_thresh: float = 0.05,
    ratio_expr_thresh: float = 0.1,
    diff_ratio_expr_thresh: float = 0,
    log2fc_thresh: float = 0,
    method: str = "multiple",
) -> pd.DataFrame:
    """Markers of `test_group` vs `control_groups` (reference-exact:
    cluster_degs.py:109-384 — same statistics, gene skip rule, column set
    incl. combined_score, BH domain, qval sort and final thresholds).

    Statistics are vectorized over genes where exact (ratios, specificity
    scores, JSD with scipy-entropy normalization semantics, log2fc); the
    Mann-Whitney p-value uses scipy's mannwhitneyu per gene exactly as the
    reference's loop does."""
    if method not in ("multiple", "pairwise"):
        raise ValueError("`method` must be 'multiple' or 'pairwise'")
    if isinstance(control_groups, str):
        control_groups = [control_groups]
    groups = np.asarray(adata.obs[group])
    test_cells = groups == test_group
    control_cells = np.isin(groups, control_groups)
    genes = list(adata.var_names) if genes is None else list(genes)
    if X_data is None:
        X_data = adata[:, np.asarray(genes)].X if layer is None else adata[:, np.asarray(genes)].layers[layer]
    X = _dense(X_data)

    num_groups = len(control_groups)
    num_cells = X.shape[0]
    num_test = int(test_cells.sum())
    num_control = int(control_cells.sum())
    X_test = X[test_cells]
    X_ctrl = X[control_cells]

    # vectorized per-gene statistics ---------------------------------------
    ratio_expr_all = (X_test != 0).sum(0) / num_test
    keep = ratio_expr_all >= ratio_expr_thresh  # reference :221 skip rule

    # JSD to the perfect-specificity distribution, with scipy.stats.entropy
    # normalization semantics (reference :227-232: perc and M are each
    # normalized to sum 1 INSIDE entropy, M built from the raw fractions)
    perc_rows = [(X_test != 0).sum(0) / num_cells]
    perc_rows += [(X[groups == g] != 0).sum(0) / num_cells for g in control_groups]
    perc = np.stack(perc_rows)  # [G+1, genes]
    perc_spec = np.zeros((num_groups + 1, 1))
    perc_spec[0] = 1.0
    M = (perc + perc_spec) / 2
    with np.errstate(divide="ignore", invalid="ignore"):
        p_n = perc / np.maximum(perc.sum(0, keepdims=True), 1e-300)
        q_n = np.broadcast_to(perc_spec, M.shape)
        m_n = M / np.maximum(M.sum(0, keepdims=True), 1e-300)
        kl_pm = np.nansum(np.where(p_n > 0, p_n * np.log(p_n / np.maximum(m_n, 1e-300)), 0.0), axis=0)
        kl_qm = np.nansum(np.where(q_n > 0, q_n * np.log(q_n / np.maximum(m_n, 1e-300)), 0.0), axis=0)
    jsd_adj_score = 1 - 0.5 * (kl_pm + kl_qm)

    pearson_test, cosine_test = _specificity_scores(X, test_cells)
    test_mean = X_test.mean(0) + 1e-9

    def _scores_against(mask):
        pearson_control, cosine_control = _specificity_scores(X, mask)
        with np.errstate(divide="ignore", invalid="ignore"):
            pearson_score = np.power(pearson_test, 3) / (
                np.power(pearson_control, 2) + np.power(pearson_test, 2)
            )
            cosine_score = np.power(cosine_test, 3) / (
                np.power(cosine_control, 2) + np.power(cosine_test, 2)
            )
        return pearson_score, cosine_score

    def _pvals_against(Xg):
        out = np.ones(X.shape[1])
        any_nz = (Xg != 0).any(0)
        for j in np.where(keep)[0]:
            if any_nz[j]:
                out[j] = stats.mannwhitneyu(X_test[:, j], Xg[:, j])[1]
        return out

    de_frames = []
    if method == "multiple":
        control_mean = X_ctrl.mean(0) + 1e-9
        log2fc = np.log2(test_mean / control_mean + 10e-5)
        pvals = _pvals_against(X_ctrl)
        diff_ratio_expr = ratio_expr_all - (X_ctrl != 0).sum(0) / num_control
        pearson_score, cosine_score = _scores_against(control_cells)
        with np.errstate(divide="ignore", invalid="ignore"):
            combined = (
                -log2fc * np.log(pvals) * ratio_expr_all * diff_ratio_expr
                * pearson_score * cosine_score * jsd_adj_score
            )
        de_frames.append(
            pd.DataFrame(
                {
                    "gene": np.asarray(genes, object),
                    "control_group": [control_groups] * len(genes),
                    "log2fc": log2fc,
                    "pval": pvals,
                    "ratio_expr": ratio_expr_all,
                    "diff_ratio_expr": diff_ratio_expr,
                    "person_score": pearson_score,
                    "cosine_score": cosine_score,
                    "jsd_adj_score": jsd_adj_score,
                    "combined_score": combined,
                }
            )[keep]
        )
    else:
        for g in control_groups:
            mask_g = groups == g
            Xg = X[mask_g]
            control_mean = Xg.mean(0) + 1e-9
            log2fc = np.log2(test_mean / control_mean + 10e-5)
            pvals = _pvals_against(Xg)
            diff_ratio_expr = ratio_expr_all - (Xg != 0).sum(0) / len(Xg)
            pearson_score, cosine_score = _scores_against(mask_g)
            with np.errstate(divide="ignore", invalid="ignore"):
                combined = (
                    -log2fc * np.log(pvals) * ratio_expr_all * diff_ratio_expr
                    * pearson_score * cosine_score * jsd_adj_score
                )
            de_frames.append(
                pd.DataFrame(
                    {
                        "gene": np.asarray(genes, object),
                        "control_group": g,
                        "log2fc": log2fc,
                        "pval": pvals,
                        "ratio_expr": ratio_expr_all,
                        "diff_ratio_expr": diff_ratio_expr,
                        "person_score": pearson_score,
                        "cosine_score": cosine_score,
                        "jsd_adj_score": jsd_adj_score,
                        "combined_score": combined,
                    }
                )[keep]
            )
    de = pd.concat(de_frames, ignore_index=True)

    if de.shape[0] > 1:
        de["qval"] = multipletests_bh(de["pval"].values)
    else:
        de["qval"] = [np.nan for _ in range(de.shape[0])]
    de["test_group"] = test_group
    out_order = [
        "gene", "test_group", "control_group", "ratio_expr", "diff_ratio_expr",
        "person_score", "cosine_score", "jsd_adj_score", "log2fc",
        "combined_score", "pval", "qval",
    ]
    de = de[out_order].sort_values(by="qval")
    de = de[
        (de.qval < qval_thresh) & (de.diff_ratio_expr > diff_ratio_expr_thresh) & (de.log2fc > log2fc_thresh)
    ].reset_index(drop=True)
    return de


def find_all_cluster_degs(
    adata: AnnData,
    group: str,
    genes: Optional[List[str]] = None,
    layer: Optional[str] = None,
    X_data: Optional[np.ndarray] = None,
    copy: bool = True,
    n_jobs: int = 1,
    **kwargs,
) -> AnnData:
    """Markers for every cluster vs the rest (parity: cluster_degs.py:389)."""
    adata = adata.copy() if copy else adata
    cluster_set = np.unique(np.asarray(adata.obs[group]))
    if len(cluster_set) < 2:
        raise ValueError(f"the number of groups for the argument {group} must be at least two.")
    de_tables = {}
    de_genes = {}
    for test_group in cluster_set:
        controls = [g for g in cluster_set if g != test_group]
        table = find_cluster_degs(
            adata, test_group, controls, genes=genes, layer=layer, X_data=X_data, group=group, **kwargs
        )
        de_tables[test_group] = table
        de_genes[test_group] = list(table["gene"])
    adata.uns["cluster_markers"] = {"deg_tables": de_tables, "de_genes": de_genes}
    return adata


def find_spatial_cluster_degs(
    adata: AnnData,
    test_group: str,
    x: Optional[List[int]] = None,
    y: Optional[List[int]] = None,
    group: Optional[str] = None,
    genes: Optional[List[str]] = None,
    k: int = 10,
    ratio_thresh: float = 0.5,
    device="cuda",
) -> pd.DataFrame:
    """Markers of a spatially-defined group vs its spatially-adjacent
    neighborhood (parity: cluster_degs.py:26): control = clusters whose cells
    are frequently within the test group's spatial KNN, found on `device`
    by `find_neighbors.knn` (ties at the k-th distance by index)."""
    coords = np.asarray(adata.obsm["spatial"], dtype=float)
    if x is not None:
        coords = np.c_[np.asarray(x), np.asarray(y)]
    groups = np.asarray(adata.obs[group])
    test_cells = groups == test_group
    from .find_neighbors import knn

    idx, _ = knn(coords, min(k + 1, adata.n_obs), device=device, Y=coords[test_cells])
    neigh_groups = groups[idx[:, 1:].ravel()]
    uniq, counts = np.unique(neigh_groups, return_counts=True)
    frac = counts / counts.sum()
    control_groups = [g for g, f in zip(uniq, frac) if g != test_group and f > (1 - ratio_thresh) / max(len(uniq), 1)]
    if not control_groups:
        control_groups = [g for g in uniq if g != test_group]
    return find_cluster_degs(adata, test_group, control_groups, group=group, genes=genes)


def top_n_degs(
    adata: AnnData,
    group: str,
    custom_score_func: Optional[callable] = None,
    sort_by: str = "log2fc",
    top_n_genes: int = 10,
    only_deg_list: bool = True,
):
    """Top-n markers per cluster from `find_all_cluster_degs` output
    (parity: cluster_degs.py:506)."""
    if "cluster_markers" not in adata.uns:
        raise ValueError("Run `find_all_cluster_degs` with `copy=False` first.")
    tables = adata.uns["cluster_markers"]["deg_tables"]
    frames = []
    for g, table in tables.items():
        t = table.copy()
        if custom_score_func is not None:
            t["custom_score"] = custom_score_func(t)
        frames.append(t)
    deg_table = pd.concat(frames, ignore_index=True)
    key = sort_by if custom_score_func is None else "custom_score"
    # per-group nlargest (modern pandas groupby.apply drops the grouping
    # column, so select explicitly)
    deg_table = pd.concat(
        [deg_table[deg_table["test_group"] == g].nlargest(top_n_genes, key) for g in deg_table["test_group"].unique()],
        ignore_index=True,
    )
    if only_deg_list:
        return {
            grp: deg_table[deg_table["test_group"] == grp]["gene"].to_list()
            for grp in deg_table["test_group"].unique()
        }
    return deg_table
