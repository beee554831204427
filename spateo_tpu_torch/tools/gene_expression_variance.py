"""Gene-expression variance analysis (capability parity: reference
spateo/tools/gene_expression_variance.py:24-520).

Counterpart of `spateo_tpu.tools.gene_expression_variance`: host code,
copied; matplotlib is imported inside `plot_variance_decomposition` only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import pandas as pd
from scipy import stats
from scipy.sparse import issparse

from ..core.anndata import AnnData
from ..logging import logger_manager as lm


def compute_gene_groups_p_val(gene: str, group1: AnnData, group2: AnnData) -> Tuple[str, float]:
    """Mann-Whitney U between two groups for one gene (parity: gev.py:24)."""
    x1 = np.asarray(group1[:, gene].X.todense() if issparse(group1.X) else group1[:, gene].X).ravel()
    x2 = np.asarray(group2[:, gene].X.todense() if issparse(group2.X) else group2[:, gene].X).ravel()
    try:
        p = stats.mannwhitneyu(x1, x2)[1]
    except ValueError:
        p = 1.0
    return gene, float(p)


def get_highvar_genes(
    expression,
    expected_fano_threshold: Optional[float] = None,
    numgenes: Optional[int] = None,
    minimal_mean: float = 0.5,
) -> Tuple[pd.DataFrame, dict]:
    """Fano-factor-based highly-variable genes (parity: gev.py:45)."""
    E = np.asarray(expression, dtype=float)
    mu = E.mean(axis=0)
    var = E.var(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        fano = np.where(mu > 0, var / mu, 0)
    eligible = mu > minimal_mean
    # expected fano from a rolling regression fano ~ a*mu + b among eligible
    A = np.c_[mu[eligible], np.ones(eligible.sum())]
    coef, *_ = np.linalg.lstsq(A, fano[eligible], rcond=None)
    fano_expected = coef[0] * mu + coef[1]
    ratio = np.where(fano_expected > 0, fano / np.maximum(fano_expected, 1e-12), 0)
    if numgenes is not None:
        thresh_idx = np.argsort(-ratio)[:numgenes]
        high_var = np.zeros(len(mu), bool)
        high_var[thresh_idx] = True
    else:
        T = expected_fano_threshold or (1.0 + np.std(ratio[eligible]))
        high_var = (ratio > T) & eligible
    df = pd.DataFrame(
        {"mean": mu, "var": var, "fano": fano, "expected_fano": fano_expected, "high_var": high_var}
    )
    return df, {"N": len(mu), "num_high_var": int(high_var.sum())}


def get_highvar_genes_sparse(expression, **kwargs):
    """Sparse-input variant (parity: gev.py:114)."""
    E = np.asarray(expression.todense()) if issparse(expression) else np.asarray(expression)
    return get_highvar_genes(E, **kwargs)


def compute_variance_decomposition(
    adata: AnnData,
    spatial_label_id: str,
    celltype_label_id: str,
    genes: Optional[List[str]] = None,
    figsize: Optional[tuple] = None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
) -> pd.DataFrame:
    """Decompose expression variance into intra-cell-type, inter-cell-type
    (niche), and residual components (parity: gev.py:197-316, including the
    figsize / save_show_or_return / save_kwargs rendering options — a
    non-'return' mode draws the stacked fraction barplot)."""
    sub = adata if genes is None else adata[:, np.asarray(genes)]
    X = np.asarray(sub.X.todense() if issparse(sub.X) else sub.X, dtype=float)
    spatial = np.asarray(adata.obs[spatial_label_id]).astype(str)
    ct = np.asarray(adata.obs[celltype_label_id]).astype(str)
    total_mean = X.mean(axis=0)
    total_var = ((X - total_mean) ** 2).sum(axis=0)

    # decompose: total = between-celltype + between-spatial(within ct) + residual
    between_ct = np.zeros_like(total_var)
    between_niche = np.zeros_like(total_var)
    residual = np.zeros_like(total_var)
    for c in np.unique(ct):
        m_ct = ct == c
        mu_ct = X[m_ct].mean(axis=0)
        between_ct += m_ct.sum() * (mu_ct - total_mean) ** 2
        for s in np.unique(spatial[m_ct]):
            m_cs = m_ct & (spatial == s)
            if m_cs.sum() == 0:
                continue
            mu_cs = X[m_cs].mean(axis=0)
            between_niche += m_cs.sum() * (mu_cs - mu_ct) ** 2
            residual += ((X[m_cs] - mu_cs) ** 2).sum(axis=0)
    out = pd.DataFrame(
        {
            "total_variance": total_var,
            "intercelltype_variance": between_ct,
            "interniche_variance": between_niche,
            "intrinsic_variance": residual,
        },
        index=sub.var_names,
    )
    for col in out.columns[1:]:
        out[col.replace("_variance", "_fraction")] = out[col] / np.maximum(out["total_variance"], 1e-12)
    if save_show_or_return != "return":
        plot_variance_decomposition(out, figsize=figsize or (6, 4), save_show_or_return=save_show_or_return, **(save_kwargs or {}))
    return out


def genewise_variance_decomposition(
    adata: AnnData,
    celltype_label_id: str,
    genes: List[str],
    figsize: Optional[tuple] = None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    spatial_label_id: Optional[str] = None,
) -> pd.DataFrame:
    """Per-gene variance decomposition (parity: gev.py:319-... — the
    reference's signature has no spatial key: intra- vs inter-cell-type
    variance only; a synthetic single-region label realizes that here. An
    optional trailing spatial_label_id keeps region-aware calls working."""
    if spatial_label_id is None:
        adata = adata.copy()
        adata.obs["_one_region"] = "all"
        spatial_label_id = "_one_region"
    return compute_variance_decomposition(
        adata, spatial_label_id, celltype_label_id, genes=genes, figsize=figsize,
        save_show_or_return=save_show_or_return, save_kwargs=save_kwargs,
    )


def plot_variance_decomposition(decomposition_df, figsize=(6, 2), save_show_or_return: str = "return", **kwargs):
    """Stacked barplot of per-gene variance fractions (parity: reference
    gene_expression_variance.py plot_variance_decomposition)."""
    import matplotlib.pyplot as plt

    df = decomposition_df.copy()
    frac_cols = [c for c in df.columns if "frac" in c or "ratio" in c] or list(df.columns[:2])
    df = df.sort_values(frac_cols[0], ascending=False)
    _, ax = plt.subplots(figsize=figsize)
    bottom = np.zeros(len(df))
    for c in frac_cols:
        ax.bar(range(len(df)), df[c].values, bottom=bottom, label=c)
        bottom += np.asarray(df[c].values, float)
    ax.set_xticks(range(len(df)))
    ax.set_xticklabels(df.index, rotation=90, fontsize=6)
    ax.set_ylabel("variance fraction")
    ax.legend(fontsize=7, frameon=False)
    return ax
