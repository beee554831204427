"""Spatial archetypal analysis (capability parity: reference
spateo/tools/architype.py:22-214, after Nitzan et al.).

Counterpart of `spateo_tpu.tools.architype`: host code, copied.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
from scipy.cluster import hierarchy
from scipy.sparse import issparse
from scipy.stats import pearsonr

from ..configuration import SKM
from ..core.anndata import AnnData
from ..logging import logger_manager as lm


def find_spatial_archetypes(num_clusters: int, exp_mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ward-cluster genes into archetypes (parity: architype.py:22).

    Returns (archetypes [k, n_cells], clusters [n_genes], gene_corrs) —
    the per-gene correlations computed vectorized."""
    exp_mat = np.asarray(exp_mat, dtype=float)
    clusters = hierarchy.fcluster(hierarchy.ward(exp_mat), num_clusters, criterion="maxclust")
    archetypes = np.array([exp_mat[clusters == xi].mean(axis=0) for xi in range(1, num_clusters + 1)])
    # vectorized per-gene Pearson with own archetype
    arch_per_gene = archetypes[clusters - 1]  # [n_genes, n_cells]
    gz = (exp_mat - exp_mat.mean(1, keepdims=True)) / np.maximum(exp_mat.std(1, keepdims=True), 1e-30)
    az = (arch_per_gene - arch_per_gene.mean(1, keepdims=True)) / np.maximum(arch_per_gene.std(1, keepdims=True), 1e-30)
    gene_corrs = (gz * az).mean(axis=1)
    lm.main_info("done!")
    return archetypes, clusters, gene_corrs


def get_genes_from_spatial_archetype(
    exp_mat: np.ndarray,
    gene_names,
    archetypes: np.ndarray,
    archetype: int,
    pval_threshold: float = 0,
):
    """Best-representative genes of one archetype (parity: architype.py:50)."""
    exp_mat = np.asarray(exp_mat, dtype=float)
    gene_names = np.asarray(gene_names)
    corrs = np.zeros(len(exp_mat))
    pvals = np.ones(len(exp_mat))
    for g in range(len(exp_mat)):
        if exp_mat[g].std() == 0:
            continue
        corrs[g], pvals[g] = pearsonr(exp_mat[g], archetypes[archetype])
    mask = corrs > 0
    sig = pvals[mask] <= pval_threshold
    if not sig.any():
        lm.main_warning("No genes with significant correlation were found at the current p-value threshold.")
        return None
    return gene_names[mask][sig]


def find_spatially_related_genes(exp_mat, gene_names, archetypes, gene: int, pval_threshold: float = 0):
    """Genes co-varying spatially with a query gene (parity: architype.py:89)."""
    exp_mat = np.asarray(exp_mat, dtype=float)
    arch_corrs = np.array([pearsonr(exp_mat[gene], a)[0] for a in archetypes])
    if np.max(arch_corrs) < 0.7:
        lm.main_warning("No significant correlation between the gene and the spatial archetypes was found.")
        return None
    return get_genes_from_spatial_archetype(
        exp_mat, gene_names, archetypes, int(np.argmax(arch_corrs)), pval_threshold=pval_threshold
    )


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def archetypes(adata: AnnData, moran_i_genes: Union[np.ndarray, list], num_clusters: int = 5, layer: Optional[str] = None) -> np.ndarray:
    """Archetypes of spatially-variable genes; scores per cell stored in
    `.obsm['archetype']` (parity: architype.py:124)."""
    sub = adata[:, np.asarray(moran_i_genes)]
    X = sub.X if layer is None else sub.layers[layer]
    X = (X.toarray() if issparse(X) else np.asarray(X, dtype=float)).T  # genes x cells
    X = (X - X.mean(1, keepdims=True)) / np.maximum(X.std(1, keepdims=True), 1e-30)
    arch, clusters, corrs = find_spatial_archetypes(num_clusters, X)
    adata.obsm["archetype"] = arch.T
    adata.uns["archetypes_clusters"] = clusters
    return arch


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def archetypes_genes(adata: AnnData, archetypes: np.ndarray, num_clusters: int, moran_i_genes, layer: Optional[str] = None) -> dict:
    """Genes most representative of each archetype (parity: architype.py:165)."""
    sub = adata[:, np.asarray(moran_i_genes)]
    X = sub.X if layer is None else sub.layers[layer]
    X = (X.toarray() if issparse(X) else np.asarray(X, dtype=float)).T
    X = (X - X.mean(1, keepdims=True)) / np.maximum(X.std(1, keepdims=True), 1e-30)
    out = {}
    for i in range(num_clusters):
        genes = get_genes_from_spatial_archetype(X, np.asarray(moran_i_genes), archetypes, i, pval_threshold=0.05)
        out[i] = genes if genes is not None else []
    return out
