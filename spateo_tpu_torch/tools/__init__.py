"""Tools layer (`stt.tl`): MuSIC (its fit path, `MuSIC_Interpreter` and
`MuSIC_Molecule_Selector`), its spatial kernel weights, the neighbour graphs,
spatial clustering (`scc` with Louvain/Leiden, `mclust_py`, SpaGCN,
k-means), UMAP, the Moran's I tests (`moran_i`, `cellbin_morani`), the
two-group CCI test, the coarse slice pre-alignment (`procrustes`,
`AffineTrans`, `pca_align`, `align_slices_pca`), PCA (`pca`, `pca_fit`),
the shared helpers of `tools.utils`, and the host tools: cluster and GLM
DEGs, LISA and the spatial-lag model, bivariate Moran, smoothing, the CCI
databases' niche tools and FDR, expression variance, labels, archetypes,
the lasso, live wire and ROI, ported from `spateo_tpu.tools`. LISA,
bivariate Moran and the spatial DEGs' kNN run on the card, and so does
t-SNE (`perform_dimensionality_reduction(reduction_method="tsne")`,
scikit-learn's Barnes-Hut solver ported in `_tsne`)."""

from . import cci_fdr, cci_two_cluster, find_neighbors, spatial_degs
from .architype import (
    archetypes,
    archetypes_genes,
    find_spatial_archetypes,
    find_spatially_related_genes,
    get_genes_from_spatial_archetype,
)
from .cci_two_cluster import find_cci_two_group, prepare_cci_cellpair_adata, prepare_cci_df
from .cluster import (
    CAST,
    calculate_leiden_partition,
    calculate_louvain_partition,
    cluster_spagcn,
    compute_pca_components,
    ecp_silhouette,
    find_clusters,
    integrate,
    kmeans_clustering,
    leiden,
    mclust_py,
    pca_spateo,
    pearson_residuals,
    pySTAGATE,
    scc,
    spagcn_pyg,
    spagcn_utils,
    spagcn_vanilla,
    spatial_adj,
)
from .cell_communication import niches, predict_ligand_activities, predict_target_genes
from .cluster.find_clusters import smooth as smooth_labels
from .cluster_degs import find_all_cluster_degs, find_cluster_degs, find_spatial_cluster_degs, top_n_degs
from .cluster_lasso import Lasso
from .CCI_effects_modeling import (
    SWR,
    MuSIC,
    MuSIC_downstream,
    MuSIC_Interpreter,
    MuSIC_Molecule_Selector,
    MuSIC_upstream,
    define_spateo_argparse,
    distributions,
    regression_utils,
)
from .coarse_align import AffineTrans, align_slices_pca, pca_align, procrustes
from .dimensionality_reduction import pca, pca_fit, perform_dimensionality_reduction
from .find_neighbors import (
    Kernel,
    calculate_distance,
    construct_nn_graph,
    get_wi,
    get_wi_batch,
    local_dist,
    neighbors,
)
from .gene_expression_variance import (
    compute_gene_groups_p_val,
    compute_variance_decomposition,
    genewise_variance_decomposition,
    get_highvar_genes,
    get_highvar_genes_sparse,
)
from .glm import glm_degs
from .labels import Label, create_label_class, expand_labels, match_label_series, match_labels, row_normalize
from .lisa import GM_lag_model, lisa_geo_df, local_moran_i
from .live_wire import LiveWireSegmentation, compute_shortest_path, live_wire
from .roi import ROIAnnotator, img_segmentation
from .spatial_correlation import spatial_bv_local_moran, spatial_bv_moran_obs_genes
from .spatial_degs import cellbin_morani, moran_i
from .spatial_smooth import smooth
