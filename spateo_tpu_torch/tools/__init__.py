"""Tools layer (`stt.tl`): MuSIC (its fit path, `MuSIC_Interpreter` and
`MuSIC_Molecule_Selector`), its spatial kernel weights, the neighbour graphs,
spatial clustering (`scc` with Louvain/Leiden, `mclust_py`, SpaGCN,
k-means), UMAP, the Moran's I tests (`moran_i`, `cellbin_morani`), the
two-group CCI test, the coarse slice pre-alignment (`procrustes`,
`AffineTrans`, `pca_align`, `align_slices_pca`), PCA (`pca`, `pca_fit`) and
the shared helpers of `tools.utils`, ported from `spateo_tpu.tools`. Not
ported yet (ROADMAP Queue 1 item 11): the host tools (GLM DEGs, LISA,
spatial smoothing and correlation, cluster DEGs and lasso, the CCI
databases' niche tools and FDR, expression variance, labels, archetypes,
live wire, ROI) and t-SNE."""

from . import cci_two_cluster, find_neighbors, spatial_degs
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
from .cluster.find_clusters import smooth as smooth_labels
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
from .spatial_degs import cellbin_morani, moran_i
