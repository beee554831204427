"""Tools layer (`stt.tl`): MuSIC's fit path, its spatial kernel weights, the
Moran's I test, the coarse slice pre-alignment (`procrustes`,
`AffineTrans`, `pca_align`, `align_slices_pca`) and PCA, ported from
`spateo_tpu.tools`. Clustering, DEGs, the other spatial statistics, CCI
helpers, UMAP and t-SNE, `MuSIC_Interpreter` and `MuSIC_Molecule_Selector`
are not ported yet (ROADMAP Queue 1 items 8b and 11)."""

from . import find_neighbors, spatial_degs
from .CCI_effects_modeling import SWR, MuSIC, define_spateo_argparse, distributions, regression_utils
from .coarse_align import AffineTrans, align_slices_pca, pca_align, procrustes
from .dimensionality_reduction import pca
from .find_neighbors import Kernel, calculate_distance, get_wi, get_wi_batch, local_dist
from .spatial_degs import moran_i
