"""Tools layer (`stt.tl`): MuSIC (its fit path, `MuSIC_Interpreter` and
`MuSIC_Molecule_Selector`), its spatial kernel weights, the Moran's I test,
the coarse slice pre-alignment (`procrustes`, `AffineTrans`, `pca_align`,
`align_slices_pca`), PCA (`pca`, `pca_fit`) and the shared helpers of
`tools.utils`, ported from `spateo_tpu.tools`. Clustering, DEGs, the other
spatial statistics, CCI helpers, UMAP and t-SNE are not ported yet (ROADMAP
Queue 1 item 11)."""

from . import find_neighbors, spatial_degs
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
from .dimensionality_reduction import pca, pca_fit
from .find_neighbors import Kernel, calculate_distance, get_wi, get_wi_batch, local_dist
from .spatial_degs import moran_i
