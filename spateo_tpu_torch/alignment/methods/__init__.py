"""Alignment methods ported so far (Morpho pairwise)."""

from .math import (
    calc_distance,
    calc_probability,
    con_K,
    euc_dist,
    get_P_core,
    inlier_from_NN,
    kl_dist,
    normalize_coords,
    voxel_data,
)
from .morpho import Morpho_pairwise, filter_common_genes, get_rep
