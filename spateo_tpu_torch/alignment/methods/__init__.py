"""Alignment methods (counterpart of `spateo_tpu.alignment.methods`): Morpho
pairwise, PASTE, mesh correction and point-cloud sampling."""

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
from .mesh_correction import Mesh_correction
from .morpho import Morpho_pairwise, filter_common_genes, get_rep
from .paste import KLNMF, center_NMF, generalized_procrustes_analysis, paste_center_align, paste_pairwise_align
from .sampling import sample, sample_indices


def empty_cache(device="cuda"):
    """Release the caching allocator's unused device memory (the reference
    calls torch.cuda.empty_cache, reference morpho_alignment.py:109); nothing
    to do for the CPU."""
    import torch

    if torch.device(device).type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def calc_exp_dissimilarity(X_A, X_B, dissimilarity: str = "kl", device="cuda"):
    """Expression dissimilarity matrix on `device`, returned to the host
    (parity: reference methods/deprecated_utils.py `calc_exp_dissimilarity`,
    used by paste)."""
    from ...core.bridge import _to_device

    [D] = calc_distance(_to_device(X_A, device), _to_device(X_B, device), metric=dissimilarity)
    return D.cpu().numpy()
