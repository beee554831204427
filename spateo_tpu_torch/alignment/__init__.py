"""Alignment layer (`stt.align`): Morpho pairwise alignment, its serial-slice
entry points (`morpho_align`, `morpho_align_ref`), PASTE (`paste_align`,
`paste_align_ref`, `paste_pairwise_align`, `paste_center_align`), mesh
correction (`Mesh_correction`, its cost tables on the device), the
saved-field transforms (`BA_transform`, `BA_transform_and_assignment`,
`get_P_chunk`, `paste_transform`), the deformation grids, the mapping,
rigid, TPS and label-prior utilities and downsampling, ported from
`spateo_tpu.alignment`; the deprecated-API shims are in
`methods.deprecated_morpho`. `morpho_align(mesh=)` and
`Morpho_pairwise(mesh=)` split the moving slice's rows over the ranks of a
`torch.distributed` mesh."""

from .deformation import grid_deformation
from .methods import (
    Mesh_correction,
    Morpho_pairwise,
    calc_distance,
    calc_exp_dissimilarity,
    empty_cache,
    generalized_procrustes_analysis,
    paste_center_align,
    paste_pairwise_align,
)
from .morpho_alignment import (
    morpho_align,
    morpho_align_apply_transformation,
    morpho_align_ref,
    morpho_align_transformation,
)
from .paste_alignment import paste_align, paste_align_ref
from .transform import BA_transform, BA_transform_and_assignment, get_P_chunk, paste_transform
from .utils import (
    align_preprocess,
    downsampling,
    generate_label_transfer_dict,
    generate_label_transfer_prior,
    get_labels_based_on_coords,
    get_optimal_mapping_relationship,
    group_pca,
    mapping_aligned_coords,
    mapping_center_coords,
    rigid_transformation,
    solve_RT_by_correspondence,
    split_slice,
    tps_deformation,
)
