"""Alignment layer (`stt.align`): Morpho pairwise alignment, its serial-slice
entry points (`morpho_align`, `morpho_align_ref`), PASTE (`paste_align`,
`paste_align_ref`, `paste_pairwise_align`, `paste_center_align`), the
saved-field transforms (`BA_transform`, `BA_transform_and_assignment`,
`get_P_chunk`, `paste_transform`), the mapping helpers and downsampling,
ported from `spateo_tpu.alignment`. Not ported yet: mesh correction, the
deformation grids, the deprecated-API shims and `mesh=` (ROADMAP Queue 1
item 13)."""

from .methods import (
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
    downsampling,
    generate_label_transfer_dict,
    get_optimal_mapping_relationship,
    mapping_aligned_coords,
    mapping_center_coords,
    solve_RT_by_correspondence,
)
