"""Alignment layer (`stt.align`): Morpho pairwise alignment, its serial-slice
entry points (`morpho_align`, `morpho_align_ref`), the saved-field transforms
(`BA_transform`, `BA_transform_and_assignment`, `get_P_chunk`,
`paste_transform`) and downsampling, ported from `spateo_tpu.alignment`. Not
ported yet: PASTE (ROADMAP Queue 1 item 10), mesh correction, the
deformation grids and `mesh=` (item 13)."""

from .methods import Morpho_pairwise, calc_distance
from .morpho_alignment import (
    morpho_align,
    morpho_align_apply_transformation,
    morpho_align_ref,
    morpho_align_transformation,
)
from .transform import BA_transform, BA_transform_and_assignment, get_P_chunk, paste_transform
from .utils import downsampling, generate_label_transfer_dict, solve_RT_by_correspondence
