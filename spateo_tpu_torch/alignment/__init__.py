"""Alignment layer (`stt.align`): Morpho pairwise alignment and its
serial-slice entry points, ported from `spateo_tpu.alignment`. Not ported
yet: `morpho_align_ref` and `BA_transform` (alignment/transform.py), PASTE,
mesh correction, the deformation and downsampling utilities, and `mesh=`."""

from .methods import Morpho_pairwise, calc_distance
from .morpho_alignment import (
    morpho_align,
    morpho_align_apply_transformation,
    morpho_align_transformation,
)
from .utils import generate_label_transfer_dict, solve_RT_by_correspondence
