"""Reference-named module alias: the mesh-correction helpers live in
`mesh_correction.py` (the reference keeps them in a separate
mesh_correction_utils.py)."""

from .mesh_correction import (  # noqa: F401
    ICP,
    _calculate_loss,
    _extract_contour_alpha_shape,
    _extract_contour_opencv,
    _extract_contours_from_mesh,
    _generate_labeling,
    _getUnaries,
    _make_pairs,
    _smooth_contours,
    _transform_points,
    _update_parameter,
)
from ..utils import solve_RT_by_correspondence  # noqa: F401
