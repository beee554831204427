"""Digitization (`stt.dd`): spatial-domain layers and columns by the heat
equation, the counterpart of `spateo_tpu.digitization` with the same names.
The entry points that solve or label take ``device=`` (default ``"cuda"``).
"""

from . import boundary as boundary_old  # reference-named alias (boundary_old.py)
from . import utils as utils_old  # reference-named alias (utils_old.py)
from .borderline import get_borderline, grid_borderline
from .boundary import boundary_gridding, format_boundary_line, identify_boundary
from .contour import extract_cluster_contours, gen_cluster_image, set_domains
from .grid import digitize, gridit
from .utils import (
    add_ep_boundary,
    add_gp_boundary,
    calc_op_field,
    digitize_general,
    domain_heat_eqn_solver,
    draw_seg_grid,
    effective_L2_error,
    euclidean_dist,
    extend_layer,
    field_contour_line,
    field_contours,
    fill_grid_label,
    order_borderline,
    segment_bd_line,
)
