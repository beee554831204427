"""Reference-named package alias (counterpart of
`spateo_tpu.plotting.static`; reference plotting/static/) — every static
plotting module lives flat under `spateo_tpu_torch.plotting`."""

from .. import agg, align, bbs, contour, dotplot, geo, glm, interactions, lisa, networks, polarity, scatters, space  # noqa: F401
from .. import three_d_plot  # noqa: F401

from ..agg import box_qc_regions, imshow, qc_regions
from ..align import optimization_animation, overlay_slices_2d, plot_deformation_grid, slices_2d
from ..bbs import delaunay, polygon
from ..contour import spatial_domains
from ..geo import color_label
from ..glm import glm_fit, glm_heatmap
from ..interactions import ligrec, plot_connections
from ..lisa import lisa_quantiles
from ..three_d_plot import (
    acceleration,
    backbone,
    curl,
    curvature,
    deformation,
    divergence,
    jacobian,
    merge_animations,
    multi_models,
    pairwise_iteration,
    pairwise_iteration_panel,
    pairwise_mapping,
    pi_heatmap,
    three_d_animate,
    three_d_multi_plot,
    torsion,
)
