"""Plotting (`stt.pl`; counterpart of `spateo_tpu.plotting`, reference
spateo/plotting/static/__init__.py:1-39): the same functions under the same
names. Host code: matplotlib, networkx and PIL are imported inside the
functions that draw, so `import spateo_tpu_torch.plotting` and each of its
modules load on a machine without matplotlib (the GPU machine has none), and a
plot called there raises `ModuleNotFoundError`. `pairwise_exp_similarity` is
the one plot that computes on the device (`calc_distance`, `device=`)."""

from .agg import box_qc_regions, imshow, qc_regions
from .align import (
    multi_slices,
    optimization_animation,
    overlay_slices_2d,
    plot_deformation_grid,
    slices_2d,
)
from .bbs import delaunay, polygon
from .contour import spatial_domains
from .dotplot import CCDotplot, Dotplot, dotplot
from .geo import color_label, geo, space_polygons
from .glm import glm_fit, glm_heatmap
from .interactions import ligrec, plot_connections
from .lisa import lisa, lisa_quantiles
from .networks import PlotNetwork, plot_network
from .polarity import polarity
from .scatters import plot_vectors, scatters
from .space import plot_cell_signaling, space
from .three_d_plot import (
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
    three_d_plot,
    torsion,
)
from . import colorlabel, interactive
from . import static  # noqa: F401
from .interactive import cellbin_select, contours, select_polygon
from .utils import dendrogram, map2color, save_fig, save_return_show_fig_utils
