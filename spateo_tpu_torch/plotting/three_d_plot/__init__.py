"""3D model plotting (counterpart of `spateo_tpu.plotting.three_d_plot`;
reference spateo/plotting/static/three_d_plot/__init__.py:1-22): matplotlib
mplot3d over the tdr model classes, imported inside the functions that draw.
The renderer's helpers (`three_dims_plotter`) are bound here too."""

from .three_dims_plots import (
    merge_animations,
    plot_expression_3D,
    plot_multiple_genes_3D,
    quick_plot_3D_celltypes,
    three_d_animate,
    three_d_multi_plot,
    three_d_plot,
    visualize_3D_increasing_direction_gradient,
    wrap_to_plotter,
)
from .morphometrics_plots import (
    acceleration,
    curl,
    feature,
    curvature,
    divergence,
    jacobian,
    torsion,
)
from .backbone_plots import backbone
from .align_plots import deformation, multi_models
from .pairwise_align_plots import (
    pairwise_iteration,
    pairwise_iteration_panel,
    pairwise_mapping,
    pi_heatmap,
)
from .three_dims_plotter import (
    add_legend,
    add_model,
    add_model_outline,
    add_num_legend,
    add_outline,
    add_str_legend,
    add_text,
    create_plotter,
    output_plotter,
    save_plotter,
)
