"""3D model plotting (counterpart of `spateo_tpu.plotting.three_d_plot`):
only the renderer is ported, `three_dims_plotter` (the widgets draw with its
`add_model`); the plots built on it are ROADMAP Queue 1 item 15."""

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
