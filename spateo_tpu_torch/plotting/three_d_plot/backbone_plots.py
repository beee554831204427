"""Backbone visualization (counterpart of
`spateo_tpu.plotting.three_d_plot.backbone_plots`; reference
spateo/plotting/static/three_d_plot/backbone_plots.py:16 `backbone`).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

from .three_dims_plots import three_d_plot
from ..utils import _pyplot


def backbone(
    backbone_model,
    backbone_key: str = "backbone",
    backbone_model_size: Union[float, Sequence[float]] = 8.0,
    backbone_colormap: Optional[str] = None,
    backbone_model_color: str = "orangered",
    backbone_opacity: float = 1.0,
    nodes_key: Optional[str] = "nodes",
    nodes_label_size: float = 18.0,
    bg_model=None,
    bg_key: Optional[str] = None,
    bg_model_style: str = "points",
    bg_model_size: Union[float, Sequence[float]] = 2.0,
    bg_colormap: Optional[str] = "rainbow",
    bg_model_color: Optional[str] = None,
    bg_opacity: float = 0.3,
    filename: Optional[str] = None,
    jupyter: Union[bool, str] = False,
    **kwargs,
):
    """Plot a SimplePPT/PrinCurve backbone over its source point cloud
    (parity: reference backbone_plots.py:16 — backbone wireframe colored
    by `backbone_key`, node indices from ``point_data[nodes_key]`` drawn
    as text labels, background cells at `bg_opacity`)."""
    models = []
    styles = []
    sizes = []
    cmaps = []
    keys = []
    opac = []
    if bg_model is not None:
        models.append(bg_model)
        styles.append(bg_model_style)
        sizes.append(bg_model_size)
        cmaps.append(bg_colormap)
        keys.append(bg_key)
        opac.append(bg_opacity)
    models.append(backbone_model)
    styles.append("wireframe")
    sizes.append(backbone_model_size)
    cmaps.append(backbone_colormap)
    keys.append(backbone_key if backbone_key in getattr(backbone_model, "point_data", {}) else None)
    opac.append(backbone_opacity)
    fig = three_d_plot(
        models, key=keys, filename=None, jupyter=jupyter, colormap=cmaps,
        opacity=opac, model_style=styles, model_size=sizes, **kwargs,
    )
    if nodes_key is not None and nodes_key in getattr(backbone_model, "point_data", {}):
        # reference p.add_point_labels (backbone_plots.py:145): one text
        # label per backbone node, always visible
        import numpy as np

        ax = fig.axes[0]
        pts = np.asarray(backbone_model.points, dtype=float)
        labels = np.asarray(backbone_model.point_data[nodes_key])
        for p, lab in zip(pts, labels):
            ax.text(p[0], p[1], p[2], str(lab), fontsize=nodes_label_size / 2.0, ha="center")
    if filename:
        fig.savefig(filename, dpi=150, bbox_inches="tight")
        plt = _pyplot()

        plt.close(fig)
        return filename
    return fig
