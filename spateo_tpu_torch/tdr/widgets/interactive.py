"""Interactive clip / pick / slice rendering loops.

Capability parity with reference spateo/tdr/widgets/{clip,pick,slice}.py
(pyvista plotter callbacks: interactive_rectangle_clip clip.py:62,
_interactive_pick pick.py:14, three_d_slice slice.py:124). The pyvista
event loop is replaced by matplotlib widgets over the framework's 3D
renderer: a RectangleSelector-driven clip, a LassoSelector-driven pick and
a Slider-driven slicer. Every callback is a plain method so the loops are
drivable both by live mouse events and programmatically (headless tests,
notebooks without a display). A copy of `spateo_tpu.tdr.widgets.interactive`,
with matplotlib imported inside the classes and functions that draw, since
the GPU machine has none.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ...logging import logger_manager as lm
from ...plotting.utils import _pyplot
from .ops import _subset

_AXES = {"x": 0, "y": 1, "z": 2}


def _project_axes(coords: np.ndarray, plane: str) -> Tuple[np.ndarray, np.ndarray]:
    a, b = plane[0], plane[1]
    return coords[:, _AXES[a]], coords[:, _AXES[b]]


class InteractiveRectangleClip:
    """Rectangle-clip loop (parity: reference clip.py:62
    `interactive_rectangle_clip`): drag a rectangle on a 2D projection of
    the model; the clipped submodel accumulates in `.picked_models`.

    Use `.onselect_extents(xmin, xmax, ymin, ymax)` to drive headless."""

    def __init__(
        self,
        model,
        key: Optional[str] = None,
        plane: str = "xy",
        invert: bool = False,
        model_style: str = "points",
        model_size: float = 8.0,
        colormap: str = "Spectral",
        bg_model=None,
    ):
        from matplotlib.widgets import RectangleSelector

        plt = _pyplot()
        self.model = model
        self.invert = invert
        self.plane = plane
        coords = np.asarray(model.points, float)
        self._px, self._py = _project_axes(coords, plane)
        self.picked_models: List = []
        self.fig, self.ax = plt.subplots(figsize=(5, 5))
        if bg_model is not None:
            # static context model drawn underneath (reference clip.py:69)
            bx, by = _project_axes(np.asarray(bg_model.points, float), plane)
            self.ax.scatter(bx, by, s=2, c="gainsboro", linewidths=0, zorder=0)
        colors = None
        if key is not None and key in getattr(model, "point_data", {}):
            vals = np.asarray(model.point_data[key])
            colors = vals.astype(float) if np.issubdtype(vals.dtype, np.number) else None
        marker = {"points": "o", "surface": "s", "wireframe": "+"}.get(model_style, "o")
        self.ax.scatter(self._px, self._py, s=model_size, c=colors, cmap=colormap, marker=marker, linewidths=0)
        self.ax.set_aspect("equal")
        self.selector = RectangleSelector(self.ax, self._on_event, useblit=False, interactive=True)

    def _on_event(self, eclick, erelease):
        x0, x1 = sorted([eclick.xdata, erelease.xdata])
        y0, y1 = sorted([eclick.ydata, erelease.ydata])
        self.onselect_extents(x0, x1, y0, y1)

    def onselect_extents(self, xmin: float, xmax: float, ymin: float, ymax: float):
        inside = (self._px >= xmin) & (self._px <= xmax) & (self._py >= ymin) & (self._py <= ymax)
        keep = ~inside if self.invert else inside
        sub = _subset(self.model, keep)
        self.picked_models.append(sub)
        lm.main_info(f"rectangle clip kept {int(keep.sum())} / {len(keep)} points")
        return sub


class InteractiveLassoPick:
    """Lasso-pick loop (parity: reference pick.py:14 `_interactive_pick` /
    three_d_pick): draw a polygon on a 2D projection; points inside are
    picked. Use `.onselect(vertices)` to drive headless."""

    def __init__(self, model, key: Optional[str] = None, plane: str = "xy"):
        from matplotlib.widgets import LassoSelector

        plt = _pyplot()
        self.model = model
        coords = np.asarray(model.points, float)
        self._px, self._py = _project_axes(coords, plane)
        self.picked_models: List = []
        self.fig, self.ax = plt.subplots(figsize=(5, 5))
        self.ax.scatter(self._px, self._py, s=4, linewidths=0)
        self.ax.set_aspect("equal")
        self.selector = LassoSelector(self.ax, self.onselect)

    def onselect(self, verts: Sequence[Tuple[float, float]]):
        from matplotlib.path import Path as MplPath

        path = MplPath(list(verts))
        inside = path.contains_points(np.c_[self._px, self._py])
        sub = _subset(self.model, inside)
        self.picked_models.append(sub)
        lm.main_info(f"lasso pick selected {int(inside.sum())} / {len(inside)} points")
        return sub


class InteractiveSlicer:
    """Slider-driven slicing plane (parity: reference slice.py:124
    `three_d_slice` interactive variant): a Slider moves an axis-aligned
    plane; the current slab renders highlighted in the 3D view. Use
    `.set_position(v)` to drive headless; `.current_slice` holds the slab
    submodel."""

    def __init__(self, model, key: Optional[str] = None, axis: str = "x", thickness: Optional[float] = None):
        from matplotlib.widgets import Slider

        plt = _pyplot()
        self.model = model
        self.axis = _AXES[axis]
        coords = np.asarray(model.points, float)
        self._coords = coords
        lo, hi = coords[:, self.axis].min(), coords[:, self.axis].max()
        self.thickness = thickness if thickness is not None else (hi - lo) / 10
        self.fig = plt.figure(figsize=(6, 6))
        self.ax = self.fig.add_subplot(111, projection="3d")
        from ...plotting.three_d_plot.three_dims_plotter import add_model

        add_model(self.ax, model, key=key, model_style="points", model_size=2, opacity=0.15)
        self._highlight = None
        ax_slider = self.fig.add_axes([0.2, 0.02, 0.6, 0.03])
        self.slider = Slider(ax_slider, axis, lo, hi, valinit=(lo + hi) / 2)
        self.slider.on_changed(self.set_position)
        self.current_slice = None
        self.set_position((lo + hi) / 2)

    def set_position(self, value: float):
        in_slab = np.abs(self._coords[:, self.axis] - value) <= self.thickness / 2
        self.current_slice = _subset(self.model, in_slab)
        if self._highlight is not None:
            self._highlight.remove()
        pts = self._coords[in_slab]
        self._highlight = self.ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=6, color="tab:red", linewidths=0) if len(pts) else None
        return self.current_slice


def interactive_rectangle_clip(
    model,
    key: Optional[str] = None,
    model_style: str = "points",
    model_size: float = 8.0,
    colormap: str = "Spectral",
    invert: bool = False,
    bg_model=None,
    plane: str = "xy",
    bounds=None,
):
    """Front-end matching the reference clip.py:62 API (key / model_style /
    model_size / colormap / invert / bg_model): when `bounds` is given,
    clips immediately (headless); otherwise returns the live widget loop
    for mouse-driven clipping."""
    widget = InteractiveRectangleClip(
        model, key=key, plane=plane, invert=invert,
        model_style=model_style, model_size=model_size, colormap=colormap, bg_model=bg_model,
    )
    if bounds is not None:
        xmin, xmax, ymin, ymax = bounds
        widget.onselect_extents(xmin, xmax, ymin, ymax)
        _pyplot().close(widget.fig)
        return widget.picked_models[-1]
    return widget


def interactive_pick(
    model,
    key: Optional[str] = None,
    checkbox_size: int = 27,
    label_size: int = 12,
    plane: str = "xy",
    polygon=None,
):
    """Front-end matching the reference pick.py:14-95 API (checkbox_size/
    label_size are the reference's pyvista widget-geometry knobs, accepted
    for signature parity — the mpl lasso loop has no checkboxes): with
    `polygon`, picks immediately; otherwise returns the live lasso loop."""
    widget = InteractiveLassoPick(model, key=key, plane=plane)
    if polygon is not None:
        widget.onselect(polygon)
        _pyplot().close(widget.fig)
        return widget.picked_models[-1]
    return widget


def interactive_slice(model, key: Optional[str] = None, axis: str = "x", position=None, thickness=None):
    """Front-end matching the reference slice.py API: with `position`,
    slices immediately; otherwise returns the live slider loop."""
    widget = InteractiveSlicer(model, key=key, axis=axis, thickness=thickness)
    if position is not None:
        out = widget.set_position(position)
        _pyplot().close(widget.fig)
        return out
    return widget
