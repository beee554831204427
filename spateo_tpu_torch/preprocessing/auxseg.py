"""Auxiliary segmentation: live-wire tracing for manual boundary drawing
(parity: reference spateo/preprocessing/auxseg.py:8-212).

The shortest-path engine is shared with `tools/live_wire` (vectorized grid
graph + scipy dijkstra instead of the reference's Python double loop over
the `dijkstar` package). This module adds the auxseg-flavored interactive
workflow: a stateful tracer with `connect()`-wired matplotlib callbacks,
DDA straight-line mode (hold "s"), ctrl+z undo, and closed-contour filling
into `self.rst` when the trace returns to its starting point.

Counterpart of `spateo_tpu.preprocessing.auxseg`: host code, copied, on
the port's `tools.live_wire`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..tools.live_wire import LiveWireSegmentation as _LiveWireBase
from ..tools.live_wire import compute_shortest_path  # noqa: F401  (parity re-export)

__all__ = ["LiveWireSegmentation", "compute_shortest_path"]


class LiveWireSegmentation(_LiveWireBase):
    """Interactive live-wire tracer (parity surface: reference
    auxseg.py:8 — same attributes/callbacks; engine from tools/live_wire)."""

    def __init__(self, image=None, smooth_image: bool = False, threshold_gradient_image: bool = False):
        super().__init__(image=image, smooth_image=smooth_image, threshold_gradient_image=threshold_gradient_image)
        self.current_point = None
        self.path: Optional[np.ndarray] = None
        self.current_path_plot = None
        self.point_list: List = []
        self.point_plot_list: List = []
        self.path_list = np.empty(shape=[0, 2], dtype="int")
        self.path_plot_list: List = []
        self._segment_lengths: List[int] = []  # rows committed per segment (for undo)
        self.rst: Optional[np.ndarray] = None

    # the auxseg API returns ndarray paths (reference auxseg.py:126-135)
    def compute_shortest_path(self, startPt, endPt) -> np.ndarray:  # type: ignore[override]
        return np.asarray(super().compute_shortest_path(tuple(startPt), tuple(endPt)), dtype=int)

    @staticmethod
    def LineDDA(start, end) -> np.ndarray:
        """Digital differential analyzer straight-line rasterization
        (reference auxseg.py:137-162) — used for the hold-"s" straight
        segment mode."""
        start_x, start_y = start[0], start[1]
        end_x, end_y = end[0], end[1]
        delta_x = end_x - start_x
        delta_y = end_y - start_y
        steps = abs(delta_x) if abs(delta_x) > abs(delta_y) else abs(delta_y)
        x_step = delta_x / (steps + 1e-9)
        y_step = delta_y / (steps + 1e-9)
        x, y = float(start_x), float(start_y)
        points = []
        while steps >= 0:
            points.append([round(x), round(y)])
            x += x_step
            y += y_step
            steps -= 1
        return np.array(points)

    @staticmethod
    def fill_contours(arr) -> np.ndarray:
        """All pixels inside a closed contour, by horizontal run filling
        (reference auxseg.py:164-170)."""
        img = np.zeros(shape=[np.max(arr[:, 0]) + 1, np.max(arr[:, 1]) + 1], dtype="uint8")
        for line in arr:
            img[line[0], line[1]] = 1
        img_full = np.maximum.accumulate(img, 1) & np.maximum.accumulate(img[:, ::-1], 1)[:, ::-1]
        return np.array(np.where(img_full == 1)).T

    def connect(self):
        """Wire the tracer into the current pyplot figure (reference
        auxseg.py:172-175)."""
        import matplotlib.pyplot as plt

        plt.connect("button_release_event", self.button_pressed)
        plt.connect("motion_notify_event", self.mouse_moved)
        plt.connect("key_press_event", self.key_pressed)

    def button_pressed(self, event):
        import matplotlib.pyplot as plt

        if event.ydata is None or event.xdata is None:
            return
        self.current_point = (int(event.ydata), int(event.xdata))
        self.point_list.append(self.current_point)
        self.point_plot_list.extend(plt.plot([event.xdata], [event.ydata], marker="o", color="k"))
        if len(self.point_list) > 1 and self.path is not None:
            self.path_list = np.row_stack((self.path_list, self.path))
            self._segment_lengths.append(len(self.path))
            self.path_plot_list.extend(plt.plot(self.path[:, 1], self.path[:, 0]))
            first_point = self.point_list[0]
            # closing the loop within 2 px finishes the trace: the filled
            # contour interior lands in self.rst and the figure closes
            if np.sum((np.array(self.current_point) - np.array(first_point)) ** 2) ** 0.5 <= 2:
                path_final = self.compute_shortest_path(self.current_point, first_point)
                path_rst = np.row_stack((self.path_list, path_final))
                self.rst = self.fill_contours(path_rst)
                plt.close()
        plt.draw()

    def mouse_moved(self, event):
        import matplotlib.pyplot as plt

        if self.current_point is None or event.ydata is None or event.xdata is None:
            return
        mouse_point = (int(event.ydata), int(event.xdata))
        if event.key == "s":
            self.path = self.LineDDA(self.current_point, mouse_point)
        else:
            self.path = self.compute_shortest_path(self.current_point, mouse_point)
        if self.current_path_plot is not None:
            self.current_path_plot.pop(0).remove()
        if len(self.path):
            self.current_path_plot = plt.plot(self.path[:, 1], self.path[:, 0])
        else:
            self.current_path_plot = None
        plt.draw()

    def key_pressed(self, event):
        if event.key == "ctrl+z" and len(self.point_list) > 1:
            self.point_plot_list.pop(-1).remove()
            if self.path_plot_list:
                self.path_plot_list.pop(-1).remove()
            self.point_list.pop(-1)
            self.current_point = self.point_list[-1]
            if self._segment_lengths:
                # drop exactly the last COMMITTED segment (self.path may
                # hold an unrelated live preview at undo time)
                seg_len = self._segment_lengths.pop()
                self.path_list = self.path_list[: len(self.path_list) - seg_len]
