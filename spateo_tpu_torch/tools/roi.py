"""Manual region-of-interest segmentation by boundary drawing
(capability parity: reference spateo/tools/roi.py — a cv2 GUI script whose
capability is: draw boundary lines on an image, flood-fill the enclosed
regions into labeled masks, export the masks. Re-designed as a class with a
programmatic API (usable headless) plus an optional matplotlib front end,
instead of cv2 windows + module-level globals).

Counterpart of `spateo_tpu.tools.roi`: host code, copied; matplotlib and
imageio are imported inside the functions that draw and read.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _draw_line(mask: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], value: int = 1, width: int = 2):
    """Rasterize a line segment into `mask` (Bresenham with thickness)."""
    r0, c0 = int(p0[0]), int(p0[1])
    r1, c1 = int(p1[0]), int(p1[1])
    n = max(abs(r1 - r0), abs(c1 - c0), 1)
    rr = np.linspace(r0, r1, n + 1).round().astype(int)
    cc = np.linspace(c0, c1, n + 1).round().astype(int)
    h, w = mask.shape
    half = max(width // 2, 0)
    for dr in range(-half, half + 1):
        for dc in range(-half, half + 1):
            r = np.clip(rr + dr, 0, h - 1)
            c = np.clip(cc + dc, 0, w - 1)
            mask[r, c] = value


class ROIAnnotator:
    """Draw closed boundaries over an image and label the enclosed regions.

    Programmatic workflow (headless):
        roi = ROIAnnotator(img)
        roi.add_boundary([(r0, c0), (r1, c1), ...])   # polyline, auto-closed
        labels = roi.fill_regions()                    # labeled region mask
    """

    def __init__(self, image: np.ndarray, line_width: int = 2):
        self.image = np.asarray(image)
        self.line_width = line_width
        self.boundary = np.zeros(self.image.shape[:2], np.uint8)
        self.paths: List[np.ndarray] = []

    def add_boundary(self, points, close: bool = True):
        """Add a polyline boundary ([(row, col), ...]); closed by default."""
        pts = np.asarray(points, float)
        if len(pts) < 2:
            raise ValueError("a boundary needs at least 2 points")
        for a, b in zip(pts[:-1], pts[1:]):
            _draw_line(self.boundary, a, b, 1, self.line_width)
        if close:
            _draw_line(self.boundary, pts[-1], pts[0], 1, self.line_width)
        self.paths.append(pts)

    def fill_regions(self, min_area: int = 1) -> np.ndarray:
        """Label the connected regions delimited by the drawn boundaries
        (the reference's flood-fill step). Region 0 is the one touching the
        image border (background); boundary pixels get the label of their
        nearest region."""
        from scipy import ndimage

        free = self.boundary == 0
        labels, n = ndimage.label(free)
        # region containing the border = background (0)
        border_labels = np.unique(np.concatenate([labels[0], labels[-1], labels[:, 0], labels[:, -1]]))
        out = np.zeros_like(labels)
        next_id = 1
        for l in range(1, n + 1):
            if l in border_labels:
                continue
            m = labels == l
            if m.sum() < min_area:
                continue
            out[m] = next_id
            next_id += 1
        # assign boundary pixels to the nearest labeled region
        if (self.boundary > 0).any() and next_id > 1:
            _, (ir, ic) = ndimage.distance_transform_edt(self.boundary > 0, return_indices=True)
            bmask = self.boundary > 0
            out[bmask] = out[ir[bmask], ic[bmask]]
        return out

    def region_masks(self) -> List[np.ndarray]:
        """One boolean mask per labeled region."""
        labels = self.fill_regions()
        return [labels == l for l in range(1, labels.max() + 1)]

    def annotate(self):
        """Matplotlib front end: left-click adds boundary points, Enter
        closes the current boundary, Escape finishes."""
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 7))
        ax.imshow(self.image, cmap="gray")
        current: List[Tuple[float, float]] = []

        def on_click(event):
            if event.ydata is None:
                return
            current.append((event.ydata, event.xdata))
            ax.plot(event.xdata, event.ydata, "r.", ms=4)
            if len(current) > 1:
                (r0, c0), (r1, c1) = current[-2], current[-1]
                ax.plot([c0, c1], [r0, r1], "r-", lw=1)
            fig.canvas.draw_idle()

        def on_key(event):
            if event.key == "enter" and len(current) >= 2:
                self.add_boundary(list(current))
                (r0, c0), (r1, c1) = current[-1], current[0]
                ax.plot([c0, c1], [r0, r1], "r-", lw=1)
                current.clear()
                fig.canvas.draw_idle()

        fig.canvas.mpl_connect("button_press_event", on_click)
        fig.canvas.mpl_connect("key_press_event", on_key)
        plt.show()
        return self


def img_segmentation(image: np.ndarray, boundaries: Optional[List[np.ndarray]] = None) -> np.ndarray:
    """One-shot: rasterize `boundaries` over `image` and return the labeled
    region mask (parity surface: reference roi.py:176 `img_segmentation`)."""
    roi = ROIAnnotator(image)
    for b in boundaries or []:
        roi.add_boundary(b)
    return roi.fill_regions()


# -- reference-named functional front ends (reference tools/roi.py is a
# cv2-window script built on module-level globals; here each name binds to
# the equivalent ROIAnnotator operation so scripted workflows keep working) -

_active_roi: Optional[ROIAnnotator] = None
_current_line: List[Tuple[float, float]] = []


def draw_init(img, img_2=None, img_mask=None) -> ROIAnnotator:
    """Start an annotation session (parity: reference roi.py:156)."""
    global _active_roi, _current_line
    _active_roi = ROIAnnotator(np.asarray(img))
    _current_line = []
    return _active_roi


def line_mode(x, y) -> None:
    """Append a boundary vertex (parity: reference roi.py:7)."""
    _current_line.append((y, x))
    if len(_current_line) > 1 and _active_roi is not None:
        _draw_line(_active_roi.boundary, _current_line[-2], _current_line[-1], 1, _active_roi.line_width)


def drag_mode(x, y) -> None:
    """Continuous drawing while dragging (parity: reference roi.py:34)."""
    line_mode(x, y)


def add_contours(img=None):
    """Close the current boundary into the annotator (parity: roi.py:228)."""
    global _current_line
    if _active_roi is not None and len(_current_line) >= 2:
        _active_roi.add_boundary(list(_current_line))
    _current_line = []
    return _active_roi


def extend_contours():
    """Finalize all drawn contours (parity: roi.py:196)."""
    return add_contours()


def mask_fill(x=None, y=None, fill_mode=None) -> np.ndarray:
    """Flood-fill the enclosed regions (parity: roi.py:63)."""
    if _active_roi is None:
        raise RuntimeError("call draw_init first")
    return _active_roi.fill_regions()


def fill_mask_color() -> np.ndarray:
    """Labeled region image (parity: roi.py:214)."""
    return mask_fill()


def save_draw(path: str = "roi_labels.npy") -> str:
    """Persist the labeled regions (parity: roi.py:223)."""
    labels = mask_fill()
    np.save(path, labels)
    return path


def clear(img=None, img_2=None, contours_all=None) -> None:
    """Reset the session (parity: roi.py:238)."""
    global _active_roi, _current_line
    if _active_roi is not None:
        _active_roi = ROIAnnotator(_active_roi.image, _active_roi.line_width)
    _current_line = []


def mouse_event(event, x, y, flags=None, param=None) -> None:
    """cv2-style mouse callback shim (parity: roi.py:117)."""
    line_mode(x, y)


def main(image=None, boundaries=None) -> np.ndarray:
    """Scripted entry point (parity: roi.py:418): rasterize boundaries over
    an image and return the labeled regions."""
    return img_segmentation(image if image is not None else np.zeros((100, 100)), boundaries)


def readData(filepath: str = "."):
    """Load images for annotation (parity: reference roi.py:132; cv2.imread
    replaced by imageio over the directory's image files)."""
    import os as _os

    import imageio.v2 as imageio

    files = sorted(
        f for f in _os.listdir(filepath) if f.lower().endswith((".png", ".tif", ".tiff", ".jpg", ".jpeg"))
    )
    return [np.asarray(imageio.imread(_os.path.join(filepath, f))) for f in files]
