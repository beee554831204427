"""Line/arrow model primitives (capability parity: reference
spateo/tdr/models/models_migration/ line/arrow constructors) — pyvista-free
polyline containers. A copy of
`spateo_tpu.tdr.models.models_migration.primitives`."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np

from ..mesh_core import PointCloud


class LineModel(PointCloud):
    """Polyline set: points + [E, 2] segment indices."""

    def __init__(self, points, lines, point_data=None):
        super().__init__(points, point_data)
        self.lines = np.asarray(lines, dtype=int)


def _label_model(model: LineModel, key_added, label, color, alpha):
    """Reference labeling step shared by every constructor (e.g.
    arrow_model.py:87-99): key_added=None skips labeling; otherwise the label
    is attached per point with a resolved RGBA column and the recommended
    plot_cmap is returned."""
    if key_added is None:
        return None
    from ..utilities.label_utils import add_model_labels

    labels = np.asarray(label) if not isinstance(label, str) else np.asarray([label] * model.n_points)
    if labels.ndim == 0 or len(labels) != model.n_points:
        labels = np.resize(labels, model.n_points)
    _, plot_cmap = add_model_labels(
        model=model, key_added=key_added, labels=labels, where="point_data",
        colormap=color, alphamap=alpha, inplace=True,
    )
    return plot_cmap


def construct_line(
    start_point,
    end_point,
    key_added: Optional[str] = "line",
    label: str = "line",
    color: str = "gainsboro",
    alpha: float = 1.0,
) -> Tuple[LineModel, Optional[str]]:
    """A 3D line model (parity: reference line_model.py:33-71 — same
    key_added/label/color/alpha labeling and (model, plot_cmap) return)."""
    pts = np.stack([np.asarray(start_point, float), np.asarray(end_point, float)])
    m = LineModel(pts, np.array([[0, 1]]))
    return m, _label_model(m, key_added, label, color, alpha)


def construct_lines(
    points: np.ndarray,
    edges: np.ndarray,
    key_added: Optional[str] = "line",
    label: Union[str, list, np.ndarray] = "lines",
    color: Union[str, list, dict] = "gainsboro",
    alpha: Union[float, list, dict] = 1.0,
) -> Tuple[LineModel, Optional[str]]:
    """A 3D lines model (parity: reference line_model.py:74-116)."""
    m = LineModel(np.asarray(points, float), np.asarray(edges, int))
    return m, _label_model(m, key_added, label, color, alpha)


def _arrow_geometry(start_point: np.ndarray, direction: np.ndarray, scale: float = 1.0) -> LineModel:
    """An arrow as a shaft polyline + head segments."""
    start = np.asarray(start_point, float)
    d = np.asarray(direction, float) * scale
    tip = start + d
    # head: two short back-swept segments in a plane orthogonal-ish to d
    norm = np.linalg.norm(d) + 1e-12
    ortho = np.cross(d, [0, 0, 1.0]) if len(d) == 3 else np.array([-d[1], d[0]])
    if np.linalg.norm(ortho) < 1e-9:
        ortho = np.cross(d, [0, 1.0, 0])
    ortho = ortho / (np.linalg.norm(ortho) + 1e-12) * 0.15 * norm
    back = tip - 0.25 * d
    pts = np.stack([start, tip, back + ortho, back - ortho])
    lines = np.array([[0, 1], [1, 2], [1, 3]])
    return LineModel(pts, lines)


def construct_arrow(
    start_point,
    direction,
    arrow_scale: Optional[Union[int, float]] = None,
    key_added: Optional[str] = "arrow",
    label: str = "arrow",
    color: str = "gainsboro",
    alpha: float = 1.0,
    **kwargs,
) -> Tuple[LineModel, Optional[str]]:
    """A single 3D arrow model (parity: reference arrow_model.py:55-99 —
    arrow_scale None means 'auto', scaled to the direction's length)."""
    m = _arrow_geometry(start_point, direction, scale=1.0 if arrow_scale is None else float(arrow_scale))
    return m, _label_model(m, key_added, label, color, alpha)


def construct_arrows(
    start_points: np.ndarray,
    direction: np.ndarray = None,
    arrows_scale: Optional[np.ndarray] = None,
    n_sampling: Optional[int] = None,
    sampling_method: str = "random",
    factor: float = 1.0,
    key_added: Optional[str] = "arrow",
    label: Union[str, list, np.ndarray] = "arrows",
    color: Union[str, list, dict, np.ndarray] = "gainsboro",
    alpha: Union[float, list, dict, np.ndarray] = 1.0,
    **kwargs,
) -> Tuple[LineModel, Optional[str]]:
    """Arrow field from per-point vectors (parity: reference
    arrow_model.py:102-160 — key_added/label/color/alpha labeling; the
    vector magnitudes additionally ride along as point_data['vmag'])."""
    start_points = np.asarray(start_points, float)
    direction = np.asarray(direction, float)
    if n_sampling:
        from ....alignment.methods.sampling import sample_indices

        idx = sample_indices(start_points, n_sampling, method=sampling_method)
        start_points, direction = start_points[idx], direction[idx]
    scale = np.ones(len(start_points)) if arrows_scale is None else np.asarray(arrows_scale, float)
    all_pts, all_lines, vmag = [], [], []
    offset = 0
    for p, d, s in zip(start_points, direction, scale):
        a = _arrow_geometry(p, d, scale=factor * s)
        all_pts.append(a.points)
        all_lines.append(a.lines + offset)
        vmag.extend([np.linalg.norm(d)] * len(a.points))
        offset += len(a.points)
    model = LineModel(np.concatenate(all_pts), np.concatenate(all_lines))
    model["vmag"] = np.asarray(vmag)
    return model, _label_model(model, key_added, label, color, alpha)


def generate_edges(points1: np.ndarray, points2: np.ndarray):
    """Pairwise connecting segments between two matched point sets
    (parity: reference models_migration/line_model.py generate_edges)."""
    points1 = np.asarray(points1, float)
    points2 = np.asarray(points2, float)
    assert points1.shape == points2.shape
    n = len(points1)
    pts = np.concatenate([points1, points2], axis=0)
    edges = np.stack([np.arange(n), np.arange(n) + n], axis=1)
    return pts, edges


def construct_align_lines(
    model1_points: np.ndarray,
    model2_points: np.ndarray,
    key_added: str = "check_alignment",
    label: Union[str, list, np.ndarray] = "align_mapping",
    color: Union[str, list, dict, np.ndarray] = "gainsboro",
    alpha: Union[float, list, dict, np.ndarray] = 1.0,
) -> Tuple[LineModel, Optional[str]]:
    """Mapping lines between two aligned models (parity: reference
    line_model.py:134-163 — delegates to construct_lines with the full
    key_added/label/color/alpha contract)."""
    pts, edges = generate_edges(model1_points, model2_points)
    return construct_lines(points=pts, edges=edges, key_added=key_added, label=label, color=color, alpha=alpha)


def construct_axis_line(
    axis_points: np.ndarray,
    key_added: str = "axis",
    label: str = "axis_line",
    color: str = "gainsboro",
    alpha: Union[float, int, list, dict, np.ndarray] = 1.0,
) -> Tuple[LineModel, Optional[str]]:
    """Axis line spanning the extent of ordered axis points (parity:
    reference line_model.py:165-196: the line runs from the coordinate-wise
    min to the max of `axis_points`)."""
    axis_points = np.asarray(axis_points, float)
    start_point = axis_points.min(axis=0)
    end_point = axis_points.max(axis=0)
    return construct_line(start_point, end_point, key_added=key_added, label=label, color=color, alpha=alpha)
