"""Headless model-editing operations (counterpart of
`spateo_tpu.tdr.widgets.ops`; reference spateo/tdr/widgets/{clip,pick,slice}.py
-- the pyvista widgets' geometry, applicable without a display).

`points_inside_mesh` runs on the device: the same +x ray and Moller-Trumbore
test (``|a| > 1e-12``, ``t > 1e-9``) and crossing parity as the JAX
package's numpy, in float64, over [point-chunk, faces] blocks of at most
`PIM_ELEMS` pairs (about 80 bytes a pair at the peak), with one copy of the
mask back. `overlap_pc_pick`, `overlap_mesh_pick` and `overlap_pick` take
it; the clipping, slicing and picking by coordinates and the geometry
helpers are the JAX package's host code, copied.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ...logging import logger_manager as lm
from ..models.mesh_core import Mesh, PointCloud

#: [points, faces] pairs a block of `points_inside_mesh`.
PIM_ELEMS = 1 << 25


def _subset(model: PointCloud, keep: np.ndarray) -> PointCloud:
    out = PointCloud(model.points[keep], {k: np.asarray(v)[keep] for k, v in model.point_data.items()})
    return out


def clip_models(
    model: PointCloud,
    plane_origin: Optional[np.ndarray] = None,
    plane_normal: np.ndarray = (1.0, 0.0, 0.0),
    invert: bool = False,
) -> PointCloud:
    """Clip a model by a plane (parity surface: widgets/clip.py:62)."""
    origin = np.asarray(plane_origin if plane_origin is not None else model.points.mean(0), float)
    normal = np.asarray(plane_normal, float)
    side = (model.points - origin) @ normal >= 0
    return _subset(model, ~side if invert else side)


def slice_models(
    model: PointCloud,
    axis: Union[int, str] = 0,
    n_slices: int = 10,
) -> List[PointCloud]:
    """Cut a model into parallel slabs (parity surface: widgets/slice.py:124)."""
    axis = {"x": 0, "y": 1, "z": 2}.get(axis, axis)
    vals = model.points[:, axis]
    edges = np.linspace(vals.min(), vals.max() + 1e-9, n_slices + 1)
    return [_subset(model, (vals >= a) & (vals < b)) for a, b in zip(edges[:-1], edges[1:])]


def pick_models(
    model: PointCloud,
    key: str,
    picked_groups: Union[str, list],
) -> PointCloud:
    """Select sub-model by group labels (parity surface: widgets/pick.py:14)."""
    groups = np.asarray(model.point_data[key]).astype(str)
    picked = [picked_groups] if isinstance(picked_groups, str) else list(picked_groups)
    return _subset(model, np.isin(groups, [str(g) for g in picked]))


def interactive_pick(model: PointCloud, key: str = "groups", predicate: Optional[Callable[[np.ndarray], np.ndarray]] = None) -> PointCloud:
    """Programmatic stand-in for the interactive picker: select by a
    coordinate predicate (the reference's display-based picker is a non-goal
    headless)."""
    if predicate is None:
        return model.copy()
    keep = np.asarray(predicate(model.points), dtype=bool)
    return _subset(model, keep)


# -- reference-named front ends (reference tdr/widgets/{clip,pick,slice}.py;
# pyvista interactive widgets are replaced by programmatic predicates plus
# the matplotlib lasso/polygon selectors in st.pl.interactive) ------------


def three_d_pick(model, key: str = "groups", picked_groups=None):
    """Pick submodels by group value (parity: reference widgets/pick.py
    three_d_pick)."""
    groups = np.asarray(model.point_data[key]).astype(str)
    wanted = set(map(str, np.atleast_1d(picked_groups))) if picked_groups is not None else set(groups)
    return [_subset(model, groups == g) for g in sorted(wanted)]


def points_inside_mesh(points: np.ndarray, mesh, device="cuda") -> np.ndarray:
    """Boolean mask of points enclosed by a closed triangle mesh, by +x ray
    casting with Moller-Trumbore (the VTK `select_enclosed_points` role,
    pyvista-free; parity: `spateo_tpu.tdr.widgets.ops.points_inside_mesh`),
    on `device` in float64, `PIM_ELEMS` (point, face) pairs a block."""
    pts = torch.as_tensor(np.asarray(points, float), dtype=torch.float64, device=device).reshape(-1, 3)
    tri = np.asarray(mesh.points, float)[np.asarray(mesh.faces, int)]  # [F, 3, 3]
    tri = torch.as_tensor(tri, dtype=torch.float64, device=pts.device).reshape(-1, 3, 3)
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    # h = d x e2 and q = s x e1 with the ray d = (1, 0, 0): h = (0, -e2z, e2y)
    h1, h2 = -e2[:, 2], e2[:, 1]
    a = e1[:, 1] * h1 + e1[:, 2] * h2
    ok = a.abs() > 1e-12
    inv_a = torch.where(ok, 1.0 / torch.where(ok, a, torch.ones_like(a)), torch.zeros_like(a))
    inside = torch.zeros(len(pts), dtype=torch.bool, device=pts.device)
    rows = max(1, PIM_ELEMS // max(len(tri), 1))
    for lo in range(0, len(pts), rows):
        P = pts[lo : lo + rows]
        sx, sy, sz = (P[:, j, None] - v0[None, :, j] for j in range(3))
        u = (sy * h1 + sz * h2) * inv_a
        qx = sy * e1[:, 2] - sz * e1[:, 1]
        v = qx * inv_a
        t = (qx * e2[:, 0] + (sz * e1[:, 0] - sx * e1[:, 2]) * e2[:, 1] + (sx * e1[:, 1] - sy * e1[:, 0]) * e2[:, 2]) * inv_a
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-9)
        inside[lo : lo + rows] = hit.sum(1) % 2 == 1
    return inside.cpu().numpy()


def overlap_pc_pick(pc, mesh, device="cuda") -> Tuple[PointCloud, PointCloud]:
    """Split a point cloud into (inside, outside) of a mesh (parity:
    reference widgets/pick.py:161 `overlap_pc_pick`, which uses VTK
    `select_enclosed_points` + threshold); the test on `device`."""
    inside = points_inside_mesh(pc.points, mesh, device=device)
    return _subset(pc, inside), _subset(pc, ~inside)


def overlap_mesh_pick(mesh1, mesh2, device="cuda"):
    """Approximate intersection of two closed meshes (parity: reference
    widgets/pick.py:184 `overlap_mesh_pick` = VTK `boolean_intersection`):
    keeps the faces of each mesh whose centroids fall inside the other and
    merges them. The open seam between the kept shells is a documented
    substitution for VTK's exact boolean surface (pyvista absent here). The
    centroids' test runs on `device`."""
    from ..models.mesh_core import Mesh, merge_models

    def _clip(ma, mb):
        faces = np.asarray(ma.faces, int)
        cent = np.asarray(ma.points, float)[faces].mean(1)
        keep = points_inside_mesh(cent, mb, device=device)
        used = np.unique(faces[keep])
        remap = -np.ones(len(ma.points), int)
        remap[used] = np.arange(len(used))
        return Mesh(
            np.asarray(ma.points)[used],
            remap[faces[keep]],
            {k: np.asarray(v)[used] for k, v in ma.point_data.items()},
        )

    return merge_models([_clip(mesh1, mesh2), _clip(mesh2, mesh1)])


def overlap_pick(main_mesh, other_mesh, main_pc=None, other_pc=None, device="cuda"):
    """Intersection mesh of two meshes plus the point clouds inside it
    (parity: reference widgets/pick.py:244 `overlap_pick`), the tests on
    `device`."""
    select_mesh = overlap_mesh_pick(main_mesh, other_mesh, device=device)
    if main_pc is None and other_pc is None:
        return select_mesh, None
    from ..models.mesh_core import merge_models

    picked = []
    for pc, other in ((main_pc, other_mesh), (other_pc, main_mesh)):
        if pc is not None:
            picked.append(_subset(pc, points_inside_mesh(pc.points, other, device=device)))
    return select_mesh, merge_models(picked)


def three_d_slice(
    model, method: str = "axis", n_slices: int = 10, axis: str = "x", vec=(1, 0, 0), center=None
):
    """Slice a model into bands along an axis, three orthogonal slabs, or
    perpendicular to an arbitrary vector (parity: reference
    widgets/slice.py:124-186 — 'axis'/'orthogonal'/'line' methods; the
    'line' method returns ``(slices, line_points, line)`` with empty
    slices dropped, like the reference)."""
    pts = np.asarray(model.points, float)
    ax = {"x": 0, "y": 1, "z": 2}[axis]
    if method == "axis":
        edges = np.linspace(pts[:, ax].min(), pts[:, ax].max() + 1e-9, n_slices + 1)
        return [_subset(model, (pts[:, ax] >= lo) & (pts[:, ax] < hi)) for lo, hi in zip(edges[:-1], edges[1:])]
    if method == "orthogonal":
        c = np.asarray(center, float) if center is not None else pts.mean(0)
        out = []
        for a in range(min(pts.shape[1], 3)):
            half_w = np.ptp(pts[:, a]) / max(n_slices, 1) / 2
            out.append(_subset(model, np.abs(pts[:, a] - c[a]) <= half_w))
        return out
    if method == "line":
        v = np.asarray(vec, float)
        v = v / (np.linalg.norm(v) + 1e-300)
        t = pts @ v
        positions = np.linspace(t.min(), t.max(), n_slices)
        c = np.asarray(center, float) if center is not None else pts.mean(0)
        base = c - (c @ v) * v
        line = base[None, :] + positions[:, None] * v[None, :]
        half_w = (t.max() - t.min()) / max(n_slices, 1) / 2
        slices, line_points = [], []
        for p_t, p in zip(positions, line):
            mask = np.abs(t - p_t) <= half_w
            if mask.any():
                slices.append(_subset(model, mask))
                line_points.append(p)
        lm.main_info(
            f"Slice the model uniformly along the vector `vec` and generate {n_slices} slices. "
            f"There are {n_slices - len(slices)} empty slices, {len(slices)} valid slices in all slices."
        )
        return slices, np.asarray(line_points), line
    raise ValueError("`method` value is wrong. \nAvailable `method` are: `'axis'`, `'orthogonal'`, `'line'`.")


def interactive_slice(model, key: str = "groups", method: str = "axis", axis: str = "x"):
    """Programmatic stand-in for the pyvista slicing widget
    (parity surface: widgets/slice.py interactive_slice)."""
    return three_d_slice(model, method=method, axis=axis)


def interactive_rectangle_clip(model, key: str = "groups", bounds=None):
    """Clip by an axis-aligned rectangle/box (parity surface:
    widgets/clip.py interactive_rectangle_clip). `bounds` is
    (xmin, xmax, ymin, ymax[, zmin, zmax])."""
    pts = np.asarray(model.points, float)
    if bounds is None:
        return [model.copy()]
    b = np.asarray(bounds, float)
    keep = (pts[:, 0] >= b[0]) & (pts[:, 0] <= b[1]) & (pts[:, 1] >= b[2]) & (pts[:, 1] <= b[3])
    if len(b) >= 6 and pts.shape[1] >= 3:
        keep &= (pts[:, 2] >= b[4]) & (pts[:, 2] <= b[5])
    return [_subset(model, keep)]


def interactive_box_clip(model, key: str = "groups", invert: bool = False, bounds=None):
    """Clip by a 3D box (parity: reference widgets/clip.py:158
    `interactive_box_clip`, whose pyvista box widget defaults to the model
    bounds; headless callers pass `bounds` = (xmin, xmax, ymin, ymax, zmin,
    zmax) directly). `invert` keeps the points OUTSIDE the box."""
    pts = np.asarray(model.points, float)
    if bounds is None:
        b = np.asarray(model.bounds, float)
    else:
        b = np.asarray(bounds, float)
    keep = (pts[:, 0] >= b[0]) & (pts[:, 0] <= b[1]) & (pts[:, 1] >= b[2]) & (pts[:, 1] <= b[3])
    if len(b) >= 6 and pts.shape[1] >= 3:
        keep &= (pts[:, 2] >= b[4]) & (pts[:, 2] <= b[5])
    return [_subset(model, ~keep if invert else keep)]


# plane/line geometry helpers (parity: reference widgets/slice.py)


def euclidean_distance(instance1, instance2, dimension: int = 3) -> float:
    """Plain euclidean distance (parity: widgets/slice.py)."""
    a = np.asarray(instance1, float)[:dimension]
    b = np.asarray(instance2, float)[:dimension]
    return float(np.sqrt(((a - b) ** 2).sum()))


def find_plane_equation(point1, point2, point3):
    """Plane (A, B, C, D) through three points with Ax+By+Cz+D=0
    (parity: widgets/slice.py find_plane_equation)."""
    p1, p2, p3 = (np.asarray(p, float) for p in (point1, point2, point3))
    n = np.cross(p2 - p1, p3 - p1)
    D = -float(n @ p1)
    return np.asarray([n[0], n[1], n[2], D])


def find_model_outline_planes(model) -> dict:
    """Axis-aligned bounding planes of a model
    (parity: widgets/slice.py find_model_outline_planes)."""
    pts = np.asarray(model.points, float)
    mins, maxs = pts.min(0), pts.max(0)
    return {ax: (float(mins[i]), float(maxs[i])) for i, ax in enumerate("xyz"[: pts.shape[1]])}


def find_intersection(model, vec, center, plane):
    """Intersection of the line center + t*vec with the plane
    (A, B, C, D) (parity: widgets/slice.py find_intersection)."""
    vec = np.asarray(vec, float)
    center = np.asarray(center, float)
    A, B, C, D = np.asarray(plane, float)
    n = np.asarray([A, B, C])
    denom = float(n @ vec)
    if abs(denom) < 1e-12:
        return None
    t = -(float(n @ center) + D) / denom
    return center + t * vec


def create_line(point1, point2, n_points: int = 100) -> np.ndarray:
    """Evenly spaced points on a segment (parity: widgets/slice.py
    create_line)."""
    p1 = np.asarray(point1, float)
    p2 = np.asarray(point2, float)
    t = np.linspace(0, 1, n_points)[:, None]
    return p1[None, :] * (1 - t) + p2[None, :] * t
