"""Lightweight 3D model containers (pyvista-free).

The reference represents 3D models as pyvista PolyData/UnstructuredGrid
(reference spateo/tdr/models/*). pyvista/VTK are not in this image, so the
framework ships its own minimal containers holding numpy vertex/face arrays
with the geometric measures the morphometrics layer needs (bounds, area,
volume via the divergence theorem, per-point data). A copy of
`spateo_tpu.tdr.models.mesh_core`."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class PointCloud:
    """A set of 3D points + per-point data."""

    def __init__(self, points: np.ndarray, point_data: Optional[Dict[str, np.ndarray]] = None):
        self.points = np.asarray(points, dtype=float)
        self.point_data: Dict[str, np.ndarray] = dict(point_data or {})
        # per-cell (face/segment) data, mirroring the reference's pyvista
        # model API (model.cell_data)
        self.cell_data: Dict[str, np.ndarray] = {}

    @property
    def n_points(self) -> int:
        return len(self.points)

    @property
    def bounds(self):
        mins = self.points.min(0)
        maxs = self.points.max(0)
        return tuple(v for pair in zip(mins, maxs) for v in pair)

    def __getitem__(self, key):
        return self.point_data[key]

    def __setitem__(self, key, value):
        self.point_data[key] = np.asarray(value)

    def copy(self) -> "PointCloud":
        return PointCloud(self.points.copy(), {k: v.copy() for k, v in self.point_data.items()})


class Mesh(PointCloud):
    """Triangle mesh: points [N, 3] + faces [F, 3] (+ per-point data)."""

    def __init__(self, points, faces, point_data: Optional[Dict[str, np.ndarray]] = None):
        super().__init__(points, point_data)
        self.faces = np.asarray(faces, dtype=int)

    @property
    def n_faces(self) -> int:
        return len(self.faces)

    @property
    def area(self) -> float:
        v0 = self.points[self.faces[:, 0]]
        v1 = self.points[self.faces[:, 1]]
        v2 = self.points[self.faces[:, 2]]
        return float(0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1).sum())

    @property
    def volume(self) -> float:
        """Volume by the divergence theorem. Faces from alpha-shape boundary
        extraction carry arbitrary winding, so each triangle is first oriented
        outward from the mesh centroid."""
        center = self.points.mean(0)
        v0 = self.points[self.faces[:, 0]] - center
        v1 = self.points[self.faces[:, 1]] - center
        v2 = self.points[self.faces[:, 2]] - center
        normals = np.cross(v1 - v0, v2 - v0)
        face_center = (v0 + v1 + v2) / 3.0
        outward = np.einsum("ij,ij->i", normals, face_center) >= 0
        signed = np.einsum("ij,ij->i", v0, np.cross(v1, v2)) / 6.0
        return float(abs(np.where(outward, signed, -signed).sum()))

    def extract_surface(self) -> "Mesh":
        return self

    def copy(self) -> "Mesh":
        return Mesh(self.points.copy(), self.faces.copy(), {k: v.copy() for k, v in self.point_data.items()})


def merge_models(models):
    """Concatenate point clouds / meshes into one container (parity helper
    for the reference's `collect_models`/`merge_models`)."""
    points = np.concatenate([m.points for m in models], axis=0)
    face_models = [m for m in models if isinstance(m, Mesh)]
    if face_models and len(face_models) == len(models):
        faces = []
        offset = 0
        for m in models:
            faces.append(m.faces + offset)
            offset += m.n_points
        return Mesh(points, np.concatenate(faces, axis=0))
    return PointCloud(points)


collect_models = merge_models
