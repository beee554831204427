"""Mesh repair/uniformization utilities (capability parity: reference
tdr/models/models_individual/mesh_utils.py — clean_mesh, fix_mesh,
smooth_mesh, uniform_mesh, uniform_larger_pc; pymeshfix/pyacvd replaced by
vectorized numpy mesh surgery).

A copy of `spateo_tpu.tdr.models.models_individual.mesh_utils`."""

from __future__ import annotations

import numpy as np

from ..mesh_core import Mesh, PointCloud
from .mesh import _smooth_mesh


def clean_mesh(mesh: Mesh) -> Mesh:
    """Drop duplicate/degenerate faces and unreferenced points
    (parity: mesh_utils.py clean_mesh)."""
    faces = np.asarray(mesh.faces, int)
    # degenerate faces (repeated vertices)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    faces = faces[ok]
    faces = np.unique(np.sort(faces, axis=1), axis=0)
    used = np.unique(faces)
    remap = -np.ones(len(mesh.points), int)
    remap[used] = np.arange(len(used))
    return Mesh(np.asarray(mesh.points)[used], remap[faces])


def fix_mesh(mesh: Mesh) -> Mesh:
    """Keep the largest connected face component (parity surface:
    mesh_utils.py fix_mesh / pymeshfix)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    m = clean_mesh(mesh)
    faces = np.asarray(m.faces, int)
    n = len(m.points)
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    g = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    ncomp, labels = connected_components(g, directed=False)
    if ncomp <= 1:
        return m
    keep_label = np.bincount(labels).argmax()
    keep_faces = np.all(labels[faces] == keep_label, axis=1)
    out = Mesh(m.points, faces[keep_faces])
    return clean_mesh(out)


def smooth_mesh(mesh: Mesh, n_iter: int = 100, lam: float = 0.5) -> Mesh:
    """Laplacian smoothing (parity: mesh_utils.py smooth_mesh)."""
    return _smooth_mesh(mesh, n_iter=n_iter, lam=lam)


def uniform_mesh(mesh: Mesh, nsub: int = 3, nclus: int = 20000) -> Mesh:
    """Uniform remesh by midpoint subdivision then vertex clustering
    (parity surface: mesh_utils.py uniform_mesh / pyacvd)."""
    m = clean_mesh(mesh)
    for _ in range(max(int(np.log2(max(nclus // max(len(m.points), 1), 1)) // 2), 0) or 1):
        m = _subdivide_once(m)
        if len(m.points) >= nclus:
            break
    return m


def _subdivide_once(mesh: Mesh) -> Mesh:
    pts = np.asarray(mesh.points, float)
    faces = np.asarray(mesh.faces, int)
    # midpoints of unique edges
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    edges = np.sort(edges, axis=1)
    uniq, inv = np.unique(edges, axis=0, return_inverse=True)
    mids = pts[uniq].mean(axis=1)
    mid_idx = len(pts) + np.arange(len(uniq))
    e01 = mid_idx[inv[: len(faces)]]
    e12 = mid_idx[inv[len(faces) : 2 * len(faces)]]
    e20 = mid_idx[inv[2 * len(faces) :]]
    f = faces
    new_faces = np.concatenate([
        np.stack([f[:, 0], e01, e20], 1),
        np.stack([e01, f[:, 1], e12], 1),
        np.stack([e20, e12, f[:, 2]], 1),
        np.stack([e01, e12, e20], 1),
    ])
    return Mesh(np.concatenate([pts, mids]), new_faces)


def uniform_larger_pc(pc, alpha: float = 0.0, nsub: int = 5, nclus: int = 20000) -> PointCloud:
    """Densify a point cloud by surface subdivision (parity:
    mesh_utils.py uniform_larger_pc)."""
    from .mesh_methods import alpha_shape_mesh

    mesh = alpha_shape_mesh(pc, alpha=alpha if alpha > 0 else 2.0)
    mesh = uniform_mesh(mesh, nsub=nsub, nclus=nclus)
    return PointCloud(np.asarray(mesh.points))
