"""Public mesh-reconstruction methods (capability parity: reference
tdr/models/models_individual/mesh_methods.py — alpha_shape_mesh,
ball_pivoting_mesh, poisson_mesh, marching_cube_mesh, pv_mesh,
rigid_transform; open3d/PyMCubes/pyvista replaced by the framework's
Delaunay alpha shapes and marching tetrahedra).

A copy of `spateo_tpu.tdr.models.models_individual.mesh_methods`, but
`marching_cube_mesh`, which there raises."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..mesh_core import Mesh
from .mesh import _alpha_shape_3d


def alpha_shape_mesh(pc, alpha: float = 2.0) -> Mesh:
    """Delaunay alpha-shape surface (parity: mesh_methods.py
    alpha_shape_mesh)."""
    pts = np.asarray(pc.points if hasattr(pc, "points") else pc, float)
    return _alpha_shape_3d(pts, alpha=alpha)


def ball_pivoting_mesh(pc, radii=None) -> Mesh:
    """True ball-pivoting reconstruction (parity: mesh_methods.py:289
    ball_pivoting_mesh / open3d create_from_point_cloud_ball_pivoting):
    advancing-front pivoting with the empty-ball invariant over one or more
    radii; see `reconstruction.ball_pivoting_reconstruction`."""
    from .reconstruction import ball_pivoting_reconstruction

    pts = np.asarray(pc.points if hasattr(pc, "points") else pc, float)
    return ball_pivoting_reconstruction(pts, radii=radii)


def poisson_mesh(
    pc,
    depth: int = 8,
    width: float = 0,
    scale: float = 1.1,
    linear_fit: bool = False,
    density_threshold: Optional[float] = None,
    **kwargs,
) -> Mesh:
    """Screened Poisson surface reconstruction (parity: mesh_methods.py:343
    poisson_mesh / open3d create_from_point_cloud_poisson): oriented-normal
    field integrated into an indicator function on a density-adapted grid
    (depth bounds the resolution at 2^depth), isosurface at the sample mean,
    low-density vertices removed by `density_threshold` quantile; see
    `reconstruction.poisson_reconstruction`."""
    from .reconstruction import poisson_reconstruction

    pts = np.asarray(pc.points if hasattr(pc, "points") else pc, float)
    return poisson_reconstruction(
        pts,
        depth=depth,
        width=width,
        scale=scale,
        linear_fit=linear_fit,
        density_threshold=density_threshold,
        **kwargs,
    )


def marching_cube_mesh(voxel_or_pc, levelset: float = 0.0, **kwargs) -> Mesh:
    """Marching-cubes surface of a voxelization (parity: mesh_methods.py
    marching_cube_mesh; PyMCubes replaced by the framework's marching
    tetrahedra). `levelset` is accepted for the reference's signature: the
    surface is `marching_cubes_mesh`'s `iso` of the smoothed occupancy. The
    JAX package passes `levelset` (and a model) on to `marching_cubes_mesh`,
    which takes neither, so its call raises; this one takes the model's
    points."""
    from .voxel import marching_cubes_mesh

    pts = np.asarray(voxel_or_pc.points if hasattr(voxel_or_pc, "points") else voxel_or_pc, float)
    return marching_cubes_mesh(pts, **kwargs)


def pv_mesh(pc, alpha: float = 2.0) -> Mesh:
    """Surface of the alpha-filtered 3D Delaunay tetrahedralization
    (parity: mesh_methods.py:29 pv_mesh / pyvista
    `delaunay_3d(alpha).extract_surface()` — `_alpha_shape_3d` performs
    exactly that construction: Delaunay tets, circumradius alpha filter,
    boundary-face extraction)."""
    return alpha_shape_mesh(pc, alpha=alpha)


def rigid_transform(coords: np.ndarray, coords_refA: np.ndarray, coords_refB: np.ndarray) -> np.ndarray:
    """Apply the rigid transform mapping coords_refA onto coords_refB to
    `coords` (parity: mesh_methods.py rigid_transform — Kabsch on the
    reference pairs)."""
    A = np.asarray(coords_refA, float)
    B = np.asarray(coords_refB, float)
    cA, cB = A.mean(0), B.mean(0)
    H = (A - cA).T @ (B - cB)
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        Vt[-1] *= -1
        R = Vt.T @ U.T
    t = cB - R @ cA
    return (np.asarray(coords, float) @ R.T) + t
