"""Voxelization + native marching cubes
(capability parity: reference spateo/tdr/models/models_individual/voxel.py:19,61
and mesh_methods.py marching-cubes path :116, which uses PyMCubes).

The marching-cubes surface extraction here is a compact native
implementation: occupancy is smoothed with a box filter (host scipy), and the
isosurface uses the midpoint-tetrahedra decomposition (each occupied-boundary
cube is split into tetrahedra whose triangle emission has no 256-entry case
table; output is watertight for binary fields).

A copy of `spateo_tpu.tdr.models.models_individual.voxel`."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from ....logging import logger_manager as lm
from ..mesh_core import Mesh, PointCloud


def voxelize_pc(pc: PointCloud, voxel_size: Union[float, np.ndarray, None] = None) -> PointCloud:
    """Voxelize a point cloud: one representative point per occupied voxel
    (parity: voxel.py:19)."""
    points = np.asarray(pc.points, dtype=float)
    if voxel_size is None:
        span = points.max(0) - points.min(0)
        voxel_size = span / 50.0
    voxel_size = np.broadcast_to(np.asarray(voxel_size, dtype=float), (points.shape[1],))
    grid = np.floor((points - points.min(0)) / np.maximum(voxel_size, 1e-12)).astype(np.int64)
    key = grid[:, 0]
    mult = 1
    for d in range(1, grid.shape[1]):
        mult *= int(grid[:, d - 1].max()) + 1
        key = key + grid[:, d] * mult
    uniq, idx = np.unique(key, return_index=True)
    centers = points.min(0) + (grid[idx] + 0.5) * voxel_size
    out = PointCloud(centers)
    out["voxel_size"] = np.tile(voxel_size, (len(centers), 1))
    return out


def _occupancy_grid(points: np.ndarray, resolution: int = 40, pad: int = 2):
    mins = points.min(0)
    maxs = points.max(0)
    span = np.maximum(maxs - mins, 1e-9)
    cell = span.max() / resolution
    dims = np.ceil(span / cell).astype(int) + 2 * pad + 1
    idx = np.floor((points - mins) / cell).astype(int) + pad
    occ = np.zeros(dims, dtype=bool)
    occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    # dilate once to close small gaps
    from scipy.ndimage import binary_closing, binary_dilation

    occ = binary_dilation(occ, iterations=1)
    occ = binary_closing(occ, iterations=2)
    origin = mins - pad * cell
    return occ, origin, cell


_TET_DECOMP = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]]
)
_CUBE_VERTS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=float
)


def _marching_tetrahedra(field: np.ndarray, iso: float, origin: np.ndarray, cell: float) -> Mesh:
    """Isosurface via per-cube tetrahedral decomposition."""
    nx, ny, nz = field.shape
    verts_out = []
    # gather cube corner values for all cubes bordering the isosurface
    inside = field > iso
    # cubes whose corners disagree
    c = inside[:-1, :-1, :-1]
    disagree = np.zeros_like(c)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                disagree |= inside[dx : nx - 1 + dx, dy : ny - 1 + dy, dz : nz - 1 + dz] != c
    cubes = np.argwhere(disagree)
    if len(cubes) == 0:
        return Mesh(np.zeros((0, 3)), np.zeros((0, 3), int))

    corner_vals = np.stack(
        [field[cubes[:, 0] + int(v[0]), cubes[:, 1] + int(v[1]), cubes[:, 2] + int(v[2])] for v in _CUBE_VERTS],
        axis=1,
    )  # [C, 8]
    corner_pos = cubes[:, None, :] + _CUBE_VERTS[None, :, :]  # [C, 8, 3]

    tris = []
    for tet in _TET_DECOMP:
        vals = corner_vals[:, tet]  # [C, 4]
        pos = corner_pos[:, tet]  # [C, 4, 3]
        above = vals > iso
        n_above = above.sum(1)

        def interp(p1, v1, p2, v2):
            t = (iso - v1) / np.where(np.abs(v2 - v1) < 1e-12, 1e-12, v2 - v1)
            return p1 + t[:, None] * (p2 - p1)

        # case: exactly one vertex above -> one triangle
        for flip, n_target in ((False, 1), (True, 3)):
            sel = n_above == n_target
            if not sel.any():
                continue
            ab = above[sel] if not flip else ~above[sel]
            one_idx = np.argmax(ab, axis=1)
            others = np.array([[j for j in range(4) if j != i] for i in range(4)])
            o = others[one_idx]  # [S, 3]
            p_one = pos[sel][np.arange(sel.sum()), one_idx]
            v_one = vals[sel][np.arange(sel.sum()), one_idx]
            tri_pts = []
            for j in range(3):
                p_o = pos[sel][np.arange(sel.sum()), o[:, j]]
                v_o = vals[sel][np.arange(sel.sum()), o[:, j]]
                tri_pts.append(interp(p_one, v_one, p_o, v_o))
            tris.append(np.stack(tri_pts, axis=1))
        # case: two above, two below -> quad (two triangles)
        sel = n_above == 2
        if sel.any():
            ab = above[sel]
            s = sel.sum()
            # indices of the two above and two below
            idx_above = np.argsort(~ab, axis=1)[:, :2]
            idx_below = np.argsort(ab, axis=1)[:, :2]
            P = pos[sel]
            V = vals[sel]
            ar = np.arange(s)
            pa0, va0 = P[ar, idx_above[:, 0]], V[ar, idx_above[:, 0]]
            pa1, va1 = P[ar, idx_above[:, 1]], V[ar, idx_above[:, 1]]
            pb0, vb0 = P[ar, idx_below[:, 0]], V[ar, idx_below[:, 0]]
            pb1, vb1 = P[ar, idx_below[:, 1]], V[ar, idx_below[:, 1]]
            q00 = interp(pa0, va0, pb0, vb0)
            q01 = interp(pa0, va0, pb1, vb1)
            q10 = interp(pa1, va1, pb0, vb0)
            q11 = interp(pa1, va1, pb1, vb1)
            tris.append(np.stack([q00, q01, q11], axis=1))
            tris.append(np.stack([q00, q11, q10], axis=1))

    if not tris:
        return Mesh(np.zeros((0, 3)), np.zeros((0, 3), int))
    tri_arr = np.concatenate(tris, axis=0)  # [T, 3, 3] in grid coords
    pts = tri_arr.reshape(-1, 3) * cell + origin
    # weld duplicate vertices
    rounded = np.round(pts / (cell * 1e-4)).astype(np.int64)
    uniq, inv = np.unique(rounded, axis=0, return_inverse=True)
    welded_pts = np.zeros((len(uniq), 3))
    np.add.at(welded_pts, inv, pts)
    counts = np.bincount(inv)
    welded_pts /= counts[:, None]
    faces = inv.reshape(-1, 3)
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])]
    return Mesh(welded_pts, faces)


def marching_cubes_mesh(
    points: np.ndarray,
    resolution: int = 40,
    iso: float = 0.35,
    smooth_occupancy: int = 1,
) -> Mesh:
    """Surface mesh of a point cloud via occupancy marching cubes."""
    from scipy.ndimage import uniform_filter

    occ, origin, cell = _occupancy_grid(np.asarray(points, float), resolution)
    field = occ.astype(float)
    for _ in range(smooth_occupancy):
        field = uniform_filter(field, size=3)
    return _marching_tetrahedra(field, iso, origin, cell)


def voxelize_mesh(
    mesh: Mesh,
    voxel_pc: Optional[PointCloud] = None,
    key_added: str = "groups",
    label: str = "voxel",
    color: Optional[str] = "gainsboro",
    alpha: float = 1.0,
    smooth: Optional[int] = 200,
) -> tuple:
    """Voxel model filling a surface mesh's interior (parity: reference
    voxel.py:61-110 — same key_added/label/color/alpha labeling and
    (model, plot_cmap) return; `smooth` sets the voxel density like the
    reference's pyvista voxelize density = diagonal / smooth, grid capped at
    ~2M candidate points). Interior test: Delaunay in-hull on the mesh
    vertices. `voxel_pc`'s labels, when given, transfer onto the voxels
    nearest to its points (the reference's cell-assignment merge)."""
    from scipy.spatial import Delaunay, cKDTree

    pts = mesh.points
    mins, maxs = pts.min(0), pts.max(0)
    extent = maxs - mins
    diag = float(np.linalg.norm(extent)) + 1e-12
    spacing = diag / max(int(smooth or 200), 2)
    counts = np.maximum((extent / spacing).astype(int) + 1, 2)
    while np.prod(counts) > 2_000_000:
        counts = np.maximum(counts // 2, 2)
    grid = np.stack(
        np.meshgrid(*[np.linspace(mins[d], maxs[d], int(counts[d])) for d in range(3)]), axis=-1
    ).reshape(-1, 3)
    tri = Delaunay(pts)
    inside = tri.find_simplex(grid) >= 0
    out = PointCloud(grid[inside])

    labels = np.full(int(inside.sum()), label, dtype=object)
    if voxel_pc is not None and key_added in getattr(voxel_pc, "point_data", {}):
        src_labels = np.asarray(voxel_pc.point_data[key_added])
        near = cKDTree(np.asarray(voxel_pc.points)).query(out.points)[1]
        labels = src_labels[near].astype(object)
    from ..utilities.label_utils import add_model_labels

    _, plot_cmap = add_model_labels(
        out, labels=labels, key_added=key_added, where="point_data",
        colormap=color, alphamap=alpha, inplace=True,
    )
    return out, plot_cmap
