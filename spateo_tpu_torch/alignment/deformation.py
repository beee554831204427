"""Deformation-grid construction
(capability parity: reference spateo/alignment/deformation.py:24 — warps a
line grid through the learned vector field for deformation plots; the
pyvista line-segment models become tdr `LineModel`s carrying the same
per-point |velocity| scalar in point_data[key_added]). A copy of
`spateo_tpu.alignment.deformation`; the warp is the port's `BA_transform`
on `device`."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.anndata import AnnData
from .transform import BA_transform


def _polyline_model(points2d: np.ndarray, scalars: np.ndarray, key_added: str):
    """One grid line as a LineModel: consecutive points connected, z=0."""
    from ..tdr.models.models_migration.primitives import construct_lines

    pts = np.c_[points2d, np.zeros(len(points2d))]
    edges = np.c_[np.arange(len(pts) - 1), np.arange(1, len(pts))]
    m, _ = construct_lines(pts, edges)
    m.point_data[key_added] = np.asarray(scalars, dtype=float)
    return m


def _merge_line_models(models, key_added: str):
    from ..tdr.models.models_migration.primitives import construct_lines

    pts = np.concatenate([np.asarray(m.points) for m in models])
    offsets = np.cumsum([0] + [len(m.points) for m in models[:-1]])
    edges = np.concatenate([np.asarray(m.lines) + o for m, o in zip(models, offsets)])
    merged, _ = construct_lines(pts, edges)
    merged.point_data[key_added] = np.concatenate([np.asarray(m.point_data[key_added]) for m in models])
    return merged


def grid_deformation(
    model: AnnData,
    spatial_key: str = "spatial",
    vecfld_key: str = "VecFld_morpho",
    key_added: str = "deformation",
    deformation_scale: int = 3,
    grid_num: Optional[np.ndarray] = None,
    grid_density: int = 1000,
    expand_c: float = 0.0,
    dtype: str = "float32",
    device: str = "cuda",
):
    """Build a regular grid over the slice extent and warp each grid line
    through the saved Morpho vector field (parity: reference
    deformation.py:24 — same signature and return contract).

    Returns ``(grid, deformed_grid)``: two merged `LineModel`s. The
    undeformed grid carries zeros in ``point_data[key_added]``; the
    deformed grid carries the mean |velocity| of each point, which the
    deformation plot uses for coloring. The raw polylines are also kept
    in ``model.uns[key_added]`` for the 2D plot path.
    """
    assert vecfld_key in model.uns, f"`{vecfld_key}` not found in `.uns` — run morpho_align first."
    vecfld = model.uns[vecfld_key]
    grid_num = np.asarray([20, 20]) if grid_num is None else np.asarray(grid_num)
    coords = np.asarray(model.obsm[spatial_key], dtype=float)[:, :2]
    mins, maxs = coords.min(0), coords.max(0)
    span = maxs - mins
    mins = mins - expand_c * span
    maxs = maxs + expand_c * span

    grid_lines: List[np.ndarray] = []
    for x in np.linspace(mins[0], maxs[0], grid_num[0], endpoint=True):
        grid_lines.append(np.c_[np.full(grid_density, x), np.linspace(mins[1], maxs[1], grid_density)])
    for y in np.linspace(mins[1], maxs[1], grid_num[1], endpoint=True):
        grid_lines.append(np.c_[np.linspace(mins[0], maxs[0], grid_density), np.full(grid_density, y)])

    # one batched device call for every line at once
    all_pts = np.concatenate(grid_lines)
    warped, velocities, _ = BA_transform(vecfld, all_pts, deformation_scale=deformation_scale, dtype=dtype, device=device)
    warped = np.asarray(warped)
    vel_mag = np.mean(np.abs(np.asarray(velocities)), axis=1).flatten()

    grid_models, deformed_models, deformed_lines = [], [], []
    offset = 0
    for line in grid_lines:
        seg = slice(offset, offset + len(line))
        grid_models.append(_polyline_model(line, np.zeros(len(line)), key_added))
        deformed_models.append(_polyline_model(warped[seg], vel_mag[seg], key_added))
        deformed_lines.append(warped[seg])
        offset += len(line)

    model.uns[key_added] = {"grid_lines": grid_lines, "deformed_lines": deformed_lines}
    return _merge_line_models(grid_models, key_added), _merge_line_models(deformed_models, key_added)
