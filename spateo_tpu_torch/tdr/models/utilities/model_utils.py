"""Geometric model transforms (capability parity: reference
tdr/models/utilities/model_utils.py — center_to_zero, translate_model,
rotate_model, scale_model, split_model, multiblock2model, collect/merge).

A copy of `spateo_tpu.tdr.models.utilities.model_utils`."""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from ..mesh_core import PointCloud, merge_models


def collect_models(models: List) -> List:
    """Group models (the reference returns a pyvista MultiBlock; a list is
    the equivalent container here)."""
    return list(models)


def multiblock2model(model, message: Optional[str] = None):
    """Merge a multiblock (list of models) into one model."""
    if isinstance(model, (list, tuple)):
        return merge_models(list(model))
    return model


def center_to_zero(model, inplace: bool = False):
    """Translate the model's center to the origin (parity: model_utils.py)."""
    m = model if inplace else model.copy()
    m.points = np.asarray(m.points) - np.asarray(m.points).mean(0)
    return None if inplace else m


def translate_model(model, distance=(0, 0, 0), t_center: Optional[np.ndarray] = None, inplace: bool = False):
    """Translate by `distance` (optionally after centering on t_center)."""
    m = model if inplace else model.copy()
    pts = np.asarray(m.points, float)
    if t_center is not None:
        pts = pts - np.asarray(t_center, float)
    m.points = pts + np.asarray(distance, float)
    return None if inplace else m


def rotate_model(model, angle=(0, 0, 0), rotate_center: Optional[np.ndarray] = None, inplace: bool = False):
    """Rotate by Euler xyz angles in degrees about rotate_center
    (defaults to the centroid)."""
    m = model if inplace else model.copy()
    pts = np.asarray(m.points, float)
    center = np.asarray(rotate_center, float) if rotate_center is not None else pts.mean(0)
    rx, ry, rz = np.deg2rad(np.asarray(angle, float).ravel()[:3])
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    R = Rz @ Ry @ Rx
    if pts.shape[1] == 2:
        R = R[:2, :2]
        center = center[:2]
    m.points = (pts - center) @ R.T + center
    return None if inplace else m


def scale_model(model, scale_factor: Union[float, list] = 1.0, scale_center: Optional[np.ndarray] = None, inplace: bool = False):
    """Scale about scale_center (defaults to the centroid)."""
    m = model if inplace else model.copy()
    pts = np.asarray(m.points, float)
    center = np.asarray(scale_center, float) if scale_center is not None else pts.mean(0)
    m.points = (pts - center) * np.asarray(scale_factor, float) + center
    return None if inplace else m


def split_model(model, label_key: Optional[str] = "groups") -> dict:
    """Split a model into per-label submodels (parity: model_utils.py
    split_model; connected-component splitting reduces to labels here)."""
    labels = np.asarray(model.point_data[label_key])
    out = {}
    for l in dict.fromkeys(map(str, labels)):
        keep = np.asarray([str(v) == l for v in labels])
        sub = PointCloud(np.asarray(model.points)[keep], {k: np.asarray(v)[keep] for k, v in model.point_data.items()})
        out[l] = sub
    return out
