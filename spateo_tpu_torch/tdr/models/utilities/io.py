"""Model persistence (capability parity: reference
tdr/models/utilities/io.py read_model/save_model — pyvista .vtk replaced by
an npz container holding points/faces/lines/point_data).

A copy of `spateo_tpu.tdr.models.utilities.io`."""

from __future__ import annotations

import numpy as np

from ..mesh_core import Mesh, PointCloud


def save_model(model, filename: str, binary: bool = True, texture=None) -> str:
    """Serialize a PointCloud/Mesh/LineModel to .npz (parity signature:
    reference tdr/models/utilities/io.py:26 — there ``binary`` toggles
    VTK ascii/binary encoding and ``texture`` names the active texture
    array; npz is always binary, and a string ``texture`` is recorded as
    the active point-data key in the archive)."""
    payload = {"points": np.asarray(model.points)}
    if texture is not None:
        if isinstance(texture, str):
            payload["active_texture"] = np.asarray(texture)
        else:
            payload["pd__texture"] = np.asarray(texture)
    if hasattr(model, "faces"):
        payload["faces"] = np.asarray(model.faces)
    if hasattr(model, "lines"):
        payload["lines"] = np.asarray(model.lines)
    for k, v in getattr(model, "point_data", {}).items():
        arr = np.asarray(v)
        if arr.dtype == object:
            arr = arr.astype(str)  # fixed-width unicode loads without pickle
        payload[f"pd__{k}"] = arr
    if not filename.endswith(".npz"):
        filename = filename + ".npz"
    np.savez_compressed(filename, **payload)
    return filename


def read_model(filename: str):
    """Load a model written by save_model."""
    from ..models_migration.primitives import LineModel

    data = np.load(filename, allow_pickle=False)
    pd_data = {k[4:]: data[k] for k in data.files if k.startswith("pd__")}
    if "faces" in data.files:
        return Mesh(data["points"], data["faces"], pd_data)
    if "lines" in data.files:
        return LineModel(data["points"], data["lines"], pd_data)
    return PointCloud(data["points"], pd_data)
