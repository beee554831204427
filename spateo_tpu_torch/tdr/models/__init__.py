"""3D model containers (counterpart of the parts of `spateo_tpu.tdr.models`
ported so far): `PointCloud`, `Mesh`, the line and arrow primitives and
`add_model_labels`. Point clouds from data, surfaces, voxels, backbones and
the morphofield models are not ported yet (ROADMAP Queue 1 item 11)."""

from .mesh_core import Mesh, PointCloud, collect_models, merge_models
from .models_migration import (
    construct_align_lines,
    construct_arrow,
    construct_arrows,
    construct_axis_line,
    construct_line,
    construct_lines,
    generate_edges,
)
from .utilities import add_model_labels
