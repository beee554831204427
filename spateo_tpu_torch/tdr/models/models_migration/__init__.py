"""Migration/vector-field visualization models (counterpart of
`spateo_tpu.tdr.models.models_migration`): the morphofield and morphopath
models and the line and arrow primitives."""

from .morphofield_model import construct_field, construct_field_plain, construct_field_streams
from .morphopath_model import construct_genesis, construct_genesis_X, construct_trajectory, construct_trajectory_X
from .primitives import (
    construct_align_lines,
    construct_arrow,
    construct_arrows,
    construct_axis_line,
    construct_line,
    construct_lines,
    generate_edges,
)
