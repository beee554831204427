"""Point-cloud / surface / voxel model construction (counterpart of
`spateo_tpu.tdr.models.models_individual`; capability parity: reference
spateo/tdr/models/models_individual/)."""

from .mesh import construct_cells, construct_surface
from .point_clouds import construct_pc
from .voxel import voxelize_mesh, voxelize_pc
