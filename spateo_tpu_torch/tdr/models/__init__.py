"""3D model construction (counterpart of `spateo_tpu.tdr.models`): point
clouds, surfaces (the screened-Poisson solve on the device), voxels,
backbones (ElPiGraph's candidate fits batched on the device), the
morphofield and morphopath models, the line and arrow primitives and the
model utilities. Everything `spateo_tpu.tdr.models` exports is here."""

from .mesh_core import Mesh, PointCloud, collect_models, merge_models
from .models_backbone import (
    backbone_scc,
    construct_backbone,
    map_gene_to_backbone,
    map_points_to_backbone,
    update_backbone,
)
from .utilities import (
    add_model_labels,
    center_to_zero,
    collect_models,
    multiblock2model,
    read_model,
    rotate_model,
    save_model,
    scale_model,
    split_model,
    translate_model,
)
from .models_individual import construct_cells, construct_pc, construct_surface, voxelize_mesh, voxelize_pc
from .models_migration import (
    construct_align_lines,
    construct_arrow,
    construct_arrows,
    construct_axis_line,
    construct_field,
    construct_field_plain,
    construct_field_streams,
    generate_edges,
    construct_genesis,
    construct_genesis_X,
    construct_line,
    construct_lines,
    construct_trajectory,
    construct_trajectory_X,
)
from .models_backbone.backbone_methods import (
    ElPiGraph_method,
    NLPCA,
    PrinCurve_method,
    SimplePPT_method,
)
