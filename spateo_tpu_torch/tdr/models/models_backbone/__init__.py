"""Organ backbone (principal curve/tree) construction (counterpart of
`spateo_tpu.tdr.models.models_backbone`; capability parity: reference
spateo/tdr/models/models_backbone/)."""

from .backbone import backbone_scc, construct_backbone
from .backbone_methods import ElPiGraph_tree, PrinCurve, SimplePPT_tree
from .backbone_utils import map_gene_to_backbone, map_points_to_backbone, update_backbone
