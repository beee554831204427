"""Morphometrics (counterpart of `spateo_tpu.tdr.morphometrics`):
morphofield learning, its differential geometry, trajectories, model
morphology and kernel density, and shape similarity."""

from .morphofield import cell_directions, morphofield_gp, morphofield_sparsevfc, morphofield_sparsevfc_batch
from .morphofield_dg import (
    GPVectorField,
    morphofield_acceleration,
    morphofield_curl,
    morphofield_curvature,
    morphofield_divergence,
    morphofield_jacobian,
    morphofield_torsion,
    morphofield_velocity,
)
from .morphology import model_morphology, pc_KDE
from .shape_similarity import model_eigenvector, pairwise_shape_similarity
from .trajectory import morphopath
