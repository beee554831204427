"""Morphometrics (counterpart of `spateo_tpu.tdr.morphometrics`): morphofield
learning, its differential geometry and trajectories. Morphology and shape
similarity are not ported yet (ROADMAP Queue 1 item 11)."""

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
from .trajectory import morphopath
