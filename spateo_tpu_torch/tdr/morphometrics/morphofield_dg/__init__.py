"""Differential geometry of morphofields (counterpart of
`spateo_tpu.tdr.morphometrics.morphofield_dg`)."""

from .differential_geometry import (
    morphofield_acceleration,
    morphofield_curl,
    morphofield_curvature,
    morphofield_divergence,
    morphofield_jacobian,
    morphofield_torsion,
    morphofield_velocity,
)
from .GPVectorField import (
    GPVectorField,
    Jacobian_GP_gaussian_kernel,
    compute_acceleration,
    compute_curl,
    compute_curvature,
    compute_divergence,
    compute_sensitivity,
    compute_torsion,
)
