"""Interpolation engines: expression -> continuous 3D field (counterpart of
`spateo_tpu.tdr.interpolations`): VTK-style Shepard/Gaussian/linear, the
sparse GP, the SparseVFC kernel and the deep SIREN engines, and the hull
grid."""

from .interpolation_dl import (
    DeepInterpolation,
    cosine_distance,
    deep_intepretation,
    mad,
    mse,
    subset_best_samples,
    weighted_cosine_distance,
    weighted_mad,
    weighted_mean,
    weighted_mse,
)
from .interpolation_gp import gp_interpolation
from .interpolation_sparseVFC import kernel_interpolation
from .interpolation_vtk import vtk_interpolation
from .utils import get_X_Y_grid, in_hull, polyhull
