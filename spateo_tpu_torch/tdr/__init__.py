"""TDR layer (`stt.tdr`): morphofields and their differential geometry,
trajectories, the SparseVFC kernel interpolation, and the model containers
mesh correction needs (`PointCloud`, `Mesh`, line and arrow primitives,
`add_model_labels`), ported from `spateo_tpu.tdr`. Surface reconstruction,
voxels, backbones, widgets and the VTK, GP and deep interpolation engines
are not ported yet (ROADMAP Queue 1 item 11)."""

from . import models
from .interpolations import get_X_Y_grid, in_hull, kernel_interpolation, polyhull
from .models import *  # noqa: F401,F403
from .morphometrics.morphofield_dg import (
    Jacobian_GP_gaussian_kernel,
    compute_acceleration,
    compute_curl,
    compute_curvature,
    compute_divergence,
    compute_sensitivity,
    compute_torsion,
)
from .morphometrics import (
    GPVectorField,
    cell_directions,
    morphofield_acceleration,
    morphofield_curl,
    morphofield_curvature,
    morphofield_divergence,
    morphofield_gp,
    morphofield_jacobian,
    morphofield_sparsevfc,
    morphofield_sparsevfc_batch,
    morphofield_torsion,
    morphofield_velocity,
    morphopath,
)
