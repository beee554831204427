"""TDR layer (`stt.tdr`): 3D reconstruction and morphometrics, ported from
`spateo_tpu.tdr`: point clouds, surfaces (alpha shape, ball pivoting,
marching cubes, and screened Poisson with its splat and CG solve on the
device), voxels, backbones (ElPiGraph with its candidate fits batched on the
device, SimplePPT, the NLPCA principal curve), the morphofield and
morphopath models, model IO and utilities, morphofields and their
differential geometry, trajectories, model morphology with the kernel
density, shape similarity, and the SparseVFC kernel interpolation.

Not ported yet (ROADMAP Queue 1 item 11): the VTK, GP and deep
interpolation engines (`interpolation_{vtk,gp,dl}.py`,
`interpolation_gaussianprocess/`), the widgets (`widgets/`), and
`backbone_scc`, which waits for `tools/cluster` and raises."""

from . import models
from .interpolations import get_X_Y_grid, in_hull, kernel_interpolation, polyhull
from .models import *  # noqa: F401,F403
from .models.models_backbone.backbone_methods import (
    ElPiGraph_method,
    NLPCA,
    PrinCurve_method,
    SimplePPT_method,
)
from .morphometrics.morphofield_dg import (
    Jacobian_GP_gaussian_kernel,
    compute_acceleration,
    compute_curl,
    compute_curvature,
    compute_divergence,
    compute_sensitivity,
    compute_torsion,
)
from .morphometrics import *  # noqa: F401,F403
