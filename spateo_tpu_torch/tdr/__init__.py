"""TDR layer (`stt.tdr`): 3D reconstruction and morphometrics, ported from
`spateo_tpu.tdr`: point clouds, surfaces (alpha shape, ball pivoting,
marching cubes, and screened Poisson with its splat and CG solve on the
device), voxels, backbones (ElPiGraph with its candidate fits batched on the
device, SimplePPT, the NLPCA principal curve), the morphofield and
morphopath models, model IO and utilities, morphofields and their
differential geometry, trajectories, model morphology with the kernel
density, shape similarity, and the interpolation engines (VTK-style, sparse
GP, SparseVFC kernel, deep SIREN); `backbone_scc` clusters through
`tools.cluster.scc`.

Not ported yet (ROADMAP Queue 1 item 11): the widgets (`widgets/`)."""

from . import models
from .interpolations import (
    deep_intepretation,
    get_X_Y_grid,
    gp_interpolation,
    in_hull,
    kernel_interpolation,
    polyhull,
    vtk_interpolation,
)
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
