"""TDR layer (`stt.tdr`): 3D reconstruction and morphometrics, ported from
`spateo_tpu.tdr`: point clouds, surfaces (alpha shape, ball pivoting,
marching cubes, and screened Poisson with its splat and CG solve on the
device), voxels, backbones (ElPiGraph with its candidate fits batched on the
device, SimplePPT, the NLPCA principal curve), the morphofield and
morphopath models, model IO and utilities, morphofields and their
differential geometry, trajectories, model morphology with the kernel
density, shape similarity, the interpolation engines (VTK-style, sparse
GP, SparseVFC kernel, deep SIREN), and the model-editing widgets (clip,
pick, slice; `points_inside_mesh` on the device, the matplotlib loops
headless-drivable); `backbone_scc` clusters through `tools.cluster.scc`."""

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
from .widgets import clip, pick, slice, utils  # noqa: F401
from .widgets import (
    clip_models,
    interactive_box_clip,
    interactive_pick,
    interactive_rectangle_clip,
    interactive_slice,
    overlap_mesh_pick,
    overlap_pc_pick,
    overlap_pick,
    pick_models,
    slice_models,
    three_d_pick,
    three_d_slice,
)
