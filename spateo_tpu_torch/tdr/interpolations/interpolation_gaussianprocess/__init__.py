"""GP model/training shims (capability parity: reference
tdr/interpolations/interpolation_gaussianprocess/{gp_models,gp_train}.py;
counterpart of `spateo_tpu.tdr.interpolations.interpolation_gaussianprocess`):
the gpytorch Exact/Approx models are realized by the SGPR of
interpolation_gp.py."""

from .gp_models import Approx_GPModel, Exact_GPModel
from .gp_train import gp_train
