"""MuSIC: CCI effects modeling by spatially-weighted regression
(parity: reference spateo/tools/CCI_effects_modeling/__init__.py).

`MuSIC` from `define_sig_inputs` through `fit` and `predict`, its
regression machinery and families, the interpretation of a fit
(`MuSIC_Interpreter`, `MuSIC_downstream.py`) and the selection of molecules
before one (`MuSIC_Molecule_Selector`, `MuSIC_upstream.py`)."""

from . import MuSIC_downstream, MuSIC_upstream, distributions, regression_utils
from .distributions import Binomial, Gamma, Gaussian, NegativeBinomial, Poisson
from .MuSIC import MuSIC
from .MuSIC_downstream import MuSIC_Interpreter
from .MuSIC_upstream import MuSIC_Molecule_Selector
from .regression_utils import (
    compute_betas,
    compute_betas_local,
    iwls,
    iwls_batch,
    iwls_batch_full,
    multitesting_correction,
    wald_test,
)
from .SWR import define_spateo_argparse
