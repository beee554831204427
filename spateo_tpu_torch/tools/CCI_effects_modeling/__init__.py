"""MuSIC: CCI effects modeling by spatially-weighted regression
(parity: reference spateo/tools/CCI_effects_modeling/__init__.py).

The fit path is ported: `MuSIC` from `define_sig_inputs` through `fit` and
`predict`, its regression machinery and families. `MuSIC_Interpreter`
(`MuSIC_downstream.py`) and `MuSIC_Molecule_Selector` (`MuSIC_upstream.py`)
are not ported yet (ROADMAP Queue 1 item 8b)."""

from . import distributions, regression_utils
from .distributions import Binomial, Gamma, Gaussian, NegativeBinomial, Poisson
from .MuSIC import MuSIC
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
