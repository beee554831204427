"""NB-mixture EM (public module; compute in spateo_tpu_torch.ops.em)."""

from ..ops.em import (
    conditionals,
    confidence,
    lamtheta_to_muvar,
    lamtheta_to_r,
    muvar_to_lamtheta,
    nb_logpmf,
    nbn_em,
    nbn_pmf,
    run_em,
)

__all__ = [
    "conditionals",
    "confidence",
    "lamtheta_to_muvar",
    "lamtheta_to_r",
    "muvar_to_lamtheta",
    "nb_logpmf",
    "nbn_em",
    "nbn_pmf",
    "run_em",
]
