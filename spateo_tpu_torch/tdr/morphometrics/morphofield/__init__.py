"""Morphofield learning (counterpart of
`spateo_tpu.tdr.morphometrics.morphofield`)."""

from .gaussian_process import _con_K, _con_K_geodist, _gp_velocity, morphofield_gp
from .sparsevfc import _morphofield_sparsevfc, cell_directions, morphofield_sparsevfc, morphofield_sparsevfc_batch
