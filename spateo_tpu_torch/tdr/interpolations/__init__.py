"""Interpolation: the SparseVFC kernel engine and the hull grid (counterpart
of `spateo_tpu.tdr.interpolations`). The VTK, GP and deep-MLP engines are
not ported yet (ROADMAP Queue 1 item 11)."""

from .interpolation_sparseVFC import kernel_interpolation
from .utils import get_X_Y_grid, in_hull, polyhull
