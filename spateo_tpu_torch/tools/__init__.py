"""Tools layer (`stt.tl`): MuSIC's fit path, its spatial kernel weights and
the Moran's I test, ported from `spateo_tpu.tools`. Clustering, DEGs, the
other spatial statistics, CCI helpers, `MuSIC_Interpreter` and
`MuSIC_Molecule_Selector` are not ported yet (ROADMAP Queue 1 items 8b and
11)."""

from . import find_neighbors, spatial_degs
from .CCI_effects_modeling import SWR, MuSIC, define_spateo_argparse, distributions, regression_utils
from .find_neighbors import Kernel, calculate_distance, get_wi, get_wi_batch, local_dist
from .spatial_degs import moran_i
