"""Cell segmentation layer (Starro, `spateo_tpu_torch.cs`).

The user path of `spateo_tpu.segmentation`: RNA-based pixel scoring and
masking (the fused EM+BP program and the staged gauss, moran, EM and VI
methods with density bins and certain masks), stain masks, density binning,
the labeling chain, benchmarking and simulation, the stain <-> RNA alignment
refinement (`refine_alignment`, Adam on the device), QC regions and random
labels, the simulation and evaluation tools, and the external model wrappers.
"""

from . import simulation_evaluation
from .align import refine_alignment
from .benchmark import compare
from .bp import cell_marginals, create_neighbor_offsets, run_bp
from .density import merge_densities, segment_densities
from .em import conditionals, confidence, nbn_em, run_em
from .external import cellpose, deepcell, stardist
from .icell import mask_cells_from_stain, mask_nuclei_from_stain, score_and_mask_pixels
from .label import (
    augment_labels,
    expand_labels,
    find_peaks,
    find_peaks_from_mask,
    find_peaks_with_erosion,
    label_connected_components,
    replace_labels,
    watershed,
    watershed_fused,
)
from .moran import moranI, run_moran, run_moran_and_mask_pixels
from .qc import generate_random_labels, generate_random_labels_like, select_qc_regions
from .simulation import simulate_cells
from .starro import starro_em_bp, starro_em_bp_stream
from .utils import (
    apply_threshold,
    cal_cell_area,
    filter_cell_labels_by_area,
    get_cell_shape,
    label_overlap,
    safe_erode,
)
from .vi import run_vi
