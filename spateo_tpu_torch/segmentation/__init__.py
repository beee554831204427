"""Cell segmentation layer (Starro, `spateo_tpu_torch.cs`): the ported slice.

The EM+BP scoring and masking of `spateo_tpu.segmentation`; the rest of that
package is listed in ROADMAP.md as still to be ported.
"""

from .bp import cell_marginals, create_neighbor_offsets, run_bp
from .em import conditionals, nbn_em
from .icell import score_and_mask_pixels
from .starro import starro_em_bp, starro_em_bp_stream
