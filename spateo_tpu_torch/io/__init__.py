"""IO layer (`spateo_tpu_torch.io`): the BGI Stereo-seq readers, the
alpha-shape hulls (`alpha_shape`, `get_concave_hull`) and the binning,
label-property and hull utilities of `spateo_tpu.io`. The other platform
readers are listed in ROADMAP.md as still to be ported."""

from .bbs import alpha_shape, get_concave_hull

from .bgi import dataframe_to_filled_labels, dataframe_to_labels, read_bgi, read_bgi_agg, read_bgi_as_dataframe
from .utils import (
    bin_indices,
    bin_matrix,
    centroids,
    contour_to_geo,
    get_bin_props,
    get_coords_labels,
    get_label_props,
    get_points_props,
    in_concave_hull,
    in_convex_hull,
)
