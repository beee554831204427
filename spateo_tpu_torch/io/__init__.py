"""IO layer (`spateo_tpu_torch.io`): the readers of `spateo_tpu.io` (BGI
Stereo-seq, MERFISH, NanoString CosMx and its stitched stains, seqFISH,
Seq-Scope, Slide-seq, STARmap, 10x Visium), the stain-image layers, the
alpha-shape hulls (`alpha_shape`, `get_concave_hull`) and the binning,
label-property and hull utilities. All host code; OpenCV is imported inside
the functions that read images."""

from . import image_utils, nanostring, slideseq, tenx
from .bbs import alpha_shape, get_concave_hull

from .bgi import dataframe_to_filled_labels, dataframe_to_labels, read_bgi, read_bgi_agg, read_bgi_as_dataframe
from .image import add_image_layer, read_image
from .platforms import (
    read_10x,
    read_10x_as_anndata,
    read_merfish,
    read_nanostring,
    read_seqfish,
    read_seqscope,
    read_slideseq,
    read_starmap,
    stitch_images,
)
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
