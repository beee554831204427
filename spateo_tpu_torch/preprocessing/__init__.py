"""Preprocessing layer (`stt.pp`): filters, normalization (total counts,
the edgeR factors with TMM on the device, Seurat HVFs), the expression
transforms, spatial binning and the live-wire segmentation helpers of
`auxseg`, and the stain images' background removal (`image`, OpenCV's
Otsu), ported from `spateo_tpu.preprocessing`."""

from . import auxseg, filter, image
from .aggregate import bin_adata
from .filter import filter_by_coordinates, filter_cells, filter_genes
from .image import remove_background
from .normalize import (
    calcFactorRLE,
    calcFactorTMM,
    calcFactorTMMwsp,
    calcNormFactors,
    factor_normalization,
    normalize_total,
    select_hvf_seurat,
)
from .transform import log1p, log1p_array, log1p_sparse, scale
