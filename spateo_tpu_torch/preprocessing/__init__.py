"""Preprocessing layer (`stt.pp`): filters, normalization (total counts,
the edgeR factors with TMM on the device, Seurat HVFs), the expression
transforms, spatial binning and the live-wire segmentation helpers of
`auxseg`, ported from `spateo_tpu.preprocessing`. `image` is not ported yet
(ROADMAP Queue 1 item 11)."""

from . import auxseg, filter
from .aggregate import bin_adata
from .filter import filter_by_coordinates, filter_cells, filter_genes
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
