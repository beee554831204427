"""Preprocessing layer (`stt.pp`): the expression transforms MuSIC needs,
copied from `spateo_tpu.preprocessing.transform`, and spatial binning
(`bin_adata`, `spateo_tpu.preprocessing.aggregate`). Filters,
normalization and the rest of `spateo_tpu.preprocessing` are not ported yet
(ROADMAP Queue 1 item 11)."""

from .aggregate import bin_adata
from .transform import log1p, log1p_array, log1p_sparse, scale
