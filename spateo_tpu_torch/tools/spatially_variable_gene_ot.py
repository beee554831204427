"""OT-based spatially-variable-gene scan (counterpart of
`spateo_tpu.tools.spatially_variable_gene_ot`; reference
spateo/tools/spatially_variable_gene_ot.py, a duplicate of the svg layer's
Wasserstein machinery: this module re-exports the one implementation)."""

import numpy as np
from scipy.sparse import issparse

from ..preprocessing.aggregate import bin_adata  # noqa: F401
from ..svg.get_svg import cal_wass_dist_bs as cal_wass_dis_bs  # noqa: F401
from ..svg.utils import cal_wass_dis_batch  # noqa: F401


def shuffle_adata(adata, seed: int = 0, replace: bool = False):
    """Permute expression rows to build a spatial null (parity: reference
    spatially_variable_gene_ot.py shuffle_adata); unlike `svg.shuffle_adata`,
    seed 0 shuffles too."""
    rng = np.random.default_rng(seed)
    out = adata.copy()
    idx = rng.choice(adata.n_obs, adata.n_obs, replace=replace) if replace else rng.permutation(adata.n_obs)
    X = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X)
    out.X = X[idx]
    return out
