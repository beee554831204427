"""Aggregate cells into spatial bins (counterpart of
`spateo_tpu.preprocessing.aggregate`; reference
spateo/preprocessing/aggregate.py:14). Host scipy.sparse, copied."""

from __future__ import annotations

import numpy as np
import pandas as pd
from scipy import sparse

from ..configuration import SKM
from ..core.anndata import AnnData


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE, "adata")
def bin_adata(adata: AnnData, bin_size: int = 1, coords_key: str = "spatial") -> AnnData:
    """Sum-aggregate cells whose (binned) spatial coordinates coincide into
    pseudo-cells, by an indicator-matrix product (no dense groupby)."""
    coords = (np.asarray(adata.obsm[coords_key])[:, :2] // bin_size).astype(np.int64)
    keys = coords[:, 0] * (coords[:, 1].max() + 1) + coords[:, 1]
    uniq, codes = np.unique(keys, return_inverse=True)
    n_bins = len(uniq)
    indicator = sparse.coo_matrix(
        (np.ones(adata.n_obs), (codes, np.arange(adata.n_obs))), shape=(n_bins, adata.n_obs)
    ).tocsr()
    X = indicator @ (adata.X if sparse.issparse(adata.X) else sparse.csr_matrix(adata.X))

    # bin coordinates: each bin's first cell
    first = np.full(n_bins, adata.n_obs, dtype=int)
    np.minimum.at(first, codes, np.arange(adata.n_obs))
    bin_coords = coords[first]

    out = AnnData(
        X=X,
        obs=pd.DataFrame(index=[f"{x}_{y}" for x, y in bin_coords]),
        var=adata.var.copy(),
    )
    out.uns[SKM.ADATA_TYPE_KEY] = SKM.ADATA_UMI_TYPE
    out.obsm[coords_key] = bin_coords.astype(np.float64)
    return out
