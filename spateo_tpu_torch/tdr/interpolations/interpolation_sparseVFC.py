"""Kernel (SparseVFC) interpolation of expression (counterpart of
`spateo_tpu.tdr.interpolations.interpolation_sparseVFC`; reference
spateo/tdr/interpolations/interpolation_sparseVFC.py:13)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pandas as pd

from ...core.anndata import AnnData
from ...logging import logger_manager as lm
from ...ops.vfc import SparseVFC
from .utils import get_X_Y_grid


def kernel_interpolation(
    adata: Optional[AnnData] = None,
    genes: Optional[List] = None,
    X: Optional[np.ndarray] = None,
    Y: Optional[np.ndarray] = None,
    NX: Optional[np.ndarray] = None,
    grid_num: List = [50, 50, 50],
    lambda_: float = 0.02,
    lstsq_method: str = "scipy",
    device="cuda",
    **kwargs,
) -> AnnData:
    """Learn a continuous expression field with SparseVFC kernel regression
    on `device` and evaluate it at new points (parity:
    interpolation_sparseVFC.py:13)."""
    X, Y, Grid, grid_in_hull = get_X_Y_grid(adata=adata, genes=genes, X=X, Y=Y, grid_num=grid_num)
    predict_X = Grid if NX is None else np.asarray(NX)
    res = SparseVFC(X, Y, predict_X, lambda_=lambda_, lstsq_method=lstsq_method, device=device, **kwargs)
    interp_Y = res["grid_V"]
    genes = genes if genes is not None else [f"y{i}" for i in range(Y.shape[1])]
    interp_adata = AnnData(
        X=np.asarray(interp_Y),
        obs=pd.DataFrame(index=[f"grid_{i}" for i in range(len(predict_X))]),
        var=pd.DataFrame(index=list(genes)),
    )
    interp_adata.obsm["spatial"] = predict_X
    interp_adata.uns["__type"] = "UMI"
    interp_adata.uns["vf_dict"] = {k: v for k, v in res.items() if k in ("X_ctrl", "C", "beta", "sigma2")}
    lm.main_info("Creating an adata object with the interpolated expression...")
    return interp_adata
