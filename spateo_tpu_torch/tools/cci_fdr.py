"""FDR correction over CCI p-value tables (capability parity: reference
spateo/tools/cci_fdr.py:13 fdr_correct).

Counterpart of `spateo_tpu.tools.cci_fdr`: host code, copied.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from .CCI_effects_modeling.regression_utils import multitesting_correction


def fdr_correct(
    pvals: pd.DataFrame,
    corr_method: str = "fdr_bh",
    corr_axis: str = "clusters",
    alpha: float = 0.05,
) -> pd.DataFrame:
    """Correct a [interactions x clusters] p-value table along the chosen
    axis (parity: reference cci_fdr.py:13)."""
    df = pd.DataFrame(pvals).copy()
    if corr_axis == "clusters":
        for col in df.columns:
            v = df[col].values.astype(float)
            ok = np.isfinite(v)
            out = v.copy()
            if ok.any():
                out[ok] = multitesting_correction(v[ok], method=corr_method, alpha=alpha)
            df[col] = out
    elif corr_axis == "interactions":
        for idx in df.index:
            v = df.loc[idx].values.astype(float)
            ok = np.isfinite(v)
            out = v.copy()
            if ok.any():
                out[ok] = multitesting_correction(v[ok], method=corr_method, alpha=alpha)
            df.loc[idx] = out
    else:
        raise ValueError(f"corr_axis must be 'clusters' or 'interactions', got {corr_axis}")
    return df
