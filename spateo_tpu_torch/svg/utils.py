"""SVG utilities: the Benjamini-Hochberg adjustment, copied from
`spateo_tpu.svg.utils` (numpy), which MuSIC's `moran_i` route and
`regression_utils.multitesting_correction` use. The rest of that module
(OT distances, binning, smoothing) is not ported yet (ROADMAP Queue 1
item 10)."""

from __future__ import annotations

import numpy as np


def multipletests_bh(pvals: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg adjusted p-values."""
    pvals = np.asarray(pvals, float)
    n = len(pvals)
    order = np.argsort(pvals)
    ranked = pvals[order] * n / (np.arange(n) + 1)
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n)
    out[order] = np.clip(ranked, 0, 1)
    return out
