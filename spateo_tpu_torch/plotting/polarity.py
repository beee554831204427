"""Expression-vs-region polarity plot (counterpart of
`spateo_tpu.plotting.polarity`; reference
spateo/plotting/static/polarity.py:10 — seaborn replaced by direct
matplotlib line/KDE rendering).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
from scipy.sparse import issparse
from .utils import _pyplot


def _gene_vec(adata, gene: str) -> np.ndarray:
    j = list(map(str, adata.var_names)).index(str(gene))
    col = adata.X[:, j]
    return np.asarray(col.toarray()).ravel() if issparse(adata.X) else np.asarray(col).ravel()


def polarity(adata, gene_dict: dict, region_key: str, mode: str = "density", ax=None):
    """Visualize expression varying along digitized regions
    (parity: reference polarity.py:10). `mode='exp'` draws per-region mean
    expression lines with a shaded ±sem band; `mode='density'` draws a
    weighted Gaussian-KDE over the region axis."""
    plt = _pyplot()

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4))
    regions = np.asarray(adata.obs[region_key], dtype=float)
    uniq = np.unique(regions)
    for anno, genes in gene_dict.items():
        for gene in np.atleast_1d(genes):
            v = _gene_vec(adata, gene)
            label = f"{gene} {anno}"
            if mode == "exp":
                means = np.asarray([v[regions == r].mean() for r in uniq])
                sems = np.asarray([v[regions == r].std() / max(np.sqrt((regions == r).sum()), 1) for r in uniq])
                ax.plot(uniq, means, label=label)
                ax.fill_between(uniq, means - sems, means + sems, alpha=0.2)
            else:
                w = np.asarray([v[regions == r].mean() for r in uniq])
                w = np.maximum(w, 0)
                if w.sum() <= 0:
                    continue
                # weighted Gaussian KDE over the region axis
                grid = np.linspace(uniq.min(), uniq.max(), 200)
                h = max((uniq.max() - uniq.min()) / max(len(uniq), 1) * 1.5, 1e-6)
                dens = (w[None, :] * np.exp(-((grid[:, None] - uniq[None, :]) ** 2) / (2 * h**2))).sum(1)
                dens /= np.trapezoid(dens, grid) + 1e-12
                ax.plot(grid, dens, label=label)
    ax.set_xlabel(region_key)
    ax.set_ylabel("Mean expression" if mode == "exp" else "density")
    ax.legend(fontsize=7, frameon=False)
    if mode == "density":
        ax.set_xlim(float(regions.min()), float(regions.max()))
    return ax
