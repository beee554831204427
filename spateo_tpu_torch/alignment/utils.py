"""Alignment utilities the ported serial-slice Morpho functions need (counterpart of the
matching functions of `spateo_tpu.alignment.utils`)."""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from ..core.anndata import AnnData
from ..logging import logger_manager as lm
from .methods.sampling import sample_indices


def _iteration(n: int, progress_name: str, verbose: bool = True, start_n: int = 0, indent_level=1):
    iteration = range(start_n, n)
    if verbose:
        return lm.progress_logger(iteration, progress_name=progress_name)
    return iteration


def downsampling(
    models: Union[List[AnnData], AnnData],
    n_sampling: Optional[int] = 2000,
    sampling_method: str = "random",
    spatial_key: str = "spatial",
    seed: int = 0,
) -> List[AnnData]:
    """Downsample AnnData(s) by spatial sampling (parity: reference
    alignment/utils.py:25; 'random', 'kmeans', 'trn' or 'lhs' from
    `methods.sampling`). Host-side."""
    models = models if isinstance(models, list) else [models]
    out = []
    for m in models:
        n = min(n_sampling, m.n_obs)
        idx = sample_indices(np.asarray(m.obsm[spatial_key]), n, method=sampling_method, seed=seed)
        out.append(m[idx, :])
    return out


def generate_label_transfer_dict(
    cat1,
    cat2,
    positive_pairs=None,
    negative_pairs=None,
    default_positive_value: float = 10.0,
    default_negative_value: float = 1.0,
):
    """Row-normalised label-transfer prior dictionary (parity: reference
    methods/utils.py:376). Pairs are dicts with 'left'/'right'/'value'."""
    label_transfer_dict = {c1: {c2: 1.0 for c2 in cat2} for c1 in cat1}
    if positive_pairs is None and negative_pairs is None:
        label_transfer_dict = {c1: {c2: default_negative_value for c2 in cat2} for c1 in cat1}
        common = np.union1d(np.asarray(cat1, dtype=object), np.asarray(cat2, dtype=object))
        positive_pairs = [{"left": [c], "right": [c], "value": default_positive_value} for c in common]
    for pairs in (positive_pairs, negative_pairs):
        if pairs is None:
            continue
        for p in pairs:
            for l in p["left"]:
                for r in p["right"]:
                    if r in label_transfer_dict and l in label_transfer_dict[r]:
                        label_transfer_dict[r][l] = p["value"]
    out = {}
    for c1 in cat1:
        norm = sum(label_transfer_dict[c1][c2] for c2 in cat2)
        out[c1] = {c2: label_transfer_dict[c1][c2] / (norm + 1e-8) for c2 in cat2}
    return out


def solve_RT_by_correspondence(X: np.ndarray, Y: np.ndarray, return_scale: bool = False):
    """Procrustes solve of R, t mapping Y onto X given correspondences
    (parity: alignment/utils.py:350). Host-side numpy."""
    X = np.asarray(X)
    Y = np.asarray(Y)
    tX = np.mean(X, axis=0)
    tY = np.mean(Y, axis=0)
    X_demean = X - tX
    Y_demean = Y - tY
    H = np.dot(Y_demean.T, X_demean)
    U, S, Vt = np.linalg.svd(H)
    R = np.dot(Vt.T, U.T)
    t = tX - np.dot(tY, R.T)
    if return_scale:
        s = np.trace(np.dot(X_demean.T, X_demean) - np.dot(R.T, np.dot(Y_demean.T, X_demean))) / np.trace(
            np.dot(Y_demean.T, Y_demean)
        )
        return R, t, s
    return R, t
