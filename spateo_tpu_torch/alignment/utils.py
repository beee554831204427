"""Alignment utilities the ported serial-slice Morpho and PASTE functions need
(counterpart of the matching functions of `spateo_tpu.alignment.utils`).
Host numpy and pandas."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

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


def _dedup_argmax_ties(pairs: np.ndarray, key_col: int, X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """Keep one (i, j) pair per value of `pairs[:, key_col]`: among argmax
    ties, the partner nearest in coordinates wins (one lexsort over (key,
    distance))."""
    d = np.linalg.norm(X[pairs[:, 0]] - Y[pairs[:, 1]], axis=1)
    order = np.lexsort((d, pairs[:, key_col]))
    sp = pairs[order]
    keys = sp[:, key_col]
    first = np.ones(len(sp), dtype=bool)
    first[1:] = keys[1:] != keys[:-1]
    return sp[first]


def get_optimal_mapping_relationship(X: np.ndarray, Y: np.ndarray, pi: np.ndarray, keep_all: bool = False):
    """Optimal correspondences of an assignment matrix, from both sides
    (parity: reference alignment/utils.py:157).

    Returns ``(X_max_index, X_pi_value, Y_max_index, Y_pi_value)``: the [k, 2]
    (i, j) pairs where pi attains each row's maximum (X side) and each
    column's maximum (Y side), exactly (``pi == max``), with the matching pi
    values as [k, 1] columns. With ``keep_all=False`` argmax ties are broken
    by spatial proximity (nearest tied partner kept); with ``keep_all=True``
    every tied pair is returned."""
    pi = np.asarray(pi)
    X = np.asarray(X)
    Y = np.asarray(Y)
    X_max_index = np.argwhere(pi == pi.max(axis=1, keepdims=True))
    Y_max_index = np.argwhere(pi == pi.max(axis=0, keepdims=True))
    if not keep_all:
        X_max_index = _dedup_argmax_ties(X_max_index, 0, X, Y)
        Y_max_index = _dedup_argmax_ties(Y_max_index, 1, X, Y)
    X_pi_value = pi[X_max_index[:, 0], X_max_index[:, 1]].reshape(-1, 1)
    Y_pi_value = pi[Y_max_index[:, 0], Y_max_index[:, 1]].reshape(-1, 1)
    return X_max_index, X_pi_value, Y_max_index, Y_pi_value


def mapping_aligned_coords(X: np.ndarray, Y: np.ndarray, pi: np.ndarray, keep_all: bool = False) -> Tuple[dict, dict]:
    """Optimal mapping coordinates between X and Y (parity: reference
    alignment/utils.py:194): the X-side and Y-side dicts of mapping_X /
    mapping_Y / pi_index / pi_value, each deduplicated to the
    highest-probability partner per point."""
    import pandas as pd

    X = np.asarray(X)
    Y = np.asarray(Y)
    pi = np.asarray(pi)
    X_max_index, X_pi_value, Y_max_index, Y_pi_value = get_optimal_mapping_relationship(X, Y, pi, keep_all=keep_all)
    mappings = []
    for max_index, pi_value, subset in zip(
        [X_max_index, Y_max_index], [X_pi_value, Y_pi_value], ["index_x", "index_y"]
    ):
        data = pd.DataFrame(
            {
                "index_x": max_index[:, 0].astype(np.int32),
                "index_y": max_index[:, 1].astype(np.int32),
                "pi_value": pi_value[:, 0].astype(np.float64),
            }
        )
        data.sort_values(by=[subset, "pi_value"], ascending=[True, False], inplace=True)
        data.drop_duplicates(subset=[subset], keep="first", inplace=True)
        mappings.append(
            {
                "mapping_X": X[data["index_x"].values],
                "mapping_Y": Y[data["index_y"].values],
                "pi_index": data[["index_x", "index_y"]].values,
                "pi_value": data["pi_value"].values,
            }
        )
    return mappings[0], mappings[1]


def mapping_center_coords(modelA, modelB, center_key: str) -> dict:
    """Compose two slice->center mappings into a direct A<->B mapping by
    joining on the shared center index (parity: reference
    alignment/utils.py:258)."""
    import pandas as pd

    dA = modelA.uns[center_key]
    dB = modelB.uns[center_key]
    mapping_X_cols = [f"mapping_X_{i}" for i in range(np.asarray(dA["mapping_Y"]).shape[1])]
    raw_X_cols = [f"raw_X_{i}" for i in range(np.asarray(dA["raw_Y"]).shape[1])]
    mapping_Y_cols = [f"mapping_Y_{i}" for i in range(np.asarray(dB["mapping_Y"]).shape[1])]
    raw_Y_cols = [f"raw_Y_{i}" for i in range(np.asarray(dB["raw_Y"]).shape[1])]

    X_data = pd.DataFrame(
        np.concatenate([np.asarray(dA["raw_Y"]), np.asarray(dA["mapping_Y"]), np.asarray(dA["pi_index"])[:, [0]]], axis=1),
        columns=mapping_X_cols + raw_X_cols + ["mid"],
    )
    X_data["pi_value_X"] = np.asarray(dA["pi_value"], np.float64)
    Y_data = pd.DataFrame(
        np.concatenate([np.asarray(dB["raw_Y"]), np.asarray(dB["mapping_Y"]), np.asarray(dB["pi_index"])[:, [0]]], axis=1),
        columns=mapping_Y_cols + raw_Y_cols + ["mid"],
    )
    Y_data["pi_value_Y"] = np.asarray(dB["pi_value"], np.float64)
    merged = pd.merge(Y_data, X_data, on=["mid"], how="inner")
    merged["pi_value"] = merged["pi_value_X"].values * merged["pi_value_Y"].values
    return {
        "raw_X": merged[raw_X_cols].values,
        "raw_Y": merged[raw_Y_cols].values,
        "mapping_X": merged[mapping_X_cols].values,
        "mapping_Y": merged[mapping_Y_cols].values,
        "pi_value": merged["pi_value"].astype(np.float64).values,
    }
