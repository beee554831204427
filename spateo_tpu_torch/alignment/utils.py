"""Alignment utilities (counterpart of `spateo_tpu.alignment.utils`; reference
spateo/alignment/utils.py): downsampling, label-transfer priors, the mapping
helpers, the rigid and TPS simulations, slice splitting and the
deprecated-API `align_preprocess`. Host numpy and pandas, but for
`group_pca`'s PCA and the k-means downsampling, which run on `device`."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

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
    device="cuda",
) -> List[AnnData]:
    """Downsample AnnData(s) by spatial sampling (parity: reference
    alignment/utils.py:25; 'random', 'kmeans', 'trn' or 'lhs' from
    `methods.sampling`). Host-side but for 'kmeans', which runs on `device`."""
    models = models if isinstance(models, list) else [models]
    out = []
    for m in models:
        n = min(n_sampling, m.n_obs)
        idx = sample_indices(np.asarray(m.obsm[spatial_key]), n, method=sampling_method, seed=seed, device=device)
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


def generate_label_transfer_prior(cat1, cat2, positive_pairs=None, negative_pairs=None) -> Dict:
    """Label transfer prior dict (parity: alignment/utils.py:51): matrix of
    transfer probabilities between categorical labels."""
    label_transfer_prior = dict()
    positive_pairs = list(positive_pairs) if positive_pairs else []
    negative_pairs = list(negative_pairs) if negative_pairs else []
    # same-name pairs default in only when NO pairs of either kind were
    # given (reference alignment/utils.py:58 checks both lists' lengths)
    if len(positive_pairs) == 0 and len(negative_pairs) == 0:
        positive_pairs = [{"left": [c], "right": [c], "value": 10.0} for c in cat1 if c in cat2]
    for c2 in cat2:
        cur_transfer_prior = {c1: 1.0 for c1 in cat1}
        label_transfer_prior[c2] = cur_transfer_prior
    for pairs in positive_pairs:
        for l in pairs["left"]:
            for r in pairs["right"]:
                label_transfer_prior[r][l] = pairs["value"]
    for pairs in negative_pairs:
        for l in pairs["left"]:
            for r in pairs["right"]:
                label_transfer_prior[r][l] = pairs["value"]
    # normalize per row
    for c2 in label_transfer_prior:
        total = sum(label_transfer_prior[c2].values())
        label_transfer_prior[c2] = {k: v / total for k, v in label_transfer_prior[c2].items()}
    return label_transfer_prior


def group_pca(
    adatas: List[AnnData],
    batch_key: str = "slices",
    pca_key: str = "X_pca",
    use_hvg: bool = True,
    hvg_top: int = 2000,
    n_comps: int = 50,
    device="cuda",
) -> List[AnnData]:
    """Joint PCA over concatenated slices (parity: alignment/utils.py:88):
    Seurat HVGs on the host, the randomized PCA on `device`."""
    from ..core.anndata import concat
    from ..tools.dimensionality_reduction import pca as run_pca

    for i, a in enumerate(adatas):
        a.obs[batch_key] = str(i)
    joint = concat(adatas, join="inner")
    if use_hvg:
        from ..preprocessing.normalize import select_hvf_seurat

        hv = select_hvf_seurat(joint, n_top=min(hvg_top, joint.n_vars))
        joint = joint[:, hv]
    run_pca(joint, n_pca_components=n_comps, device=device)
    offset = 0
    for a in adatas:
        a.obsm[pca_key] = joint.obsm["X_pca"][offset : offset + a.n_obs]
        offset += a.n_obs
    return adatas


def get_labels_based_on_coords(
    model: AnnData,
    coords: np.ndarray,
    labels_key: Union[str, List[str]],
    spatial_key: str = "align_spatial",
) -> "np.ndarray":
    """Nearest-point label lookup (parity: alignment/utils.py:324)."""
    import pandas as pd
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(model.obsm[spatial_key]))
    _, idx = tree.query(np.asarray(coords), k=1)
    labels_key = [labels_key] if isinstance(labels_key, str) else labels_key
    out = pd.DataFrame({k: np.asarray(model.obs[k])[idx] for k in labels_key})
    return out


def rigid_transformation(adata, spatial_key, key_added, theta=None, translation=None, inplace: bool = True):
    """Apply (random) rigid transformation to spatial coords (parity:
    alignment/utils.py:405)."""
    if not inplace:
        adata = adata.copy()
    spatial = np.asarray(adata.obsm[spatial_key])
    mean = np.mean(spatial, axis=0)
    spatial = spatial - mean
    if theta is None:
        theta = np.random.rand() * 2 * np.pi
    rotation_matrix = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    spatial = spatial @ rotation_matrix + mean
    if translation is not None:
        spatial = spatial + translation
    adata.obsm[key_added] = spatial
    if not inplace:
        return adata


def split_slice(adata, spatial_key, split_num: int = 5, axis: int = 2) -> List[AnnData]:
    """Split a 3D model into slices along an axis (parity: alignment/utils.py:438)."""
    spatial_points = np.asarray(adata.obsm[spatial_key])
    N = spatial_points.shape[0]
    sorted_points = np.argsort(spatial_points[:, axis])
    points_per_segment = len(sorted_points) // split_num
    out = []
    for slice_id, i in enumerate(range(0, N, points_per_segment)):
        sub = adata[sorted_points[i : i + points_per_segment], :]
        sub.obs["slice"] = slice_id
        out.append(sub)
    return out[:split_num]


def tps_deformation(
    adata,
    spatial_key: str,
    key_added: str,
    grid_num: int = 2,
    tps_noise_scale: float = 25,
    alpha: float = 0.1,
    inplace: bool = True,
    seed: int = 0,
):
    """Simulate a smooth non-rigid (thin-plate-spline) deformation (parity:
    alignment/utils.py:515). Implemented with a native TPS solve."""
    if not inplace:
        adata = adata.copy()
    rng = np.random.default_rng(seed)
    spatial = np.asarray(adata.obsm[spatial_key], dtype=float)[:, :2]
    x_min, y_min = spatial.min(0)
    x_max, y_max = spatial.max(0)
    gx = np.linspace(x_min, x_max, grid_num + 1)
    gy = np.linspace(y_min, y_max, grid_num + 1)
    src = np.array([[x, y] for x in gx for y in gy])
    dst = src + rng.normal(0, tps_noise_scale, src.shape)

    # TPS solve: f(x) = sum_i w_i U(|x - src_i|) + a0 + a.x with U(r)=r^2 log r
    def U(r):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(r > 0, r**2 * np.log(r), 0.0)

    n = len(src)
    K = U(np.linalg.norm(src[:, None] - src[None, :], axis=-1)) + alpha * np.eye(n)
    P = np.c_[np.ones(n), src]
    L = np.zeros((n + 3, n + 3))
    L[:n, :n] = K
    L[:n, n:] = P
    L[n:, :n] = P.T
    params = np.linalg.solve(L, np.r_[dst, np.zeros((3, 2))])
    Kq = U(np.linalg.norm(spatial[:, None] - src[None, :], axis=-1))
    warped = Kq @ params[:n] + np.c_[np.ones(len(spatial)), spatial] @ params[n:]
    adata.obsm[key_added] = warped
    if not inplace:
        return adata


def align_preprocess(
    samples,
    rep_layer="X",
    rep_field="layer",
    genes=None,
    spatial_key: str = "spatial",
    label_transfer_dict=None,
    normalize_c: bool = False,
    normalize_g: bool = False,
    dtype: str = "float64",
    device: str = "cpu",
    verbose: bool = True,
):
    """Deprecated-API compat shim (parity surface: reference
    methods/deprecated_utils.py:584). Returns
    (nx, type_as, exp_matrices, spatial_coords, normalize_scales,
    normalize_means_list, common_genes) with numpy arrays — the torch/POT
    backend object is replaced by numpy itself (this shim only serves code
    written against the old API)."""
    from scipy.sparse import issparse

    from ..preprocessing.filter import filter_genes  # noqa: F401  (parity import)

    common = None
    for s in samples:
        names = set(map(str, s.var_names))
        common = names if common is None else (common & names)
    common = sorted(common)
    if genes is not None:
        common = [g for g in common if str(g) in set(map(str, genes))]

    exp_matrices = []
    spatial_coords = []
    for s in samples:
        idx = [list(map(str, s.var_names)).index(g) for g in common]
        M = s.X[:, idx]
        M = np.asarray(M.toarray() if issparse(M) else M, dtype=dtype)
        exp_matrices.append(M)
        spatial_coords.append(np.asarray(s.obsm[spatial_key], dtype=dtype))

    normalize_scales = None
    normalize_means_list = None
    if normalize_c:
        means = [c.mean(0) for c in spatial_coords]
        centered = [c - m for c, m in zip(spatial_coords, means)]
        scale = np.sqrt(sum((c**2).sum() for c in centered) / sum(len(c) for c in centered))
        spatial_coords = [c / scale for c in centered]
        normalize_scales = np.asarray([scale] * len(samples))
        normalize_means_list = means
    if normalize_g:
        exp_matrices = [m / (np.linalg.norm(m, axis=1, keepdims=True) + 1e-12) for m in exp_matrices]

    nx = np  # backend shim: numpy stands in for the POT backend object
    type_as = np.zeros(1, dtype=dtype)
    return nx, type_as, exp_matrices, spatial_coords, normalize_scales, normalize_means_list, common
