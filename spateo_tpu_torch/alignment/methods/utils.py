"""Reference-named module alias: the alignment math kernels live in
`methods/math.py` (the reference keeps them in methods/utils.py). Validation
helpers the reference exposes are provided here directly. A copy of
`spateo_tpu.alignment.methods.utils` (host numpy), re-exporting the port's
`math` and `morpho` names."""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from ...logging import logger_manager as lm
from ..utils import generate_label_transfer_dict  # noqa: F401
from .math import (  # noqa: F401
    calc_distance,
    calc_probability,
    con_K,
    euc_dist,
    factorize_distance,
    get_P_core,
    init_guess_sigma2,
    inlier_from_NN,
    kl_dist,
    normalize_coords,
    procrustes_rotation,
    voxel_data,
)


def check_backend(device: str = "cpu", dtype: str = "float32", verbose: bool = True):
    """Backend resolution (parity surface: reference methods/utils.py:35
    check_backend): returns (numpy-module, zero-array of the requested
    dtype) for code written against the old API."""
    return np, np.zeros(1, dtype=dtype)


def check_spatial_coords(sample, spatial_key: str = "spatial") -> np.ndarray:
    """Validate + fetch spatial coordinates (parity: methods/utils.py
    check_spatial_coords)."""
    if spatial_key not in sample.obsm:
        raise KeyError(f"`{spatial_key}` not found in .obsm")
    coords = np.asarray(sample.obsm[spatial_key], dtype=float)
    if coords.ndim != 2 or coords.shape[1] < 2:
        raise ValueError(f"spatial coordinates must be [N, D>=2]; got {coords.shape}")
    return coords


def check_exp(sample, layer: str = "X") -> np.ndarray:
    """Validate + fetch an expression matrix (parity: methods/utils.py
    check_exp)."""
    from scipy.sparse import issparse

    X = sample.X if layer == "X" else sample.layers[layer]
    return np.asarray(X.toarray() if issparse(X) else X, dtype=float)


def check_obs(rep_layer: List[str], rep_field: List[str]) -> Optional[str]:
    """Return the obs key among the representations, if any (parity:
    methods/utils.py check_obs — at most one 'obs' field is allowed)."""
    obs_keys = [r for r, f in zip(rep_layer, rep_field) if f == "obs"]
    if len(obs_keys) > 1:
        raise ValueError("only one 'obs' representation (label layer) is supported")
    return obs_keys[0] if obs_keys else None


def check_rep_layer(samples, rep_layer: Union[str, List[str]] = "X", rep_field: Union[str, List[str]] = "layer") -> bool:
    """Verify every sample carries each requested representation (parity:
    methods/utils.py check_rep_layer)."""
    reps = [rep_layer] if isinstance(rep_layer, str) else list(rep_layer)
    fields = [rep_field] if isinstance(rep_field, str) else list(rep_field)
    for s in samples:
        for rep, field in zip(reps, fields):
            if field == "layer":
                if rep != "X" and rep not in s.layers:
                    raise ValueError(f"layer `{rep}` missing from a sample")
            elif field == "obsm":
                if rep not in s.obsm:
                    raise ValueError(f"obsm `{rep}` missing from a sample")
            elif field == "obs":
                if rep not in s.obs.columns:
                    raise ValueError(f"obs `{rep}` missing from a sample")
            else:
                raise ValueError(f"unknown rep_field `{field}`")
    return True


def check_label_transfer_dict(catA: List[str], catB: List[str], label_transfer_dict: dict) -> None:
    """Validate a label-transfer dictionary covers all category pairs
    (parity: methods/utils.py check_label_transfer_dict)."""
    for ca in catA:
        if ca not in label_transfer_dict:
            raise ValueError(f"label_transfer_dict missing source category `{ca}`")
        for cb in catB:
            if cb not in label_transfer_dict[ca]:
                raise ValueError(f"label_transfer_dict missing pair `{ca}` -> `{cb}`")


def check_label_transfer(nx, type_as, sampleA, sampleB, obs_key: str, label_transfer_dict: Optional[dict] = None) -> np.ndarray:
    """Build the [catA, catB] transfer matrix (parity: methods/utils.py:264)."""
    import pandas as pd

    catA = sorted(map(str, pd.unique(np.asarray(sampleA.obs[obs_key]).astype(str))))
    catB = sorted(map(str, pd.unique(np.asarray(sampleB.obs[obs_key]).astype(str))))
    if label_transfer_dict is None:
        label_transfer_dict = generate_label_transfer_dict(catA, catB)
    else:
        check_label_transfer_dict(catA, catB, label_transfer_dict)
    lt = np.zeros((len(catA), len(catB)), np.float32)
    for j, ca in enumerate(catA):
        for k, cb in enumerate(catB):
            lt[j, k] = label_transfer_dict[ca][cb]
    return lt


def con_K_graph(graph, inducing_idx: np.ndarray, beta: float = 0.01) -> np.ndarray:
    """Graph-geodesic kernel (parity: methods/utils.py:1190 con_K_graph;
    `graph` is a scipy.sparse adjacency with edge weights)."""
    from scipy.sparse.csgraph import dijkstra

    D = dijkstra(graph, directed=False, indices=np.asarray(inducing_idx, int))
    D = np.where(np.isfinite(D), D, 1e5).T
    return np.exp(-beta * D**2)


def construct_knn_graph(coords: np.ndarray, knn: int = 10):
    """KNN graph with euclidean edge weights (parity: methods/utils.py
    construct_knn_graph; networkx replaced by a scipy.sparse adjacency)."""
    from scipy.sparse import csr_matrix
    from scipy.spatial import cKDTree

    coords = np.asarray(coords, float)
    n = len(coords)
    k = min(knn + 1, n)
    d, nbr = cKDTree(coords).query(coords, k=k)
    rows = np.repeat(np.arange(n), k - 1)
    return csr_matrix((d[:, 1:].ravel(), (rows, nbr[:, 1:].ravel())), shape=(n, n))


from .morpho import filter_common_genes, get_rep  # noqa: E402,F401


def normalize_exps(
    nx=None,
    exp_layers=None,
    rep_field="layer",
    verbose: bool = True,
):
    """Joint RMS-scale normalization of expression matrices across samples
    (parity: methods/utils.py:588-640 — per layer slot, scale = mean over
    samples of sqrt(sum(E*E)/n_rows); applied only to 'layer' rep fields).
    ``nx`` is accepted for signature parity (the reference's backend shim);
    computation is NumPy. Also accepts the short form
    ``normalize_exps([E_A, E_B])`` — a flat list is treated as one layer
    slot per sample."""
    if exp_layers is None and nx is not None and not hasattr(nx, "einsum"):
        # called positionally as normalize_exps(exp_layers)
        exp_layers, nx = nx, None
    flat = exp_layers and not isinstance(exp_layers[0], (list, tuple))
    if flat:
        exp_layers = [[np.asarray(e, float)] for e in exp_layers]
    else:
        exp_layers = [[np.asarray(e, float) for e in sample] for sample in exp_layers]
    if isinstance(rep_field, str):
        rep_field = [rep_field] * len(exp_layers[0])
    for l, rep_f in enumerate(rep_field):
        if rep_f != "layer":
            continue
        scale = 0.0
        for sample in exp_layers:
            E = sample[l]
            scale += np.sqrt(np.einsum("ij,ij->", E, E) / E.shape[0])
        scale /= len(exp_layers)
        for sample in exp_layers:
            sample[l] = sample[l] / (scale + 1e-300)
        if verbose:
            lm.main_info(f"Gene expression normalization params: scale {scale}.")
    return [s[0] for s in exp_layers] if flat else exp_layers


def sparse_tensor_to_scipy(tensor):
    """Sparse-tensor -> scipy conversion (parity: methods/utils.py
    sparse_tensor_to_scipy): a torch tensor (dense or sparse, on any device)
    or an array becomes a CSR matrix."""
    import torch
    from scipy.sparse import csr_matrix

    if isinstance(tensor, torch.Tensor):
        tensor = (tensor.to_dense() if tensor.is_sparse else tensor).detach().cpu().numpy()
    return csr_matrix(np.asarray(tensor))


def torch_like_split(arr, size: int, dim: int = 0) -> List[np.ndarray]:
    """torch.split semantics on numpy arrays (parity: methods/utils.py
    torch_like_split)."""
    arr = np.asarray(arr)
    n = arr.shape[dim]
    return [np.take(arr, np.arange(s, min(s + size, n)), axis=dim) for s in range(0, n, size)]


# parity: reference alignment/methods/utils.py:21
intersect_lsts = lambda *lsts: list(set(lsts[0]).intersection(*lsts[1:]))  # noqa: E731
