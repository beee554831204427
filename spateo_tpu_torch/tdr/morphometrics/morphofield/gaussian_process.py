"""Gaussian-process morphofield from the Morpho alignment output (counterpart
of `spateo_tpu.tdr.morphometrics.morphofield.gaussian_process`; reference
spateo/tdr/morphometrics/morphofield/gaussian_process.py:16,39,173).

It reads the `vecfld` dict the port's `Morpho_pairwise` stores under
`.uns['VecFld_morpho']` (R/t/Coff/inducing_variables/beta/norm_dict): the
alignment deformation is the developmental vector field. Host numpy in
float64, as in the JAX package."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from scipy.spatial.distance import cdist

from ....core.anndata import AnnData
from ...interpolations import get_X_Y_grid


def _con_K(x: np.ndarray, y: np.ndarray, beta: float = 0.1, method: str = "cdist", return_d: bool = False):
    """SE kernel (parity: gaussian_process.py:16)."""
    if len(x.shape) == 1:
        x = x[None, :]
    K = cdist(x, y, "sqeuclidean")
    if len(K) == 1:
        K = K.flatten()
    Kexp = np.exp(-beta * K)
    if return_d:
        D = x[:, :, None] - np.transpose(y[:, :, None], [2, 1, 0])
        return Kexp, D
    return Kexp


def _con_K_geodist(
    x: np.ndarray,
    kernel_dict: dict,
    beta: float = 0.1,
    return_d: bool = False,
):
    """Geodesic kernel at new query points (reference
    gaussian_process.py:39 `_con_K_geodist`).

    Each query snaps to its nearest source point; its geodesic distance to
    inducing point k is the stored graph distance of that source point plus
    the difference between the query's and the source point's euclidean
    distance to the first node on the path toward k. Queries landing in a
    disconnected component get a large distance (kernel ~ 0)."""
    if len(x.shape) == 1:
        x = x[None, :]
    d = cdist(x, kernel_dict["X"], "euclidean")
    nearest_idx = np.argmin(d, axis=1)
    nearest_inducing_nodes = np.array(kernel_dict["first_node_idx"])[nearest_idx]  # [Q, K]
    K_mask = nearest_inducing_nodes < 0
    nearest_inducing_nodes[nearest_inducing_nodes < 0] = 0
    gather = kernel_dict["X"][nearest_inducing_nodes]  # [Q, K, D]
    to_first_D = x[:, None, :] - gather  # [Q, K, D]
    to_first = np.sqrt(np.sum(to_first_D**2, axis=2))
    origin_to_first = np.sqrt(np.sum((kernel_dict["X"][nearest_idx][:, None, :] - gather) ** 2, axis=2))
    D = np.asarray(kernel_dict["kernel_graph_distance"])[nearest_idx] + to_first - origin_to_first
    D[K_mask] = 10000
    K = np.squeeze(np.exp(-beta * D**2))
    if return_d:
        to_first_D[K_mask, :] = 0
        Dd = D[:, :, None] * to_first_D / np.maximum(to_first[:, :, None], 1e-12)
        return K, Dd.transpose([0, 2, 1])
    return K


def _gp_velocity(X: np.ndarray, vf_dict: dict, nonrigid_only: bool = False) -> np.ndarray:
    """Velocity of points under the saved Morpho field (parity:
    gaussian_process.py:107-127; the geodesic branch goes through
    `_con_K_geodist` with the kernel_dict Morpho stores for geodist kernels)."""
    norm = vf_dict["norm_dict"]
    norm_x = (X - np.asarray(norm["mean_transformed"])) / np.asarray(norm["scale_transformed"])
    if vf_dict["kernel_type"] == "euc":
        quary_kernel = _con_K(norm_x, np.asarray(vf_dict["inducing_variables"]), vf_dict["beta"])
    elif vf_dict["kernel_type"] == "geodist":
        if "kernel_dict" not in vf_dict:
            raise KeyError("geodist vecfld is missing its kernel_dict — re-run morpho_align with kernel_type='geodist'")
        quary_kernel = _con_K_geodist(norm_x, vf_dict["kernel_dict"], vf_dict["beta"])
    else:
        raise ValueError(f"unsupported kernel_type {vf_dict['kernel_type']} (use 'euc' or 'geodist')")
    quary_velocities = np.dot(quary_kernel, np.asarray(vf_dict["Coff"]))
    if nonrigid_only:
        _velocities = (
            quary_velocities * np.asarray(norm["scale_fixed"])
            + (np.asarray(norm["scale_fixed"]) - np.asarray(norm["scale_transformed"])) * norm_x
        )
    else:
        quary_rigid = np.dot(norm_x, np.asarray(vf_dict["R"]).T) + np.asarray(vf_dict["t"])
        quary_norm_x = quary_velocities + quary_rigid
        quary_x = quary_norm_x * np.asarray(norm["scale_fixed"]) + np.asarray(norm["mean_fixed"])
        _velocities = quary_x - X
    return _velocities / 10000


def morphofield_gp(
    adata: AnnData,
    spatial_key: str = "align_spatial",
    vf_key: str = "VecFld_morpho",
    NX: Optional[np.ndarray] = None,
    grid_num: Optional[List[int]] = None,
    nonrigid_only: bool = False,
    inplace: bool = True,
) -> Optional[AnnData]:
    """Developmental vector field from the saved alignment field (parity:
    gaussian_process.py:173)."""
    adata = adata if inplace else adata.copy()
    if vf_key not in adata.uns:
        raise KeyError(
            f"`{vf_key}` not in `.uns` — run `stt.align.morpho_align` with vecfld_key_added='{vf_key}' first."
        )
    vf_dict = dict(adata.uns[vf_key])
    X = np.asarray(adata.obsm[spatial_key], dtype=float)
    V = _gp_velocity(X, vf_dict, nonrigid_only=nonrigid_only)

    if NX is None:
        if grid_num is None:
            grid_num = [50, 50, 50]
        _, _, Grid, _ = get_X_Y_grid(X=X.copy(), Y=V.copy(), grid_num=grid_num)
        NX = Grid
    grid_V = _gp_velocity(np.asarray(NX, dtype=float), vf_dict, nonrigid_only=nonrigid_only)

    vf_dict.update({"X": X, "V": V, "grid": np.asarray(NX), "grid_V": grid_V, "method": "gaussian_process",
                    "nonrigid_only": nonrigid_only})
    adata.uns[vf_key] = vf_dict
    adata.obsm["V_" + spatial_key] = V
    return None if inplace else adata
