"""Morphometric vector field via SparseVFC (counterpart of
`spateo_tpu.tdr.morphometrics.morphofield.sparsevfc`; reference
spateo/tdr/morphometrics/morphofield/sparsevfc.py:18,103,241). The field is
learned by the port's `ops.vfc.SparseVFC` on `device`; `cell_directions` maps
cells across stages with PASTE's FGW on `device`."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import pandas as pd

from ....alignment.methods.paste import paste_pairwise_align
from ....alignment.utils import get_optimal_mapping_relationship
from ....core.anndata import AnnData
from ....logging import logger_manager as lm
from ....ops.vfc import SparseVFC, SparseVFC_batch
from ...interpolations import get_X_Y_grid


def cell_directions(
    adataA: AnnData,
    adataB: AnnData,
    layer: str = "X",
    genes: Optional[Union[list, np.ndarray]] = None,
    spatial_key: str = "align_spatial",
    key_added: str = "mapping",
    alpha: float = 0.001,
    numItermax: int = 200,
    numItermaxEmd: int = 100000,
    dtype: str = "float32",
    device="cuda",
    keep_all: bool = False,
    inplace: bool = True,
    **kwargs,
) -> Tuple[Optional[AnnData], np.ndarray]:
    """Optimal mapping + developmental direction between two stages (parity:
    sparsevfc.py:18): PASTE's FGW plan on `device`, then each A cell's
    highest-probability partner in B (host). Adds ``X_{key_added}`` (the
    partner's coordinates) and ``V_{key_added}`` (the displacement) to
    ``adataA.obsm``."""
    pi, _ = paste_pairwise_align(
        sampleA=adataA.copy(),
        sampleB=adataB.copy(),
        spatial_key=spatial_key,
        layer=layer,
        genes=genes,
        alpha=alpha,
        numItermax=numItermax,
        device=device,
        verbose=False,
        **kwargs,
    )
    max_index, pi_value, _, _ = get_optimal_mapping_relationship(
        X=np.asarray(adataA.obsm[spatial_key]).copy(),
        Y=np.asarray(adataB.obsm[spatial_key]).copy(),
        pi=pi,
        keep_all=keep_all,
    )
    mapping_data = pd.DataFrame(
        {
            "index_x": max_index[:, 0].astype(np.int32),
            "index_y": max_index[:, 1].astype(np.int32),
            "pi_value": pi_value[:, 0].astype(np.float64),
        }
    )
    mapping_data.sort_values(by=["index_x", "pi_value"], ascending=[True, False], inplace=True)
    mapping_data.drop_duplicates(subset=["index_x"], keep="first", inplace=True)
    adataA.obsm[f"X_{key_added}"] = np.asarray(adataB.obsm[spatial_key])[mapping_data["index_y"].values]
    adataA.obsm[f"V_{key_added}"] = adataA.obsm[f"X_{key_added}"] - np.asarray(adataA.obsm[spatial_key])
    return (None if inplace else adataA), pi


def _morphofield_sparsevfc(
    X: np.ndarray,
    V: np.ndarray,
    NX: Optional[np.ndarray] = None,
    grid_num: Optional[List[int]] = None,
    M: int = 100,
    lambda_: float = 0.02,
    lstsq_method: str = "scipy",
    min_vel_corr: float = 0.8,
    restart_num: int = 10,
    restart_seed: Union[List[int], Tuple[int], np.ndarray] = (0, 100, 200, 300, 400),
    device="cuda",
    **kwargs,
) -> dict:
    """SparseVFC fit with restarts gated by the cosine correlation of the
    learned and the given velocities (parity: sparsevfc.py:103, restart
    logic :178-232). Each trial reads one scalar, `_device["res"]`."""
    if NX is not None:
        predict_X = np.asarray(NX)
    else:
        if grid_num is None:
            grid_num = [50, 50, 50]
            lm.main_warning("grid_num and NX are both None, using `grid_num = [50,50,50]`.")
        _, _, Grid, _ = get_X_Y_grid(X=X.copy(), Y=V.copy(), grid_num=grid_num)
        predict_X = Grid

    if restart_num > 0:
        restart_seed = np.asarray(restart_seed)
        if len(restart_seed) != restart_num:
            restart_seed = np.arange(restart_num) * 100
        cur_vf_list, res_list = [], []
        for counter in range(restart_num):
            cur = SparseVFC(
                X=X, Y=V, Grid=predict_X, M=M, lstsq_method=lstsq_method, lambda_=lambda_,
                seed=int(restart_seed[counter]), device=device, **kwargs,
            )
            res = float(cur["_device"]["res"])
            cur_vf_list.append(cur)
            res_list.append(res)
            if res >= min_vel_corr:
                vf_dict = cur
                break
            lm.main_info(f"Current cosine correlation ({round(res, 5)}) < {min_vel_corr}; retrial {counter + 1}.")
        else:
            lm.main_warning(f"Cosine correlation below {min_vel_corr} after {restart_num} trials; keeping the best.")
            vf_dict = cur_vf_list[int(np.argmax(res_list))]
    else:
        vf_dict = SparseVFC(X=X, Y=V, Grid=predict_X, M=M, lstsq_method=lstsq_method, lambda_=lambda_,
                            device=device, **kwargs)

    vf_dict["method"] = "sparsevfc"
    return vf_dict


def morphofield_sparsevfc(
    adata: AnnData,
    spatial_key: str = "align_spatial",
    V_key: str = "V_mapping",
    key_added: str = "VecFld_morpho",
    NX: Optional[np.ndarray] = None,
    grid_num: Optional[List[int]] = None,
    M: int = 100,
    lambda_: float = 0.02,
    lstsq_method: str = "scipy",
    min_vel_corr: float = 0.8,
    restart_num: int = 10,
    restart_seed: Union[List[int], Tuple[int], np.ndarray] = (0, 100, 200, 300, 400),
    inplace: bool = True,
    device="cuda",
    **kwargs,
) -> Optional[AnnData]:
    """AnnData-level SparseVFC morphofield (parity: sparsevfc.py:241)."""
    adata = adata if inplace else adata.copy()
    vf_dict = _morphofield_sparsevfc(
        X=np.asarray(adata.obsm[spatial_key], dtype=float),
        V=np.asarray(adata.obsm[V_key], dtype=float),
        NX=NX,
        grid_num=grid_num,
        M=M,
        lambda_=lambda_,
        lstsq_method=lstsq_method,
        min_vel_corr=min_vel_corr,
        restart_num=restart_num,
        restart_seed=restart_seed,
        device=device,
        **kwargs,
    )
    vf_dict.pop("_device", None)  # device handles must not be stored in .uns
    adata.uns[key_added] = vf_dict
    adata.obsm["velocity_" + spatial_key.split("_")[-1] if "_" in spatial_key else "velocity"] = vf_dict["V"]
    return None if inplace else adata


def morphofield_sparsevfc_batch(
    adatas: list,
    spatial_key: str = "align_spatial",
    V_key: str = "V_mapping",
    key_added: str = "VecFld_morpho",
    M: int = 100,
    lambda_: float = 3.0,
    MaxIter: int = 500,
    ecr: float = 1e-5,
    seed: int = 0,
    morphometrics: bool = True,
    div_key: str = "divergence",
    curl_key: str = "curl",
    device="cuda",
    **kwargs,
) -> None:
    """Fit one morphofield per slice of an aligned stack in one batched fit
    (`ops.vfc.SparseVFC_batch`; parity:
    `spateo_tpu.tdr.morphometrics.morphofield.sparsevfc.morphofield_sparsevfc_batch`).

    Slices are subsampled to the smallest common cell count so the batch
    shares one shape. Writes each slice's vecfld dict to ``.uns[key_added]``
    and, with ``morphometrics=True``, per-cell divergence/curl to
    ``.obs[div_key]`` / ``.obs|.obsm[curl_key]`` (NaN where not sampled).
    """
    Xs = [np.asarray(a.obsm[spatial_key], dtype=np.float32) for a in adatas]
    Vs = [np.asarray(a.obsm[V_key], dtype=np.float32) for a in adatas]
    N = min(len(x) for x in Xs)
    rng = np.random.default_rng(seed)
    sel = [rng.choice(len(x), N, replace=False) if len(x) > N else np.arange(N) for x in Xs]
    fields = SparseVFC_batch(
        np.stack([x[s] for x, s in zip(Xs, sel)]),
        np.stack([v[s] for v, s in zip(Vs, sel)]),
        M=M, lambda_=lambda_, MaxIter=MaxIter, ecr=ecr, seed=seed,
        morphometrics=morphometrics, device=device, **kwargs,
    )
    for a, f, s in zip(adatas, fields, sel):
        vf = {k: f[k] for k in ("X", "Y", "X_ctrl", "ctrl_idx", "beta", "V", "C", "P",
                                "VFCIndex", "sigma2", "iteration", "tecr_traj", "E_traj")}
        vf["subset_idx"] = s
        a.uns[key_added] = vf
        if morphometrics:
            div = np.full(a.n_obs, np.nan, np.float32)
            div[s] = f["div"]
            a.obs[div_key] = div
            curl = np.asarray(f["curl"])
            if curl.ndim == 1:
                c = np.full(a.n_obs, np.nan, np.float32)
                c[s] = curl
                a.obs[curl_key] = c
            else:
                c = np.full((a.n_obs, curl.shape[1]), np.nan, np.float32)
                c[s] = curl
                a.obsm[curl_key] = c
                a.obs[curl_key] = np.linalg.norm(c, axis=1)
