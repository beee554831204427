"""Apply saved alignment transforms to new points (counterpart of
`spateo_tpu.alignment.transform`; reference spateo/alignment/transform.py:30-275).
The Morpho field (rigid + Nyström non-rigid) is evaluated on `device`."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.anndata import AnnData
from ..core.bridge import _to_device
from .methods.math import calc_distance, con_K, euc_dist, get_P_core
from .methods.morpho import filter_common_genes, get_rep


def paste_transform(
    adata: AnnData,
    adata_ref: AnnData,
    spatial_key: str = "spatial",
    key_added: str = "align_spatial",
    mapping_key: str = "models_align",
) -> AnnData:
    """Align new coords via a stored PASTE mapping (parity: transform.py:30).
    Host numpy."""
    if mapping_key not in adata_ref.uns:
        raise KeyError(f"`{mapping_key}` not in `adata_ref.uns`.")
    tX = adata_ref.uns[mapping_key]["tX"]
    tY = adata_ref.uns[mapping_key]["tY"]
    R = adata_ref.uns[mapping_key]["R"]
    adata_coords = np.asarray(adata.obsm[spatial_key], dtype=float).copy()
    adata.obsm[key_added] = (adata_coords - tY) @ R.T + tX
    return adata


def _ba_transform_kernel(XA, ctrl_pts, Coff, R, t, optimal_R, optimal_t, init_R, init_t, beta, deformation_scale):
    XA = XA @ init_R.T + init_t
    quary_kernel = con_K(XA, ctrl_pts, beta)
    quary_velocities = (quary_kernel @ Coff) * deformation_scale
    quary_similarity = XA @ R.T + t
    quary_optimal_similarity = XA @ optimal_R.T + optimal_t
    XAHat = quary_velocities + quary_similarity
    return XAHat, quary_velocities, quary_optimal_similarity


def BA_transform(
    vecfld: dict,
    quary_points: np.ndarray,
    deformation_scale: float = 1,
    dtype: str = "float32",
    device="cuda",
):
    """Apply a saved Morpho vector field (rigid + Nyström non-rigid) to new
    points on `device` (parity: reference transform.py:61). Returns
    (XAHat, velocities, optimal rigid image) as host arrays.

    `inducing_variables` are stored after the init rigid transform, so the
    query takes `init_R/init_t` first; the SE kernel depends only on
    distances, so the velocities equal the reference's."""
    normalize_scale = np.asarray(vecfld["norm_dict"]["scale_transformed"])
    normalize_mean_ref = np.asarray(vecfld["norm_dict"]["mean_fixed"])
    normalize_mean_quary = np.asarray(vecfld["norm_dict"]["mean_transformed"])
    XA = np.asarray(quary_points, dtype=np.float32)
    if vecfld["normalize_c"]:
        XA = (XA - normalize_mean_quary) / normalize_scale

    T = lambda a: _to_device(np.asarray(a, dtype=np.float32), device)
    out = _ba_transform_kernel(
        T(XA), T(vecfld["inducing_variables"]), T(vecfld["Coff"]), T(vecfld["R"]), T(vecfld["t"]),
        T(vecfld["optimal_R"]), T(vecfld["optimal_t"]), T(vecfld["init_R"]), T(vecfld["init_t"]),
        float(np.asarray(vecfld["beta"], dtype=np.float32)), float(np.float32(deformation_scale)),
    )
    XAHat, quary_velocities, quary_optimal_similarity = (x.cpu().numpy() for x in out)
    if vecfld["normalize_c"]:
        XAHat = XAHat * normalize_scale + normalize_mean_ref
        quary_velocities = quary_velocities * normalize_scale
        quary_optimal_similarity = quary_optimal_similarity * normalize_scale + normalize_mean_ref
    return XAHat, quary_velocities, quary_optimal_similarity


def get_P_chunk(
    XnAHat: np.ndarray,
    XnB: np.ndarray,
    X_A: np.ndarray,
    X_B: np.ndarray,
    sigma2: float,
    beta2: Optional[float] = None,
    alpha: Optional[np.ndarray] = None,
    gamma: float = 0.5,
    Sigma: Optional[np.ndarray] = None,
    samples_s: Optional[float] = None,
    outlier_variance: Optional[float] = None,
    chunk_size: int = 5000,
    dissimilarity: str = "kl",
    sigma2_variance: Optional[float] = None,
    probability_type: str = "gauss",
    probability_parameter: Optional[float] = None,
    device="cuda",
) -> np.ndarray:
    """Full NA x NB assignment computed in column chunks on `device` (parity:
    reference transform.py:206-275, the same positional parameter order:
    ``beta2`` is the expression-kernel bandwidth exp(-d_gene/(2 beta2)),
    ``outlier_variance`` sharpens the spatial inlier weighting to
    exp(-d/(2 sigma2/outlier_variance))). Results do not depend on
    `chunk_size`."""
    if beta2 is not None:
        probability_parameter = float(beta2)
    if outlier_variance is not None:
        sigma2_variance = float(outlier_variance)
    if sigma2_variance is None:
        sigma2_variance = 1.0
    NB = XnB.shape[0]
    D = XnAHat.shape[1]
    NA = XnAHat.shape[0]
    alpha = np.ones(NA, np.float32) if alpha is None else np.asarray(alpha, np.float32)
    Sigma = np.zeros(NA, np.float32) if Sigma is None else np.asarray(Sigma, np.float32)
    if samples_s is None:
        samples_s = max(
            float(np.prod(XnAHat.max(0) - XnAHat.min(0))),
            float(np.prod(XnB.max(0) - XnB.min(0))),
        )
    if probability_parameter is None:
        probability_parameter = float(sigma2)
    T = lambda a: _to_device(np.asarray(a, dtype=np.float32), device)
    model_mul = T((alpha * np.exp(-Sigma / sigma2))[:, None])
    XnAHat_d = T(XnAHat)
    X_A_d = T(X_A)
    scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=XnAHat_d.device)

    chunks = []
    for start in range(0, NB, chunk_size):
        XnB_c = T(XnB[start : start + chunk_size])
        X_B_c = T(X_B[start : start + chunk_size])
        spatial_dist = euc_dist(XnAHat_d, XnB_c, squared=True)
        [exp_dist] = calc_distance(X_A_d, X_B_c, metric=dissimilarity)
        P, _, _, _ = get_P_core(
            Dim=float(D),
            spatial_dist=spatial_dist,
            exp_dist=[exp_dist],
            sigma2=scalar(sigma2),
            model_mul=model_mul,
            gamma=scalar(gamma),
            samples_s=scalar(samples_s),
            sigma2_variance=scalar(sigma2_variance),
            probability_type=[probability_type],
            probability_parameters=[scalar(probability_parameter)],
        )
        chunks.append(P)
    return torch.cat(chunks, dim=1).cpu().numpy()


def BA_transform_and_assignment(
    samples: List[AnnData],
    vecfld: dict,
    layer: str = "X",
    genes=None,
    spatial_key: str = "spatial",
    small_variance: bool = False,
    dtype: str = "float32",
    device="cuda",
    verbose: bool = False,
):
    """Transform new points and compute their assignment to the reference on
    `device` (parity: reference transform.py:119). Returns (XAHat,
    velocities, optimal rigid image, P.T)."""
    XA_raw = np.asarray(samples[0].obsm[spatial_key], dtype=np.float32)
    XB_raw = np.asarray(samples[1].obsm[spatial_key], dtype=np.float32)
    norm = vecfld["norm_dict"]
    if vecfld["normalize_c"]:
        XB = (XB_raw - np.asarray(norm["mean_fixed"])) / np.asarray(norm["scale_fixed"])
    else:
        XB = XB_raw

    XAHat, quary_velocities, quary_optimal_similarity = BA_transform(vecfld, XA_raw, dtype=dtype, device=device)
    # the transformed coordinates back in the solver's frame for P
    if vecfld["normalize_c"]:
        XAHat_n = (XAHat - np.asarray(norm["mean_fixed"])) / np.asarray(norm["scale_fixed"])
    else:
        XAHat_n = XAHat

    new_samples = [s.copy() for s in samples]
    common_genes = filter_common_genes(*[s.var.index for s in new_samples], verbose=verbose)
    if genes is not None:
        common_genes = sorted(set(common_genes) & set(genes))
    X_A = get_rep(new_samples[0], layer, "layer", common_genes)
    X_B = get_rep(new_samples[1], layer, "layer", common_genes)

    sigma2 = 0.01 if small_variance else float(np.asarray(vecfld["sigma2"]))
    dissimilarity = vecfld["dissimilarity"]
    P = get_P_chunk(
        XnAHat=XAHat_n,
        XnB=XB,
        X_A=X_A,
        X_B=X_B,
        sigma2=sigma2,
        gamma=float(np.asarray(vecfld["gamma"])),
        sigma2_variance=float(np.asarray(vecfld.get("sigma2_variance", 1.0))),
        dissimilarity=dissimilarity[0] if isinstance(dissimilarity, list) else dissimilarity,
        device=device,
    )
    return XAHat, quary_velocities, quary_optimal_similarity, P.T
