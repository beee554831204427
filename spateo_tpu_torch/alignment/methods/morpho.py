"""Morpho pairwise alignment: Bayesian non-rigid + rigid EM on one device.

Counterpart of `spateo_tpu.alignment.methods.morpho` (reference
spateo/alignment/methods/morpho_class.py `Morpho_pairwise`: coarse NN init
:898, variational init :683, EM loop :242-313 with E-step :1071, gamma/alpha
:1202/:1226, non-rigid Nystrom M-step :1254, rigid M-step :1300, sigma2 :1410,
final Procrustes :1437, output :1471).

- The EM is a Python loop over device tensors that reads nothing back to the
  host: linear solves use `solve_ex` (no error check), every scalar stays a
  0-d tensor, and the gates the JAX package wrote as `jnp.where` on values
  known from the iteration number alone are Python branches.
- The flash E-step (`math.estep_reduced`) runs the hand-written CUDA kernels
  on a CUDA device (`ops/estep_cuda.py`), whatever the problem size.
- Host draws come from `np.random.default_rng(seed)` in the JAX package's
  order (inducing points, coarse-init samples, probability-parameter
  samples, minibatch permutation), so both packages use the same inducing
  points, samples and minibatch schedule from the same seed.
"""

from __future__ import annotations

import time
from typing import List, Optional, Union

import numpy as np
import torch
from scipy import sparse as sp

from ...core.anndata import AnnData
from ...core.bridge import _to_device
from ...errors import AlignmentError
from ...logging import logger_manager as lm
from .math import (
    as_tensor,
    calc_distance,
    con_K,
    estep_reduced,
    euc_dist,
    factorize_distance,
    get_P_core,
    init_guess_sigma2_dev,
    min_dist_order_stat,
    morton_code,
    normalize_coords,
    pad_rows_bucket,
    procrustes_rotation,
    smallest_k,
    voxel_data,
    _inlier_from_NN_kernel,
)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def get_rep(sample: AnnData, rep: str = "X", rep_field: str = "layer", genes=None) -> np.ndarray:
    """Extract a representation (expression layer / obsm embedding / obs label)
    (parity: reference methods/utils.py:441)."""
    if rep_field == "layer":
        s = sample[:, np.asarray(genes)] if genes is not None else sample
        X = s.X if rep == "X" else s.layers[rep]
        X = X.toarray() if sp.issparse(X) else np.asarray(X)
        return np.asarray(X, dtype=np.float32)
    if rep_field == "obsm":
        return np.asarray(sample.obsm[rep], dtype=np.float32)
    if rep_field == "obs":
        codes = np.asarray(sample.obs[rep].astype("category").cat.codes)
        return codes.astype(np.int32)
    raise AlignmentError(f"Unsupported rep_field {rep_field}")


def filter_common_genes(*genes_lists, verbose: bool = True) -> List[str]:
    common = set(genes_lists[0])
    for g in genes_lists[1:]:
        common &= set(g)
    common_genes = sorted(common)
    if len(common_genes) == 0:
        raise AlignmentError("No common genes between samples.")
    return common_genes


# ---------------------------------------------------------------------------
# Coarse-init matching + robust rigid fit
# ---------------------------------------------------------------------------
def _coarse_match_fit(X_A_p, X_B_p, cA_p, cB_p, n1: int, n2: int, *, top_k: int, metric: str, allow_flip: bool):
    """The coarse-init chain on the device: expression distance -> mutual
    top-K matching -> NN pair gather -> 100-iteration inlier EM (twice under
    the flip hypothesis) -> posterior threshold. Nothing is read back.

    Rows/cols >= n1/n2 are padding, masked out of the top-K by the largest
    float; sub-threshold NN rows are kept with weight 0. Ties in the top-K
    go to the lower index, as `jax.lax.top_k` breaks them."""
    dev = X_A_p.device
    n1p, n2p = X_A_p.shape[0], X_B_p.shape[0]
    [Dmat] = calc_distance(X_A_p, X_B_p, metric=metric)
    big = torch.finfo(Dmat.dtype).max
    valid = (torch.arange(n1p, device=dev)[:, None] < n1) & (torch.arange(n2p, device=dev)[None, :] < n2)
    Dm = torch.where(valid, Dmat, big)
    row_vals, row_idx = smallest_k(Dm, top_k)  # per A row: K nearest B cols
    col_vals, col_idx = smallest_k(Dm.T, top_k)  # per B col: K nearest A rows
    # NN pairs (B index, A index) in the reference's NN1/NN2 order
    b_idx = torch.cat([torch.arange(n2p, device=dev).repeat_interleave(top_k), row_idx.ravel()])
    a_idx = torch.cat([col_idx.ravel(), torch.arange(n1p, device=dev).repeat_interleave(top_k)])
    dist = torch.cat([col_vals.ravel(), row_vals.ravel()])
    mask = torch.cat(
        [
            (torch.arange(n2p, device=dev) < n2).repeat_interleave(top_k),
            (torch.arange(n1p, device=dev) < n1).repeat_interleave(top_k),
        ]
    ).to(torch.float32)[:, None]
    dist = torch.where(mask > 0, dist[:, None], 0.0)
    train_x = cA_p[a_idx]
    train_y = cB_p[b_idx]
    n_valid = float((n1 + n2) * top_k)
    P, R, t, _, sigma2, gamma = _inlier_from_NN_kernel(train_x, train_y, dist, mask, n_valid)
    flipped = torch.zeros((), dtype=torch.bool, device=dev)
    if allow_flip:
        Dd = train_x.shape[1]
        R_flip = torch.eye(Dd, dtype=train_x.dtype, device=dev)
        R_flip[-1, -1] = -1.0
        P2, R2, t2, _, _, gamma_2 = _inlier_from_NN_kernel(train_x @ R_flip, train_y, dist, mask, n_valid)
        better = gamma_2 > gamma
        P = torch.where(better, P2, P)
        R = torch.where(better, R2 @ R_flip, R)
        t = torch.where(better, t2, t)
        flipped = better
    # reference threshold: min(21st-largest posterior, 0.5); keep all rows,
    # zeroing the sub-threshold ones
    k_thr = min(20, train_x.shape[0] - 1)
    thr = torch.clamp_max(torch.topk(P[:, 0], k_thr + 1).values[-1], 0.5)
    inlier_P = torch.where(P > thr, P, 0.0)
    return train_x, train_y, inlier_P, R, t, flipped


# ---------------------------------------------------------------------------
# The EM core
# ---------------------------------------------------------------------------
def _rebuild_P(
    XAHat_n, coordsB, bidx, mm, sigma2, gamma, samples_s, s2v, a_rows, b_cols, A_feats, B_feats, pparams,
    *, Dim: float, probability_type: tuple,
):
    """The final-batch assignment matrix [NA, B], rebuilt from the converged
    parameters (the EM never keeps it)."""
    coordsB_batch = coordsB[bidx]
    exp_dist_batch = [
        a[:, None] + b[bidx][None, :] + A @ Bf[bidx].T for a, b, A, Bf in zip(a_rows, b_cols, A_feats, B_feats)
    ]
    spatial_dist = euc_dist(XAHat_n, coordsB_batch, squared=True)
    P, _, _, _ = get_P_core(
        Dim=Dim,
        spatial_dist=spatial_dist,
        exp_dist=exp_dist_batch,
        sigma2=sigma2,
        model_mul=mm,
        gamma=gamma,
        samples_s=samples_s,
        sigma2_variance=s2v,
        probability_type=list(probability_type),
        probability_parameters=list(pparams),
    )
    return P


def _estep_chunks(NA: int, batch_size: int, hbm_fraction: float = 0.25, device="cpu") -> int:
    """Number of batch-axis (column) chunks for the plain flash E-step: ~4
    [NA, B/chunks] f32 temporaries live per chunk, budgeted against a
    fraction of the card's memory, or of 16 GB on the CPU, as the JAX
    package falls back to, so that both packages pick the same path there.
    One chunk selects the dense single pass. The CUDA kernels ignore it.

    The card's total comes from `torch.cuda.get_device_properties`, the
    number `torch.cuda.mem_get_info` reports as total: that call queries the
    CUDA runtime and took 92 ms of a 20k-cell pair under the profiler (H100)."""
    device = torch.device(device)
    mem = 16e9
    if device.type == "cuda":
        mem = float(torch.cuda.get_device_properties(device).total_memory)
    budget = hbm_fraction * mem
    return max(1, int(np.ceil(NA * batch_size * 4 * 4 / budget)))


def _morpho_em(
    coordsA: torch.Tensor,  # [NA, D] (after coarse init transform)
    coordsB: torch.Tensor,  # [NB, D]
    exp_a_rows,  # per layer: [NA] row terms
    exp_b_cols,  # per layer: [NB] col terms
    exp_A_feats,  # per layer: [NA, G'_l]
    exp_B_feats,  # per layer: [NB, G'_l]
    U: torch.Tensor,  # [NA, K]
    GammaSparse: torch.Tensor,  # [K, K]
    batch_perm: torch.Tensor,  # [NB] permutation, walked cyclically
    morton_rank_B: torch.Tensor,  # [NB] Morton rank of each fixed-slice cell
    inlier_A: torch.Tensor,  # [Ni, D]
    inlier_B: torch.Tensor,  # [Ni, D]
    inlier_P: torch.Tensor,  # [Ni, 1]
    X_AI: torch.Tensor,  # [NI, D] guidance points on the moving slice
    X_BI: torch.Tensor,  # [NI, D] guidance targets on the fixed slice
    U_I: torch.Tensor,  # [NI, K] kernel of guidance points vs inducing points
    probability_parameters: torch.Tensor,  # [L]
    sigma2_init,
    samples_s,
    *,
    batch_size: int,
    max_iter: int = 200,
    n_traces: int = 0,
    nonrigid_start_iter: int = 80,
    probability_type: tuple = ("gauss",),
    update_R: bool = True,
    nn_init: bool = True,
    guidance_effect: str = "none",  # 'none' | 'rigid' | 'nonrigid' | 'both'
    guidance_weight: float = 1.0,
    estep_chunks: int = 8,
    gamma_a: float = 1.0,
    gamma_b: float = 1.0,
    kappa: float = 1.0,
    lambdaVF: float = 1e2,
    partial_robust_level: float = 10.0,
    nn_init_weight: float = 1.0,
    SVI_decay: float = 10.0,
    svi_mode: bool = True,
    sparse_top_k: int = 0,
    use_kernel_estep: bool = True,
    shard=None,
):
    """The Morpho EM, `max_iter` iterations on the inputs' device. Returns
    (state dict, optimal_R, optimal_t, optimal_RnA) as the JAX package's
    `_morpho_em` does; the state is taken after the last iteration.

    With `shard` (`parallel._collectives.RowShard` over the moving slice's
    NA rows), coordsA, the exp_a_rows and exp_A_feats and U hold this rank's
    rows: the E-step sweeps them (`estep_reduced(shard=)`), and every sum
    over NA of the M-step is a partial sum added over the ranks in rank
    order (three collectives an iteration besides the E-step's), so the
    small solves (the inducing-point system, the rotation, sigma2) are the
    same on every rank. The row-aligned state comes back whole."""
    NA, D = coordsA.shape
    NA_total = NA if shard is None else shard.n
    psum = shard.sum if shard is not None else (lambda *t: t)
    K = U.shape[1]
    B = batch_size
    NBp = batch_perm.shape[0]
    dev = coordsA.device
    f32 = dict(dtype=torch.float32, device=dev)
    Dim = float(D)

    # SVI minibatch schedule, all iterations at once: one permutation walked
    # cyclically, each drawn index SET ordered by Morton rank (the same set,
    # so the same statistics; the column tiles become spatial neighbourhoods
    # for the E-step kernels' tile skipping)
    pos = torch.arange(max_iter, device=dev)[:, None] * B + torch.arange(B, device=dev)[None, :]
    drawn = batch_perm.long()[pos % NBp]
    schedule = torch.gather(drawn, 1, torch.argsort(morton_rank_B.long()[drawn], dim=1))

    sigma2_variance_end = partial_robust_level
    sigma2_variance_decrease = (sigma2_variance_end / 1.0) ** (1.0 / 100.0)
    inlier_sum = torch.sum(inlier_P)
    digamma_B = torch.special.digamma(torch.full((), gamma_a + gamma_b + B, **f32))
    eye_K = torch.eye(K, **f32)
    NI = X_BI.shape[0]
    rigid_guidance = guidance_effect in ("rigid", "both")
    nonrigid_guidance = guidance_effect in ("nonrigid", "both")

    s = dict(
        gamma=torch.full((), 0.5, **f32),
        alpha=torch.ones((NA,), **f32),
        sigma2=torch.as_tensor(sigma2_init, **f32).reshape(()),
        sigma2_variance=torch.full((), 1.0, **f32),
        VnA=torch.zeros((NA, D), **f32),
        RnA=coordsA,
        XAHat=coordsA,
        Coff=torch.zeros((K, D), **f32),
        SigmaDiag=torch.zeros((NA,), **f32),
        # algorithm trace (reference morpho_class.py:1043 `_save_iter`), slot
        # it * n_traces // max_iter
        traces=torch.zeros((max(n_traces, 1), NA, D), **f32),
        sigma2_traces=torch.zeros((max(n_traces, 1),), **f32),
        R=torch.eye(D, **f32),
        t=torch.zeros((D,), **f32),
        SigmaInv=torch.zeros((K, K), **f32),
        PXB_term=torch.zeros((NA, D), **f32),
        Sp=torch.zeros((), **f32),
        Sp_spatial=torch.zeros((), **f32),
        Sp_sigma2=torch.zeros((), **f32),
        nonrigid_flag=False,
        V_AI=torch.zeros_like(X_AI),
        R_AI=X_AI,
        M1=torch.zeros((D, D), **f32),
        Sp_raw=torch.zeros((), **f32),
        K_NA=torch.zeros((NA,), **f32),
        K_NB=torch.zeros((B,), **f32),
        batch_idx=schedule[0],
    )

    for it in range(max_iter):
        # SVI stochastic-approximation mixing, in f32 as the JAX package
        # computes it; full-batch runs take unmixed updates
        step = np.minimum(np.float32(1.0), np.float32(SVI_decay) / np.float32(it + 1.0)) if svi_mode else np.float32(1.0)
        step, keep = float(step), float(np.float32(1.0) - step)
        batch_idx = schedule[it]
        coordsB_batch = coordsB[batch_idx]
        # ---- E-step (flash-style: the [NA, B] assignment matrix is never kept) ----
        sigma2 = s["sigma2"]
        model_mul_vec = s["alpha"] * torch.exp(-s["SigmaDiag"] / sigma2)
        red = estep_reduced(
            Dim,
            s["XAHat"],
            coordsA,
            coordsB_batch,
            tuple(exp_a_rows),
            tuple(b[batch_idx] for b in exp_b_cols),
            tuple(exp_A_feats),
            tuple(Bf[batch_idx] for Bf in exp_B_feats),
            sigma2,
            model_mul_vec,
            s["gamma"],
            samples_s,
            s["sigma2_variance"],
            list(probability_type),
            [probability_parameters[l] for l in range(len(exp_a_rows))],
            n_chunks=estep_chunks,
            sparse_top_k=sparse_top_k,
            use_kernel=use_kernel_estep,
            shard=shard,
        )
        K_NA_spatial = red["K_NA_spatial"]
        K_NA_sigma2 = red["K_NA_sigma2"]
        Sp = red["Sp"]
        K_NA = red["K_NA"]
        K_NB = red["K_NB"]
        # the sums over NA this iteration needs before its solves, in one
        # collective when sharded
        nonrigid_flag = s["nonrigid_flag"] or it > nonrigid_start_iter
        sums = [K_NA_spatial.sum(), K_NA_sigma2.sum(), K_NA @ coordsA]
        if nonrigid_flag:
            PXB_term_new = red["PXB"] - s["RnA"] * K_NA[:, None]
            PXB_term = step * PXB_term_new + keep * s["PXB_term"]
            sums += [U.T @ (U * K_NA[:, None]), U.T @ PXB_term]
        sums = psum(*sums)
        sum_spatial, sum_sigma2, cA_KNA = sums[:3]
        Sp_spatial = step * sum_spatial + keep * s["Sp_spatial"]
        Sp_total = step * Sp + keep * s["Sp"]
        Sp_sigma2 = step * sum_sigma2 + keep * s["Sp_sigma2"]
        sigma2_related = red["sigma2_related"] / (Dim * Sp_sigma2)

        # ---- gamma / alpha (variational) ----
        gamma = torch.exp(torch.special.digamma(gamma_a + Sp_spatial) - digamma_B)
        gamma = torch.clamp(gamma, 0.01, 0.99)
        alpha_new = torch.exp(
            torch.special.digamma(kappa + K_NA_spatial) - torch.special.digamma(kappa * NA_total + Sp_spatial)
        )
        alpha = step * alpha_new + keep * s["alpha"]

        # ---- non-rigid M-step (from iteration nonrigid_start_iter + 1 on) ----
        Coff, VnA, SigmaDiag = s["Coff"], s["VnA"], s["SigmaDiag"]
        SigmaInv, V_AI = s["SigmaInv"], s["V_AI"]
        if not nonrigid_flag:
            PXB_term = s["PXB_term"]
        else:
            SigmaInv_new = sigma2 * lambdaVF * GammaSparse + sums[3]
            SigmaInv = step * SigmaInv_new + keep * s["SigmaInv"]
            UPXB_term = sums[4]
            if nonrigid_guidance:
                g_coef = sigma2 * guidance_weight * Sp_total / NI
                SigmaInv = SigmaInv + g_coef * (U_I.T @ U_I)
                UPXB_term = UPXB_term + g_coef * (U_I.T @ (X_BI - s["R_AI"]))
            # regularised solves replace pinv; the ridge scales with the
            # trace (SigmaInv can be near rank-1 when the SE kernel saturates)
            ridge = 1e-4 * torch.trace(SigmaInv) / K + 1e-8
            SigmaInv_reg = SigmaInv + ridge * eye_K
            Coff = torch.linalg.solve_ex(SigmaInv_reg, UPXB_term).result
            VnA = U @ Coff
            Sigma_UT = torch.linalg.solve_ex(SigmaInv_reg, U.T).result
            # diag(U Sigma U^T) >= 0 for PD Sigma; clip numerical noise
            SigmaDiag = sigma2 * torch.clamp_min(torch.einsum("ij,ji->i", U, Sigma_UT), 0.0)
            if guidance_effect != "none":
                V_AI = U_I @ Coff

        # ---- rigid M-step ----
        PVA_s, sigma2_diag = psum(K_NA @ VnA, K_NA_sigma2 @ SigmaDiag)
        PXA = cA_KNA[None, :]
        PVA = PVA_s[None, :]
        PXB = (K_NB @ coordsB_batch)[None, :]
        mu_XB, mu_XA, mu_Vn = PXB, PXA, PVA
        mu_X_deno = Sp_total
        mu_Vn_deno = Sp_total
        if nn_init:
            nn_coef = sigma2 * nn_init_weight * Sp_total / inlier_sum
            mu_XB = mu_XB + nn_coef * (inlier_P.T @ inlier_B)
            mu_XA = mu_XA + nn_coef * (inlier_P.T @ inlier_A)
            mu_X_deno = mu_X_deno + nn_coef * inlier_sum
        if rigid_guidance:
            gr_coef = sigma2 * guidance_weight * Sp_total / NI
            mu_XB = mu_XB + gr_coef * torch.mean(X_BI, dim=0)[None, :]
            mu_XA = mu_XA + gr_coef * torch.mean(X_AI, dim=0)[None, :]
            mu_Vn = mu_Vn + gr_coef * torch.mean(s["V_AI"], dim=0)[None, :]
            mu_X_deno = mu_X_deno + gr_coef * NI
            mu_Vn_deno = mu_Vn_deno + gr_coef * NI
        mu_XB = mu_XB / mu_X_deno
        mu_XA = mu_XA / mu_X_deno
        mu_Vn = mu_Vn / mu_Vn_deno

        XA_hat = coordsA - mu_XA
        VnA_hat = VnA - mu_Vn
        # XA_hat^T P XB_hat expanded through the E-step reductions
        # (M1 = coordsA^T P coordsB_batch)
        cB_KNB = K_NB @ coordsB_batch
        cross = (
            red["M1"]
            - torch.outer(cA_KNA, mu_XB[0])
            - torch.outer(mu_XA[0], cB_KNB)
            + Sp * torch.outer(mu_XA[0], mu_XB[0])
        )
        (XV,) = psum(XA_hat.T @ (VnA_hat * K_NA[:, None]))
        A_mat = -(XV - cross).T
        if nn_init:
            inlier_A_hat = inlier_A - mu_XA
            inlier_B_hat = inlier_B - mu_XB
            A_mat = A_mat - nn_coef * ((inlier_A_hat * inlier_P).T @ (-inlier_B_hat)).T
        if rigid_guidance:
            X_AI_hat = X_AI - mu_XA
            X_BI_hat = X_BI - mu_XB
            A_mat = A_mat - gr_coef * (X_AI_hat.T @ ((V_AI - mu_Vn) - X_BI_hat)).T
        R_new = procrustes_rotation(A_mat)
        if not update_R:
            R = s["R"]
        elif step < 1:
            R = step * R_new + keep * s["R"]
        else:
            R = R_new

        t_numerator = PXB - PVA - PXA @ R.T
        t_deno = Sp_total
        if nn_init:
            t_numerator = t_numerator + nn_coef * (inlier_P.T @ (inlier_B - inlier_A @ R.T))
            t_deno = t_deno + nn_coef * inlier_sum
        if rigid_guidance:
            t_numerator = t_numerator + gr_coef * torch.sum(X_BI - V_AI - X_AI @ R.T, dim=0)[None, :]
            t_deno = t_deno + gr_coef * NI
        t_new = (t_numerator / t_deno)[0]
        t = step * t_new + keep * s["t"] if step < 1 else t_new

        RnA = coordsA @ R.T + t
        # guidance points track the rigid transform of the original X_AI
        R_AI = X_AI @ R.T + t if guidance_effect != "none" else s["R_AI"]
        XAHat = VnA + RnA

        # ---- sigma2 ----
        sigma2_new = torch.clamp_min(sigma2_related + sigma2_diag / Sp_sigma2, 1e-3)
        if it < 100:
            sigma2_new = torch.clamp_min(sigma2_new, 1e-2)
        sigma2_variance = torch.clamp_max(s["sigma2_variance"] * sigma2_variance_decrease, sigma2_variance_end)

        # per-iteration trace saved after the updates (reference :281-282)
        if n_traces > 0:
            slot = (it * n_traces) // max_iter
            s["traces"][slot] = XAHat
            s["sigma2_traces"][slot] = sigma2_new

        s.update(
            gamma=gamma,
            alpha=alpha,
            sigma2=sigma2_new,
            sigma2_variance=sigma2_variance,
            VnA=VnA,
            RnA=RnA,
            XAHat=XAHat,
            Coff=Coff,
            SigmaDiag=SigmaDiag,
            R=R,
            t=t,
            SigmaInv=SigmaInv,
            PXB_term=PXB_term,
            Sp=Sp_total,
            Sp_spatial=Sp_spatial,
            Sp_sigma2=Sp_sigma2,
            nonrigid_flag=nonrigid_flag,
            V_AI=V_AI,
            R_AI=R_AI,
            M1=red["M1"],
            Sp_raw=Sp,
            K_NA=K_NA,
            K_NB=K_NB,
            batch_idx=batch_idx,
        )

    # final optimal Procrustes on the last batch (reference :1437), through
    # the stored reductions:
    # (P XnBBar)^T XnABar = M1^T - (K_NB cB) muA^T - muB (K_NA cA)^T + Sp muB muA^T
    coordsB_last = coordsB[s["batch_idx"]]
    (cA_KNA,) = psum(s["K_NA"] @ coordsA)
    mu_XnA = cA_KNA / s["Sp"]
    mu_XnB = (s["K_NB"] @ coordsB_last) / s["Sp"]
    A_opt = (
        s["M1"].T
        - torch.outer(s["K_NB"] @ coordsB_last, mu_XnA)
        - torch.outer(mu_XnB, cA_KNA)
        + s["Sp_raw"] * torch.outer(mu_XnB, mu_XnA)
    )
    optimal_R = procrustes_rotation(A_opt)
    optimal_t = mu_XnB - mu_XnA @ optimal_R.T
    optimal_RnA = coordsA @ optimal_R.T + optimal_t
    if shard is not None:
        # the row-aligned state of every rank, whole on every rank
        for k in ("alpha", "VnA", "RnA", "XAHat", "SigmaDiag", "PXB_term", "K_NA"):
            s[k] = shard.gather_rows(s[k])
        s["traces"] = shard.gather_rows(s["traces"].transpose(0, 1)).transpose(0, 1)
        optimal_RnA = shard.gather_rows(optimal_RnA)
    return s, optimal_R, optimal_t, optimal_RnA


class Morpho_pairwise:
    """Pairwise spatial-transcriptomics alignment (parity surface:
    reference morpho_class.py:54). Runs on `device` (default "cuda");
    `dtype` is accepted for signature parity and the solver computes in
    float32.

    ``mesh``: a `torch.distributed.device_mesh.DeviceMesh`. Every rank
    builds the solver with the same slices; the moving slice's NA rows
    (Morton-ordered) split over the mesh's first axis inside the EM
    (`_morpho_em(shard=)`), each rank sweeping its rows with the E-step
    kernels, while the coarse rigid init, the kernel and the small solves
    run replicated on every rank. Every rank ends with the same whole
    result. The mesh sets the device: a `device` of another type raises.
    In the sparse calculation mode each column's top-k threshold is taken
    over every rank's rows (`methods.math._column_kth`)."""

    def __init__(
        self,
        sampleA: AnnData,
        sampleB: AnnData,
        rep_layer: Union[str, List[str]] = "X",
        rep_field: Union[str, List[str]] = "layer",
        genes: Optional[List[str]] = None,
        spatial_key: str = "spatial",
        key_added: str = "align_spatial",
        iter_key_added: Optional[str] = None,
        save_concrete_iter: bool = False,
        vecfld_key_added: Optional[str] = None,
        dissimilarity: Union[str, List[str]] = "kl",
        probability_type: Union[str, List[str]] = "gauss",
        probability_parameters: Optional[List] = None,
        label_transfer_dict: Optional[dict] = None,
        use_hvg: bool = True,
        nn_init: bool = True,
        init_transform: bool = True,
        allow_flip: bool = False,
        init_layer: str = "X",
        init_field: str = "layer",
        nn_init_top_K: int = 10,
        nn_init_weight: float = 1.0,
        max_iter: int = 200,
        nonrigid_start_iter: int = 80,
        SVI_mode: bool = True,
        batch_size: Optional[int] = None,
        pre_compute_dist: bool = True,
        sparse_calculation_mode: bool = False,
        sparse_top_k: int = 1024,
        lambdaVF: float = 1e2,
        beta: float = 0.01,
        K: int = 15,
        kernel_type: str = "euc",
        graph: Optional[object] = None,
        graph_knn: int = 10,
        use_pallas_estep: bool = True,
        sigma2_init_scale: float = 0.1,
        sigma2_end: Optional[float] = None,
        gamma_a: float = 1.0,
        gamma_b: float = 1.0,
        kappa: float = 1.0,
        partial_robust_level: float = 10,
        normalize_c: bool = True,
        normalize_g: bool = False,
        separate_mean: bool = True,
        separate_scale: bool = False,
        dtype: str = "float32",
        device: str = "cuda",
        verbose: bool = True,
        guidance_pair=None,
        guidance_effect=False,
        guidance_weight: float = 1.0,
        use_chunk: bool = False,
        chunk_capacity: float = 1.0,
        return_mapping: bool = False,
        update_R: bool = True,
        seed: int = 0,
        mesh=None,
    ):
        if mesh is not None:
            from ...parallel._collectives import check_device, mesh_device

            check_device(mesh, device)
            device = mesh_device(mesh)
        self.device = torch.device(device)
        self.sparse_calculation_mode = bool(sparse_calculation_mode)
        self.sparse_top_k = int(sparse_top_k)
        if self.sparse_calculation_mode:
            # the reference disables the precomputed dense expression-distance
            # matrix in sparse mode (morpho_class.py:439-440)
            pre_compute_dist = False
        self.sampleA = sampleA
        self.sampleB = sampleB
        self.rep_layer = [rep_layer] if isinstance(rep_layer, str) else list(rep_layer)
        self.rep_field = [rep_field] if isinstance(rep_field, str) else list(rep_field)
        if len(self.rep_field) == 1 and len(self.rep_layer) > 1:
            self.rep_field = self.rep_field * len(self.rep_layer)
        self.genes = list(genes) if genes is not None else None
        self.spatial_key = spatial_key
        self.key_added = key_added
        self.iter_key_added = iter_key_added
        self.vecfld_key_added = vecfld_key_added
        diss = [dissimilarity] if isinstance(dissimilarity, str) else list(dissimilarity)
        self.dissimilarity = [d.lower() for d in diss] * (len(self.rep_layer) if len(diss) == 1 else 1)
        ptype = [probability_type] if isinstance(probability_type, str) else list(probability_type)
        self.probability_type = [p.lower() for p in ptype] * (len(self.rep_layer) if len(ptype) == 1 else 1)
        # labels use 'prob' probability in the reference
        for i, d in enumerate(self.dissimilarity):
            if d == "label":
                self.probability_type[i] = "prob"
        self.probability_parameters = (
            list(probability_parameters) if probability_parameters is not None else [None] * len(self.rep_layer)
        )
        self.label_transfer_dict = label_transfer_dict
        self.use_hvg = use_hvg
        self.nn_init = nn_init
        self.init_transform = init_transform
        self.allow_flip = allow_flip
        self.init_layer = init_layer
        self.init_field = init_field
        self.nn_init_top_K = nn_init_top_K
        self.nn_init_weight = nn_init_weight
        self.guidance_pair = guidance_pair
        if guidance_effect not in (False, None, "rigid", "nonrigid", "both"):
            raise AlignmentError(f"Invalid guidance_effect {guidance_effect}; use False/'rigid'/'nonrigid'/'both'.")
        self.guidance_effect = guidance_effect if guidance_effect else "none"
        self.guidance_weight = guidance_weight
        self.max_iter = max_iter
        self.nonrigid_start_iter = nonrigid_start_iter
        self.SVI_mode = SVI_mode
        self.batch_size = batch_size
        self.pre_compute_dist = pre_compute_dist
        self.lambdaVF = lambdaVF
        self.beta = beta
        self.K = K
        self.kernel_type = kernel_type
        self.graph = graph
        self.graph_knn = graph_knn
        self.use_pallas_estep = use_pallas_estep
        self.sigma2_init_scale = sigma2_init_scale
        self.sigma2_end = sigma2_end
        self.gamma_a = gamma_a
        self.gamma_b = gamma_b
        self.kappa = kappa
        self.partial_robust_level = partial_robust_level
        self.normalize_c = normalize_c
        self.normalize_g = normalize_g
        self.separate_mean = separate_mean
        self.separate_scale = separate_scale
        self.verbose = verbose
        self.return_mapping = return_mapping
        self.update_R = update_R
        self.seed = seed
        self.mesh = mesh
        self.rng = np.random.default_rng(seed)

        self._align_preprocess()
        self._construct_kernel(K)

    # -- preprocessing ------------------------------------------------------
    def _align_preprocess(self):
        if (
            self.use_hvg
            and ("highly_variable" in self.sampleA.var.columns)
            and ("highly_variable" in self.sampleB.var.columns)
        ):
            genes_lists = [
                self.sampleA.var.index[self.sampleA.var["highly_variable"].astype(bool)],
                self.sampleB.var.index[self.sampleB.var["highly_variable"].astype(bool)],
            ]
        else:
            genes_lists = [self.sampleA.var.index, self.sampleB.var.index]
        common_genes = filter_common_genes(*genes_lists, verbose=self.verbose)
        self.genes = common_genes if self.genes is None else sorted(set(common_genes) & set(self.genes))

        self.exp_layers_A = [
            get_rep(self.sampleA, rep, rep_f, self.genes if rep_f == "layer" else None)
            for rep, rep_f in zip(self.rep_layer, self.rep_field)
        ]
        self.exp_layers_B = [
            get_rep(self.sampleB, rep, rep_f, self.genes if rep_f == "layer" else None)
            for rep, rep_f in zip(self.rep_layer, self.rep_field)
        ]

        # label-transfer prior (reference methods/utils.py:264 + morpho_class
        # .py:365): an 'obs' rep layer is a categorical annotation whose
        # pairwise "distance" is the transfer probability from a [catA, catB]
        # matrix; codes are re-encoded in the matrix's category order
        self.label_transfer = None
        for i, rep_f in enumerate(self.rep_field):
            if rep_f != "obs":
                continue
            rep = self.rep_layer[i]
            import pandas as pd

            catA = sorted(map(str, pd.unique(np.asarray(self.sampleA.obs[rep]).astype(str))))
            catB = sorted(map(str, pd.unique(np.asarray(self.sampleB.obs[rep]).astype(str))))
            td = self.label_transfer_dict
            if td is None:
                from ..utils import generate_label_transfer_dict

                td = generate_label_transfer_dict(catA, catB)
            lt = np.zeros((len(catA), len(catB)), np.float32)
            for j, ca in enumerate(catA):
                for k, cb in enumerate(catB):
                    lt[j, k] = td[ca][cb]
            self.label_transfer = lt
            posA = {c: j for j, c in enumerate(catA)}
            posB = {c: k for k, c in enumerate(catB)}
            self.exp_layers_A[i] = np.asarray(
                [posA[str(v)] for v in np.asarray(self.sampleA.obs[rep]).astype(str)], np.int32
            )
            self.exp_layers_B[i] = np.asarray(
                [posB[str(v)] for v in np.asarray(self.sampleB.obs[rep]).astype(str)], np.int32
            )
            self.dissimilarity[i] = "label"
            self.probability_type[i] = "prob"

        self.coordsA = np.asarray(self.sampleA.obsm[self.spatial_key], dtype=np.float32)
        self.coordsB = np.asarray(self.sampleB.obsm[self.spatial_key], dtype=np.float32)
        if self.coordsA.shape[1] != self.coordsB.shape[1]:
            raise AlignmentError("Spatial coordinate dimensions are different.")
        self.NA, self.NB, self.D = self.coordsA.shape[0], self.coordsB.shape[0], self.coordsA.shape[1]

        if self.normalize_c:
            (coords, self.normalize_scales, self.normalize_means) = normalize_coords(
                [self.coordsA, self.coordsB], self.separate_mean, self.separate_scale
            )
            self.coordsA, self.coordsB = coords
        else:
            self.normalize_scales = np.ones(2)
            self.normalize_means = np.zeros((2, self.D))

        # Morton-order the moving slice's rows (a relabelling: every
        # row-aligned output is inverse-permuted before it leaves the solver),
        # so the E-step's row tiles are spatial neighbourhoods; each SVI
        # minibatch is sorted by the fixed slice's Morton rank inside the EM
        self._orderA = np.argsort(morton_code(self.coordsA), kind="stable")
        self._invA = np.argsort(self._orderA)
        self.coordsA = self.coordsA[self._orderA]
        self.exp_layers_A = [a[self._orderA] for a in self.exp_layers_A]
        self._morton_rank_B = np.argsort(np.argsort(morton_code(self.coordsB), kind="stable")).astype(np.int32)

        # the [N, G] expression arrays go to the device once; the parameter
        # init, the factorisation and the EM reuse them
        self._exp_A_dev = [self._upload(a) for a in self.exp_layers_A]
        self._exp_B_dev = [self._upload(b) for b in self.exp_layers_B]

    def _upload(self, arr) -> torch.Tensor:
        """Label codes keep their integer type; everything else travels as
        float32 through pinned memory."""
        arr = np.asarray(arr)
        return _to_device(arr, self.device, None if arr.dtype.kind in "iu" else torch.float32)

    def _construct_kernel(self, inducing_variables_num: int):
        unique_coords, unique_idx = np.unique(self.coordsA, return_index=True, axis=0)
        if unique_coords.shape[0] > inducing_variables_num:
            pick = self.rng.choice(unique_coords.shape[0], inducing_variables_num, replace=False)
        else:
            pick = np.arange(unique_coords.shape[0])
        idx = unique_idx[pick]
        self.inducing_variables = self.coordsA[idx, :]
        if self.kernel_type == "euc":
            self.GammaSparse = con_K(
                as_tensor(self.inducing_variables, self.device), as_tensor(self.inducing_variables, self.device),
                self.beta,
            )
            self._U_precomputed = None
        elif self.kernel_type == "geodist":
            # geodesic deformation kernel (reference morpho_class.py:865 +
            # methods/utils.py:1190 con_K_graph): distances over the KNN graph
            # of the moving slice, Dijkstra from the inducing points,
            # K = exp(-beta d_geo^2). Host-side scipy, as in the JAX package.
            from scipy.sparse import csr_matrix
            from scipy.sparse.csgraph import dijkstra
            from scipy.spatial import cKDTree

            nA = self.coordsA.shape[0]
            if self.graph is not None:
                # precomputed neighbour graph: a scipy sparse adjacency or a
                # networkx-style graph with weighted edges
                g = self.graph
                if hasattr(g, "edges"):
                    rows, cols, vals = [], [], []
                    for u, v, dd in g.edges(data=True):
                        rows.append(u)
                        cols.append(v)
                        vals.append(float(dd.get("weight", 1.0)))
                    graph = csr_matrix((vals, (rows, cols)), shape=(nA, nA))
                else:
                    graph = csr_matrix(g)
            else:
                k = min(self.graph_knn + 1, nA)
                tree = cKDTree(self.coordsA)
                dists, nbrs = tree.query(self.coordsA, k=k)
                rows = np.repeat(np.arange(nA), k - 1)
                cols = nbrs[:, 1:].ravel()
                vals = dists[:, 1:].ravel()
                graph = csr_matrix((vals, (rows, cols)), shape=(nA, nA))
            D, preds = dijkstra(graph, directed=False, indices=idx, return_predecessors=True)  # [K, NA]
            # first hop from each source point toward each inducing point
            first_node = preds.T.astype(np.int64)  # [NA, K]; -9999 = unreachable
            first_node[idx, np.arange(len(idx))] = idx
            first_node[first_node < 0] = -1
            self._geodesic_first_node = first_node
            D = np.where(np.isfinite(D), D, 1e5).T.astype(np.float32)  # [NA, K]
            self._geodesic_distance = D
            U = np.exp(-self.beta * D**2)
            self._U_precomputed = U
            self.GammaSparse = U[idx, :]
        else:
            raise NotImplementedError(f"Kernel type '{self.kernel_type}' is not implemented (use 'euc' or 'geodist').")
        self.K = self.inducing_variables.shape[0]

    def _init_probability_parameters(self, subsample: int = 20000):
        for i, (d_s, p_t) in enumerate(zip(self.dissimilarity, self.probability_type)):
            if self.probability_parameters[i] is not None:
                continue
            if p_t == "gauss":
                # the distance, row-min and order statistic stay on the device
                exp_A_dev, exp_B_dev = self._exp_A_dev[i], self._exp_B_dev[i]
                draw = lambda n: torch.from_numpy(self.rng.choice(n, subsample, replace=False)).to(self.device)
                if self.NA > subsample:
                    exp_A_dev = exp_A_dev[draw(self.NA)]
                if self.NB > subsample:
                    exp_B_dev = exp_B_dev[draw(self.NB)]
                kth = int(exp_A_dev.shape[0] * 0.05)
                stat = min_dist_order_stat(exp_A_dev, exp_B_dev, kth, metric=d_s)
                self.probability_parameters[i] = torch.clamp_min(stat / 5, 0.01)
            else:
                self.probability_parameters[i] = 0.0  # unused by 'prob'/'cos'

    def _coarse_rigid_alignment(self, n_sampling: int = 20000):
        top_K = self.nn_init_top_K
        sa = self.rng.choice(self.NA, n_sampling, replace=False) if self.NA > n_sampling else np.arange(self.NA)
        sb = self.rng.choice(self.NB, n_sampling, replace=False) if self.NB > n_sampling else np.arange(self.NB)
        coordsA, coordsB = self.coordsA[sa], self.coordsB[sb]
        # self.coordsA is Morton-sorted, sampleA is not: route the sample
        # indices through _orderA so expression rows pair with their coords
        idxA = self._orderA[sa]
        genes = self.genes if self.init_field == "layer" else None
        X_A = get_rep(self.sampleA, self.init_layer, self.init_field, genes)[idxA]
        X_B = get_rep(self.sampleB[sb], self.init_layer, self.init_field, genes)

        N, M = coordsA.shape[0], coordsB.shape[0]
        coordsA, X_A = voxel_data(coordsA, X_A, voxel_num=max(min(int(N / 20), 1000), 100))
        coordsB, X_B = voxel_data(coordsB, X_B, voxel_num=max(min(int(M / 20), 1000), 100))

        # the JAX package pads voxel rows to a bucket of 256 (copies of row
        # 0, masked out); the same rows here keep the fit's statistics equal
        n1, n2 = X_A.shape[0], X_B.shape[0]
        dev = self.device
        up = lambda x: _to_device(pad_rows_bucket(x.astype(np.float32), 256), dev)
        top_K = min(top_K, n1 - 1, n2 - 1)
        train_x, train_y, inlier_P, R, t, flipped = _coarse_match_fit(
            up(X_A), up(X_B), up(coordsA), up(coordsB), n1, n2,
            top_k=top_K,
            metric="kl" if self.init_field == "layer" else "euc",
            allow_flip=bool(self.allow_flip),
        )
        if self.allow_flip and bool(flipped):
            lm.main_info("Flipping detected in coarse rigid alignment.")
        # sub-threshold rows carry P = 0, which is neutral in every weighted term
        self.inlier_A = train_x
        self.inlier_B = train_y
        self.inlier_P = inlier_P
        self.init_R, self.init_t = R, t  # device tensors; numpy after the EM
        if self.init_transform:
            self.inlier_A = self.inlier_A @ R.T + t
            self.coordsA = as_tensor(self.coordsA, dev) @ R.T + t
            # inducing points / U follow the transformed coordinates
            self.inducing_variables = as_tensor(self.inducing_variables, dev) @ R.T + t

    # -- main ---------------------------------------------------------------
    def run(self):
        self._phase_times = None
        dev = self.device
        _phase_mark(self, "start")
        if self.nn_init:
            self._coarse_rigid_alignment()
        else:
            self.init_R, self.init_t = np.eye(self.D), np.zeros(self.D)
            self.inlier_A = np.zeros((1, self.D), np.float32)
            self.inlier_B = np.zeros((1, self.D), np.float32)
            self.inlier_P = np.ones((1, 1), np.float32)

        _phase_mark(self, "initp_done")
        self._init_probability_parameters()
        sigma2_init = self.sigma2_init_scale * init_guess_sigma2_dev(self.coordsA, self.coordsB, device=dev)
        cA = as_tensor(self.coordsA, dev)
        cB = as_tensor(self.coordsB, dev)
        samples_s = torch.maximum(
            torch.prod(cA.max(0).values - cA.min(0).values), torch.prod(cB.max(0).values - cB.min(0).values)
        )

        _phase_mark(self, "sigma2_samples_done")
        U = (
            as_tensor(self._U_precomputed, dev)
            if getattr(self, "_U_precomputed", None) is not None
            else con_K(cA, as_tensor(self.inducing_variables, dev), self.beta)
        )

        # guidance pairs: normalised into the EM frame, moved by the coarse
        # transform that coordsA carries, and their kernel against the
        # inducing points (parity: reference morpho_class.py:561 + :860)
        if self.guidance_effect != "none" and self.guidance_pair is not None:
            if not isinstance(self.guidance_pair, (list, tuple)) or len(self.guidance_pair) != 2:
                raise AlignmentError("guidance_pair must be [X_BI, X_AI] arrays.")
            X_BI = np.asarray(self.guidance_pair[0], np.float32)
            X_AI = np.asarray(self.guidance_pair[1], np.float32)
            if self.normalize_c:
                X_AI = (X_AI - self.normalize_means[0]) / self.normalize_scales[0]
                X_BI = (X_BI - self.normalize_means[1]) / self.normalize_scales[1]
            X_AI = as_tensor(X_AI, dev) @ as_tensor(self.init_R, dev).T + as_tensor(self.init_t, dev)
            U_I = con_K(X_AI, as_tensor(self.inducing_variables, dev), self.beta)
            guidance_effect = self.guidance_effect
        else:
            X_AI = np.zeros((1, self.D), np.float32)
            X_BI = np.zeros((1, self.D), np.float32)
            U_I = np.zeros((1, self.K), np.float32)
            guidance_effect = "none"

        # expression distances factorised once as a_i + b_j + A @ B.T per layer
        _phase_mark(self, "U_guidance_done")
        factors = [
            factorize_distance(a, b, m, self.label_transfer)
            for a, b, m in zip(self._exp_A_dev, self._exp_B_dev, self.dissimilarity)
        ]
        exp_a_rows = tuple(f[0] for f in factors)
        exp_b_cols = tuple(f[1] for f in factors)
        exp_A_feats = tuple(f[2] for f in factors)
        exp_B_feats = tuple(f[3] for f in factors)

        _phase_mark(self, "factorize_done")
        if self.batch_size is None:
            batch_size = min(max(int(self.NB / 10), 1000), self.NB)
        else:
            batch_size = min(self.batch_size, self.NB)
        if not self.SVI_mode:
            batch_size = self.NB
        perm = self.rng.permutation(self.NB).astype(np.int32)
        probability_parameters = torch.stack(
            [torch.as_tensor(p if p is not None else 0.0, dtype=torch.float32, device=dev).reshape(())
             for p in self.probability_parameters]
        )

        f32 = lambda x: as_tensor(x, dev).to(torch.float32)
        # on a mesh the EM takes this rank's rows of the [NA]-row inputs
        shard, rows = None, (lambda x: x)
        if self.mesh is not None:
            from ...parallel._collectives import RowShard

            shard = RowShard(self.mesh, self.NA)
            rows = shard.take
        _phase_mark(self, "preem_done")
        s, optimal_R, optimal_t, optimal_RnA = _morpho_em(
            rows(cA),
            cB,
            tuple(rows(a) for a in exp_a_rows),
            exp_b_cols,
            tuple(rows(A) for A in exp_A_feats),
            exp_B_feats,
            rows(f32(U)),
            f32(self.GammaSparse),
            as_tensor(perm, dev),
            as_tensor(self._morton_rank_B, dev),
            f32(self.inlier_A),
            f32(self.inlier_B),
            f32(self.inlier_P),
            f32(X_AI),
            f32(X_BI),
            f32(U_I),
            probability_parameters,
            sigma2_init.to(torch.float32),
            samples_s.to(torch.float32),
            batch_size=batch_size,
            max_iter=self.max_iter,
            # the full per-iteration record, like the reference's _save_iter;
            # [max_iter, NA, D], only when iter_key_added asks for it
            n_traces=self.max_iter if self.iter_key_added else 0,
            nonrigid_start_iter=self.nonrigid_start_iter,
            probability_type=tuple(self.probability_type),
            update_R=self.update_R,
            nn_init=self.nn_init,
            guidance_effect=guidance_effect,
            guidance_weight=float(self.guidance_weight),
            estep_chunks=_estep_chunks(self.NA if shard is None else shard.rows_local, batch_size, device=dev),
            gamma_a=self.gamma_a,
            gamma_b=self.gamma_b,
            kappa=self.kappa,
            lambdaVF=self.lambdaVF,
            partial_robust_level=self.partial_robust_level,
            nn_init_weight=self.nn_init_weight,
            svi_mode=bool(self.SVI_mode),
            sparse_top_k=self.sparse_top_k if self.sparse_calculation_mode else 0,
            # the hand-written E-step kernels on a CUDA device wherever they
            # apply (math.estep_reduced checks the scope); no size gate
            use_kernel_estep=bool(self.use_pallas_estep),
            shard=shard,
        )
        _phase_mark(self, "em_dispatched")
        # only the host-facing leaves come back; alpha, SigmaDiag, batch_idx,
        # RnA and VnA stay on the device for the lazy P rebuild and properties
        host_keys = ("sigma2", "gamma", "R", "t", "Coff", "XAHat", "sigma2_variance")
        if self.iter_key_added:
            host_keys = host_keys + ("sigma2_traces",)
        small_np = {k: _np(s[k]) for k in host_keys}
        optimal_R, optimal_t, optimal_RnA = _np(optimal_R), _np(optimal_t), _np(optimal_RnA)
        inv = self._invA
        # undo the Morton relabelling of the [max_iter, NA, D] trace on the
        # device: numpy's gather along axis 1 costs ~150 ms at 20k cells
        traces_np = _np(s["traces"][:, torch.from_numpy(inv).to(dev)]) if self.iter_key_added else None
        self.init_R, self.init_t, self.inducing_variables = (
            _np(x) for x in (self.init_R, self.init_t, self.inducing_variables)
        )
        small_np = {**{k: v for k, v in s.items() if k not in ("P", "traces")}, **small_np}
        self.iter_sigma2 = np.asarray(small_np["sigma2_traces"]) if self.iter_key_added else None
        self._state = small_np  # Morton-sorted row space (internal: P rebuild)
        # undo the Morton relabelling on every row-aligned output
        optimal_RnA = optimal_RnA[inv]
        self.sigma2 = float(small_np["sigma2"]) if self.sigma2_end is None else self.sigma2_end
        self.gamma = float(small_np["gamma"])
        self.R = small_np["R"]
        self.t = small_np["t"]
        self.Coff = small_np["Coff"]
        self.XAHat = small_np["XAHat"][inv]
        self._RnA_host = None
        self._VnA_host = None
        self.optimal_R = optimal_R
        self.optimal_t = optimal_t
        self.optimal_RnA = optimal_RnA
        self.iter_traces = traces_np
        self.batch_idx = small_np["batch_idx"]
        self.sigma2_variance = float(small_np["sigma2_variance"])
        # P is rebuilt lazily on first access from what is kept here
        self._P_cache = None
        self._P_explicit = None
        # pre-denormalisation frame, in the SORTED row space
        self._norm_XAHat = np.asarray(small_np["XAHat"]).copy()
        self._norm_coordsB = np.asarray(self.coordsB).copy()
        self._exp_factors = list(zip(exp_a_rows, exp_b_cols, exp_A_feats, exp_B_feats))
        self._samples_s = samples_s

        _phase_mark(self, "pull_done")
        if self.return_mapping:
            # full NA x NB assignment (sorted row space; rows unsorted below)
            model_mul = (self._state["alpha"] * torch.exp(-self._state["SigmaDiag"] / self.sigma2))[:, None]
            spatial_dist = euc_dist(as_tensor(self._norm_XAHat, dev), cB, squared=True)
            exp_dist_full = [a[:, None] + b[None, :] + A @ Bf.T for a, b, A, Bf in self._exp_factors]
            P_full, _, _, _ = get_P_core(
                Dim=float(self.D),
                spatial_dist=spatial_dist,
                exp_dist=exp_dist_full,
                sigma2=torch.as_tensor(self.sigma2, dtype=torch.float32, device=dev),
                model_mul=model_mul,
                gamma=torch.as_tensor(self.gamma, dtype=torch.float32, device=dev),
                samples_s=samples_s,
                sigma2_variance=torch.as_tensor(self.sigma2_variance, dtype=torch.float32, device=dev),
                probability_type=self.probability_type,
                probability_parameters=list(probability_parameters),
            )
            self.P = self._maybe_sparsify_P(_np(P_full)[self._invA])

        self._wrap_output()
        P = self.P
        _phase_mark(self, "P_done")
        return P

    @property
    def RnA(self):
        """Non-rigid-transformed source coordinates [NA, D], read from the
        device on first access."""
        if getattr(self, "_RnA_host", None) is None:
            arr = _np(self._state["RnA"])[self._invA]
            if self.normalize_c and getattr(self, "_output_denormalized", False):
                arr = arr * self.normalize_scales[1] + self.normalize_means[1]
            self._RnA_host = arr
        return self._RnA_host

    @RnA.setter
    def RnA(self, value):
        self._RnA_host = value

    @property
    def VnA(self):
        """Per-point non-rigid displacement field [NA, D], read from the
        device on first access."""
        if getattr(self, "_VnA_host", None) is None:
            self._VnA_host = _np(self._state["VnA"])[self._invA]
        return self._VnA_host

    @VnA.setter
    def VnA(self, value):
        self._VnA_host = value

    @property
    def P(self):
        """Final-batch soft assignment [NA, B], rebuilt on demand from the
        converged parameters; a device tensor, or in sparse calculation mode
        a scipy CSR matrix of the top-k entries of each column (reference
        morpho_class.py:1493)."""
        if getattr(self, "_P_explicit", None) is not None:
            return self._P_explicit
        if getattr(self, "_P_cache", None) is None:
            P_dev = self._compute_final_P()
            self._P_cache = self._maybe_sparsify_P(_np(P_dev)) if self.sparse_calculation_mode else P_dev
        return self._P_cache

    def _maybe_sparsify_P(self, P: np.ndarray):
        """Column top-k sparsification in sparse calculation mode (reference
        methods/utils.py:1369 `_dense_to_sparse` with axis=0/topk)."""
        if not self.sparse_calculation_mode or self.sparse_top_k >= P.shape[0]:
            return P
        from scipy.sparse import csr_matrix

        k = int(self.sparse_top_k)
        rows = np.argpartition(-P, k - 1, axis=0)[:k]  # [k, B]
        cols = np.repeat(np.arange(P.shape[1])[None, :], k, axis=0)
        vals = P[rows, cols]
        return csr_matrix((vals.ravel(), (rows.ravel(), cols.ravel())), shape=P.shape)

    @P.setter
    def P(self, value):
        self._P_explicit = value

    def _compute_final_P(self):
        """Rebuild the final-batch P in the sample's ORIGINAL row order: the
        inverse Morton permutation goes to the [NA]-sized row inputs before
        the rebuild (the column normalisers are permutation-invariant)."""
        dev = self.device
        inv = torch.from_numpy(self._invA).to(dev)
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        sigma_diag = self._state["SigmaDiag"]
        model_mul = (self._state["alpha"] * torch.exp(-sigma_diag / max(self.sigma2, 1e-12)))[:, None][inv]
        return _rebuild_P(
            as_tensor(self._norm_XAHat, dev)[inv],
            as_tensor(self._norm_coordsB, dev),
            self.batch_idx,
            model_mul,
            f32(self.sigma2),
            f32(self.gamma),
            self._samples_s,
            f32(self.sigma2_variance),
            tuple(f[0][inv] for f in self._exp_factors),
            tuple(f[1] for f in self._exp_factors),
            tuple(f[2][inv] for f in self._exp_factors),
            tuple(f[3] for f in self._exp_factors),
            tuple(f32(p if p is not None else 0.0) for p in self.probability_parameters),
            Dim=float(self.D),
            probability_type=tuple(self.probability_type),
        )

    def _wrap_output(self):
        if self.normalize_c:
            scale_B, mean_B = self.normalize_scales[1], self.normalize_means[1]
            self.XAHat = self.XAHat * scale_B + mean_B
            # RnA denormalises inside its lazy property
            if getattr(self, "_RnA_host", None) is not None:
                self._RnA_host = self._RnA_host * scale_B + mean_B
            self._output_denormalized = True
            self.optimal_RnA = self.optimal_RnA * scale_B + mean_B
            if getattr(self, "iter_traces", None) is not None:
                # in place: the trace is this solver's own copy
                self.iter_traces *= scale_B
                self.iter_traces += mean_B
        if self.iter_key_added is not None and getattr(self, "iter_traces", None) is not None:
            # reference shape (morpho_class.py:1043 `_save_iter`):
            # {key_added: {it: XAHat_it}, "sigma2": {it: s2}}
            self.iter_added = {
                self.key_added: {i: np.asarray(t) for i, t in enumerate(self.iter_traces)},
                "sigma2": {i: np.asarray(v) for i, v in enumerate(self.iter_sigma2)},
            }
            self.sampleA.uns[self.iter_key_added] = self.iter_added

        norm_dict = {
            "mean_transformed": self.normalize_means[0],
            "mean_fixed": self.normalize_means[1],
            "scale": self.normalize_scales[0],
            "scale_transformed": self.normalize_scales[0],
            "scale_fixed": self.normalize_scales[1],
        }
        self.init_R, self.init_t, self.inducing_variables = (
            _np(x) for x in (self.init_R, self.init_t, self.inducing_variables)
        )
        self.vecfld = {
            "R": self.R,
            "t": self.t,
            "optimal_R": self.optimal_R,
            "optimal_t": self.optimal_t,
            "init_R": self.init_R,
            "init_t": self.init_t,
            "beta": self.beta,
            "Coff": self.Coff,
            "inducing_variables": self.inducing_variables,
            "normalize_scales": self.normalize_scales if self.normalize_c else None,
            "normalize_means": self.normalize_means if self.normalize_c else None,
            "normalize_c": self.normalize_c,
            "dissimilarity": self.dissimilarity,
            "sigma2": self.sigma2,
            "gamma": self.gamma,
            "NA": self.NA,
            "sigma2_variance": self.sigma2_variance,
            "method": "Spateo",
            "norm_dict": norm_dict,
            "kernel_type": self.kernel_type,
        }
        if self.kernel_type == "geodist":
            # what the GP morphofield needs to evaluate the geodesic kernel at
            # new query points
            self.vecfld["kernel_dict"] = {
                "dist": "geodist",
                "X": _np(self.coordsA),
                "first_node_idx": self._geodesic_first_node,
                "kernel_graph_distance": self._geodesic_distance,
            }


def _phase_mark(self, name):
    """Record the seconds since the first mark of this run under `name`.
    On a CUDA device it waits for the card first, so that each mark closes
    its stage's device work (seven waits per pair)."""
    if self.device.type == "cuda":
        torch.cuda.synchronize(self.device)
    d = getattr(self, "_phase_times", None)
    if d is None:
        d = self._phase_times = {}
        self._phase_t0 = time.perf_counter()
    d[name] = time.perf_counter() - self._phase_t0
