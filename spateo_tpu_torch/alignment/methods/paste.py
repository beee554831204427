"""PASTE alignment: fused Gromov-Wasserstein pairwise + NMF center alignment
(counterpart of `spateo_tpu.alignment.methods.paste`; reference
spateo/alignment/methods/paste.py:26-380).

The [n, n] spatial distances, the expression dissimilarity and the entropic
FGW solve (`ops.ot.fgw`) run on `device`; `method="exact"` takes the host LP
solver `ops.ot.fgw_exact`. The center's NMF is scikit-learn's, step for step
in float64 on `device` (the GPU machine has no scikit-learn): `KLNMF`, the
multiplicative-update KL NMF of ``dissimilarity="kl"``, and `FrobeniusNMF`,
the coordinate-descent Frobenius NMF of every other dissimilarity.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ...core.anndata import AnnData
from ...core.bridge import _to_device
from ...logging import logger_manager as lm
from ...ops.ot import fgw, fgw_exact
from .math import calc_distance, euc_dist
from .morpho import filter_common_genes, get_rep

#: scikit-learn's NMF floor (`sklearn.decomposition._nmf.EPSILON`).
NMF_EPSILON = float(np.finfo(np.float32).eps)


def _pairwise_prep(sampleA, sampleB, genes, layer):
    common = filter_common_genes(sampleA.var.index, sampleB.var.index)
    if genes is not None:
        common = sorted(set(common) & set(genes))
    X_A = get_rep(sampleA, layer, "layer", common)
    X_B = get_rep(sampleB, layer, "layer", common)
    return X_A, X_B, common


def paste_pairwise_align(
    sampleA: AnnData,
    sampleB: AnnData,
    layer: str = "X",
    genes: Optional[List[str]] = None,
    spatial_key: str = "spatial",
    alpha: float = 0.1,
    dissimilarity: str = "kl",
    G_init=None,
    a_distribution=None,
    b_distribution=None,
    norm: bool = False,
    numItermax: int = 200,
    eps: float = 5e-3,
    dtype: str = "float32",
    device="cuda",
    verbose: bool = True,
    method: str = "entropic",
) -> Tuple[np.ndarray, Optional[float]]:
    """Optimal FGW alignment of two slices (parity: reference paste.py:26).

    `method='entropic'` (default) runs the mirror-descent Sinkhorn solver on
    `device`; `method='exact'` runs conditional-gradient FGW with exact LP
    subproblems on the host (small pairs, validation). Returns the plan
    (host array) and the objective."""
    X_A, X_B, common = _pairwise_prep(sampleA, sampleB, genes, layer)
    coordsA = _to_device(np.asarray(sampleA.obsm[spatial_key], dtype=np.float32), device)
    coordsB = _to_device(np.asarray(sampleB.obsm[spatial_key], dtype=np.float32), device)
    # a point's distance to itself is exactly 0, as in the JAX package's jitted
    # expansion; eagerly, |x|^2 + |x|^2 - 2 x.x leaves a rounding residual
    D_A = euc_dist(coordsA, coordsA, squared=False).fill_diagonal_(0.0)
    D_B = euc_dist(coordsB, coordsB, squared=False).fill_diagonal_(0.0)
    [M] = calc_distance(_to_device(X_A, device), _to_device(X_B, device), metric=dissimilarity)

    a = np.ones(sampleA.n_obs) / sampleA.n_obs if a_distribution is None else np.asarray(a_distribution)
    b = np.ones(sampleB.n_obs) / sampleB.n_obs if b_distribution is None else np.asarray(b_distribution)
    if norm:
        D_A = D_A / torch.min(torch.where(D_A > 0, D_A, torch.inf))
        D_B = D_B / torch.min(torch.where(D_B > 0, D_B, torch.inf))
    if method == "exact":
        host = [t.cpu().numpy() for t in (M, D_A, D_B)]
        return fgw_exact(*host, a, b, alpha=alpha, G_init=G_init, max_iter=numItermax)
    return fgw(M, D_A, D_B, a, b, alpha=alpha, eps=eps, G_init=G_init, max_iter=numItermax, device=device)


def _kl_divergence(X, W, H):
    """scikit-learn's ``_beta_divergence(X, W, H, 1, square_root=True)``:
    sqrt(2 * (sum_{X > EPS} X log(X / max(WH, EPS)) + sum WH - sum_{X > EPS} X))."""
    WH = torch.clamp_min(W @ H, NMF_EPSILON)
    keep = X > NMF_EPSILON
    sum_WH = torch.dot(W.sum(0), H.sum(1))
    res = torch.where(keep, X * torch.log(X / WH), 0.0).sum() + (sum_WH - torch.where(keep, X, 0.0).sum())
    return torch.sqrt(2 * torch.clamp_min(res, 0.0))


def _nmf_kl_mu(X, W, H, max_iter: int, tol: float):
    """scikit-learn's `_fit_multiplicative_update` for beta_loss 1 (gamma 1,
    no regularisation): W, then H, each multiplied by its ratio; H entries
    below float64's eps set to 0; the error read on the host every 10
    iterations, stopping once it fell by less than `tol` of the first."""
    error_at_init = float(_kl_divergence(X, W, H))
    previous_error = error_at_init
    n_iter = 0
    for n_iter in range(1, max_iter + 1):
        ratio = X / torch.clamp_min(W @ H, NMF_EPSILON)
        H_sum = H.sum(1)
        denominator = torch.where(H_sum == 0, NMF_EPSILON, H_sum)[None, :]
        W = W * ((ratio @ H.T) / denominator)
        ratio = X / torch.clamp_min(W @ H, NMF_EPSILON)
        W_sum = W.sum(0)
        denominator = torch.where(W_sum == 0, 1.0, W_sum)[:, None]
        H = H * ((W.T @ ratio) / denominator)
        H = torch.where(H < np.finfo(np.float64).eps, 0.0, H)
        if tol > 0 and n_iter % 10 == 0:
            error = float(_kl_divergence(X, W, H))
            if (previous_error - error) / error_at_init < tol:
                break
            previous_error = error
    return W, H, n_iter


def _cd_half_step(W, HHt, XHt):
    """scikit-learn's `_update_cdnmf_fast` (no regularisation, no shuffle):
    the components of W in order, each a Newton step projected on W >= 0,
    with the gradient ``W HHt[t] - XHt[:, t]`` from the components already
    updated. Rows are independent, so one component is one vector op over
    the rows. Returns the summed projected gradient (the violation) as a
    0-d tensor; W is updated in place."""
    violation = W.new_zeros(())
    for t in range(W.shape[1]):
        w = W[:, t]
        grad = W @ HHt[t] - XHt[:, t]
        violation = violation + torch.where(w == 0, torch.clamp_max(grad, 0.0), grad).abs().sum()
        hess = HHt[t, t]
        W[:, t] = torch.where(hess != 0, torch.clamp_min(w - grad / hess, 0.0), w)
    return violation


def _nmf_frobenius_cd(X, W, H, max_iter: int, tol: float):
    """scikit-learn's `_fit_coordinate_descent` (Frobenius loss): a W
    half-step from ``H H^T`` and ``X H^T``, then an H half-step from
    ``W^T W`` and ``X^T W``; the iteration's violation is read on the host
    once, and the loop stops once it is at most `tol` of the first
    iteration's (or that one was 0). Returns (W, H, n_iter)."""
    Ht = H.T.contiguous()
    violation_init = None
    n_iter = 0
    for n_iter in range(1, max_iter + 1):
        violation = _cd_half_step(W, Ht.T @ Ht, X @ Ht)
        violation = float(violation + _cd_half_step(Ht, W.T @ W, X.T @ W))
        if n_iter == 1:
            violation_init = violation
        if violation_init == 0 or violation / violation_init <= tol:
            break
    return W, Ht.T, n_iter


class _RandomInitNMF:
    """scikit-learn's ``NMF(n_components, init="random", random_state=seed)``
    around a solver (`_solve`): the random init on the host exactly as
    scikit-learn draws it (``sqrt(X.mean() / k) * |N(0, 1)|``, H before W,
    from ``RandomState(seed)``), then the solver in float64 on `device`.
    `fit_transform` returns W (host) and sets `components_` (H) and
    `n_iter_`."""

    def __init__(self, n_components: int, random_state: int = 0, max_iter: int = 200, tol: float = 1e-4,
                 device="cuda"):
        self.n_components = n_components
        self.random_state = random_state
        self.max_iter = max_iter
        self.tol = tol
        self.device = device

    def fit_transform(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        if X.min() < 0:
            raise ValueError("Negative values in data passed to NMF.")
        k = self.n_components
        avg = np.sqrt(X.mean() / k)
        rng = np.random.RandomState(self.random_state)
        H = np.abs(avg * rng.standard_normal(size=(k, X.shape[1])))
        W = np.abs(avg * rng.standard_normal(size=(X.shape[0], k)))
        W, H, self.n_iter_ = self._solve(*(_to_device(x, self.device) for x in (X, W, H)), self.max_iter, self.tol)
        self.components_ = H.cpu().numpy()
        return W.cpu().numpy()


class KLNMF(_RandomInitNMF):
    """``sklearn.decomposition.NMF(n_components, solver="mu",
    beta_loss="kullback-leibler", init="random", random_state=seed)``,
    ported: the multiplicative updates (`_nmf_kl_mu`)."""

    _solve = staticmethod(_nmf_kl_mu)


class FrobeniusNMF(_RandomInitNMF):
    """``sklearn.decomposition.NMF(n_components, init="random",
    random_state=seed)`` (solver "cd", Frobenius loss, tol 1e-4, 200
    iterations), ported: coordinate descent (`_nmf_frobenius_cd`)."""

    _solve = staticmethod(_nmf_frobenius_cd)


def center_NMF(n_components: int, random_seed: int, dissimilarity: str = "kl", device="cuda") -> _RandomInitNMF:
    """The center's NMF model, as the JAX package picks it: KL
    multiplicative updates (`KLNMF`) for ``dissimilarity="kl"``, else the
    coordinate-descent Frobenius NMF (`FrobeniusNMF`)."""
    if dissimilarity.lower() in ("kl", "kullback-leibler"):
        return KLNMF(n_components=n_components, random_state=random_seed, device=device)
    return FrobeniusNMF(n_components=n_components, random_state=random_seed, device=device)


def paste_center_align(
    init_center_sample: AnnData,
    samples: List[AnnData],
    layer: str = "X",
    genes: Optional[List[str]] = None,
    spatial_key: str = "spatial",
    lmbda: Optional[np.ndarray] = None,
    alpha: float = 0.1,
    n_components: int = 15,
    threshold: float = 0.001,
    max_iter: int = 10,
    numItermax: int = 200,
    dissimilarity: str = "kl",
    norm: bool = False,
    random_seed: Optional[int] = None,
    pis_init: Optional[List[np.ndarray]] = None,
    distributions=None,
    dtype: str = "float32",
    device="cuda",
    verbose: bool = True,
) -> Tuple[AnnData, List[np.ndarray]]:
    """Infer a center slice + mappings to all slices by alternating NMF and
    FGW (parity: reference paste.py:164), both on `device`."""
    if lmbda is None:
        lmbda = len(samples) * [1 / len(samples)]
    if distributions is None:
        distributions = len(samples) * [None]

    # common genes across all samples + center
    common = filter_common_genes(init_center_sample.var.index, *[s.var.index for s in samples])
    if genes is not None:
        common = sorted(set(common) & set(genes))
    center = init_center_sample[:, np.asarray(common)].copy()
    samples_sub = [s[:, np.asarray(common)] for s in samples]

    center_coords = np.asarray(center.obsm[spatial_key], dtype=np.float32)
    B = get_rep(center, layer, "layer", None).astype(np.float64)

    nmf_model = center_NMF(n_components, random_seed or 0, dissimilarity, device=device)
    W = nmf_model.fit_transform(np.maximum(B, 0))
    H = nmf_model.components_

    pis = pis_init if pis_init is not None else [None] * len(samples_sub)
    R = 0.0
    R_diff = np.inf
    it = 0
    while R_diff > threshold and it < max_iter:
        new_pis = []
        r = []
        center_expr = W @ H
        center_view = AnnData(X=np.maximum(center_expr, 1e-10), var=center.var.copy(), obs=center.obs.copy())
        center_view.obsm[spatial_key] = center_coords
        for i, s in enumerate(samples_sub):
            pi, obj = paste_pairwise_align(
                center_view,
                s,
                layer="X",
                spatial_key=spatial_key,
                alpha=alpha,
                dissimilarity=dissimilarity,
                norm=norm,
                numItermax=numItermax,
                b_distribution=distributions[i],
                device=device,
                verbose=False,
            )
            new_pis.append(pi)
            r.append(obj)
        # NMF update of the center expression from the barycentric projections
        agg = np.zeros_like(B)
        for i, (pi, s) in enumerate(zip(new_pis, samples_sub)):
            X_s = get_rep(s, layer, "layer", None).astype(np.float64)
            agg += lmbda[i] * (pi @ X_s) * len(samples_sub)
        W = nmf_model.fit_transform(np.maximum(agg, 0))
        H = nmf_model.components_
        pis = new_pis
        R_new = float(np.dot(r, lmbda))
        R_diff = abs(R - R_new)
        R = R_new
        it += 1
        if verbose:
            lm.main_info(f"center align iter {it}: objective {R:.6f} (diff {R_diff:.2e})")

    center.X = W @ H
    center.uns["paste_W"] = W
    center.uns["paste_H"] = H
    return center, pis


def generalized_procrustes_analysis(X, Y, pi):
    """Align Y onto X by the Procrustes rotation weighted by the mapping pi
    (parity: reference paste.py:323). Host numpy. Returns (X_shifted,
    Y_aligned, mapping_dict)."""
    X = np.asarray(X, dtype=float)
    Y = np.asarray(Y, dtype=float)
    pi = np.asarray(pi, dtype=float)
    tX = pi.sum(axis=1) @ X / pi.sum()
    tY = pi.sum(axis=0) @ Y / pi.sum()
    X = X - tX
    Y = Y - tY
    H = Y.T @ pi.T @ X
    U, S, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    Y = Y @ R.T
    mapping_dict = {"tX": tX, "tY": tY, "R": R}
    return X, Y, mapping_dict
