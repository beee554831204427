"""SparseVFC: vector-field learning by sparse kernel regression, on the
device (counterpart of `spateo_tpu.ops.vfc`; algorithm: Ma et al. 2013
"Regularized vector field learning with sparse approximation for mismatch
removal").

The EM loop (inlier posterior E-step + regularised kernel-ridge M-step) runs
batched over F fields: `_run_em` keeps a device mask of the fields still
iterating, so each field stops at its own condition as under the JAX
package's vmapped `while_loop`, and the host reads that mask once per
`CHECK_EVERY` iterations. The M-step's products over the N rows are taken in
chunks of at most `ROW_CHUNK` rows (`_tmm`), and it solves an [M, M] system
per field with `cholesky_ex` and two triangular solves; a failed
factorisation is read once, after the loop, and raises.

Returns dynamo-compatible dicts (X/Y/beta/V/C/P/VFCIndex/sigma2/grid/grid_V/
iteration/tecr_traj/E_traj); every host-facing value comes back in one
batched device-to-host copy per call, and ``_device`` keeps the tensors a
chained consumer needs (X, ctrl, C, beta, y_rescale, res).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.bridge import _to_device

#: EM iterations between two host reads of the fields' stop mask.
CHECK_EVERY = 10


def con_K(x: torch.Tensor, y: torch.Tensor, beta) -> torch.Tensor:
    """SE kernel exp(-beta ||x-y||^2) via the matmul expansion. Leading batch
    dimensions are allowed; `beta` is a scalar or one value per batch."""
    beta = torch.as_tensor(beta, dtype=x.dtype, device=x.device)
    d2 = (x * x).sum(-1)[..., :, None] + (y * y).sum(-1)[..., None, :] - 2.0 * (x @ y.transpose(-1, -2))
    return torch.exp(-beta[..., None, None] * torch.clamp_min(d2, 0.0))


def _energy_from_sums(PR, Sp, sigma2, C, U, lambda_, D):
    """Per-field energy from the sums over rows of P * resid2 and of P:
    negative log-likelihood proxy + regularisation."""
    reg = (C * torch.bmm(U, C)).sum((1, 2))  # tr(C^T U C)
    return PR / (2 * sigma2) + Sp * torch.log(sigma2) * D / 2 + lambda_ / 2 * reg


def _no_psum(*parts):
    return parts


#: Rows per chunk of the M-step's K^T (P K) and (P K)^T Y products at most.
#: On an H100 at 4 x 100,000 rows, M 100, 1,024 gave the least device time
#: and the least error against an f64 EM of 1,024-8,192 and one product
#: (`scripts/vfc_row_chunk_sweep.py`).
ROW_CHUNK = 1024


def _row_chunks(N: int) -> int:
    """Chunks of at most `ROW_CHUNK` rows that an N-row EM splits its
    products over (1 below `ROW_CHUNK`)."""
    return -(-N // ROW_CHUNK)


def _tmm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^T B for A [F, N, M] and B [F, N, E], N a multiple of
    `_row_chunks(N)`: one product per chunk of rows, then the chunks' sum in
    order. One product over 100,000 rows leaves a GEMM of [M, M] outputs few
    thread blocks, and sums each entry along one f32 chain; per-chunk
    products keep the card busy and the chains short. (A full-chunk product
    plus a remainder product would need a copy of A's rows each call: bmm
    takes one batch stride, and F fields of N rows give two.)"""
    F, N, M = A.shape
    n = _row_chunks(N)
    part = torch.bmm(A.reshape(F * n, N // n, M).transpose(1, 2), B.reshape(F * n, N // n, -1))
    return part.view(F, n, M, -1).sum(1)


def _em_step(s, K, U, Yk, mask, n_valid, lambda_, a, minP, compute_energy, eye, sigma2_cap, psum=_no_psum):
    """One EM iteration for every field (`vfc.py:188-232` of the JAX package).
    `psum` adds sums over rows over the ranks when K and Yk hold one rank's
    rows (two collectives an iteration)."""
    D = Yk.shape[-1]
    M = K.shape[-1]
    # E-step: inlier posterior (exponent clipped: a diverged V must not
    # produce 0/inf posteriors that lock the all-outlier fixed point)
    resid2 = ((Yk - s["V"]) ** 2).sum(-1)
    gauss = torch.exp(torch.clamp(-resid2 / (2 * s["sigma2"][:, None]), -50.0, 0.0))
    temp = (2 * math.pi * s["sigma2"]) ** (D / 2) * (1 - s["gamma"]) / (s["gamma"] * a)
    P = torch.clamp_min(gauss / (gauss + temp[:, None]), minP) * mask
    KP = K * P[..., None]
    KtPK, rhs, Sp, PR = psum(_tmm(K, KP), _tmm(KP, Yk), P.sum(-1), (P * resid2).sum(-1))
    if compute_energy:
        E = _energy_from_sums(PR, Sp, s["sigma2"], s["C"], U, lambda_, D)
        tecr = torch.abs((E - s["E"]) / torch.clamp_min(torch.abs(E), 1e-12))
    else:
        E, tecr = s["E"], s["tecr"]
    # M-step: weighted kernel ridge, the ridge floored relative to the data
    # term's trace, the lhs symmetrised (f32 round-off leaves K^T P K
    # asymmetric by more than its smallest eigenvalue)
    ridge_floor = 1e-4 * torch.diagonal(KtPK, dim1=1, dim2=2).sum(-1) / M
    ridge = torch.maximum(lambda_ * s["sigma2"], ridge_floor)
    lhs = KtPK + ridge[:, None, None] * U + ridge_floor[:, None, None] * eye
    lhs = 0.5 * (lhs + lhs.transpose(1, 2))
    # two triangular solves: `cholesky_solve` checks its status on the host
    L, info = torch.linalg.cholesky_ex(lhs)
    C = torch.linalg.solve_triangular(L.transpose(1, 2), torch.linalg.solve_triangular(L, rhs, upper=False),
                                      upper=True)
    V = torch.bmm(K, C)
    (num,) = psum((P * ((Yk - V) ** 2).sum(-1)).sum(-1))
    sigma2 = num / (Sp * D)
    # cap sigma2 at its initialisation scale: growth beyond the raw data
    # variance always signals a diverged fit, never real noise
    sigma2 = torch.minimum(sigma2, sigma2_cap)
    gamma = torch.clamp(Sp / n_valid, 0.05, 0.95)
    new = dict(C=C, P=P, V=V, sigma2=sigma2, gamma=gamma, E=E, tecr=tecr, i=s["i"] + 1)
    return new, info


def _stopped(s, max_iter, ecr):
    return ~((s["i"] < max_iter) & (s["tecr"] > ecr) & (s["sigma2"] > 1e-8))


def _run_em(K, U, Y, y_scale, lambda_, gamma0, a, ecr, minP, max_iter, compute_energy, y_mult, psum=_no_psum,
            n_valid=None):
    """EM over precomputed RBF features for F fields at once: K [F, N, M],
    U [F, M, M], Y [F, N, D], y_scale and y_mult [F]. Inside, K and Y gain
    zero rows of weight 0 up to a multiple of `_row_chunks(N)` (for `_tmm`);
    V and P come back with N rows. When K and Y hold one rank's rows,
    `n_valid` is every rank's row count and `psum` adds sums over rows over
    the ranks in rank order, so every rank's state, and so its stop test, is
    the same.

    Each field runs while ``i < max_iter and tecr > ecr and sigma2 > 1e-8``,
    tested before each iteration as in the JAX `while_loop`; a stopped
    field's state is frozen by `torch.where`, so iteration counts and states
    equal the JAX package's. The host reads the stop mask once per
    `CHECK_EVERY` iterations (counted in `_run_em.host_reads`, with the one
    read of the factorisations' status after the loop)."""
    F, N, M = K.shape
    D = Y.shape[-1]
    dev, dt = K.device, K.dtype
    n_valid = float(N if n_valid is None else n_valid)
    n = _row_chunks(N)
    pad = -(-N // n) * n - N
    mask = torch.ones(N + pad, dtype=dt, device=dev)
    if pad:
        K = torch.cat([K, K.new_zeros((F, pad, M))], dim=1)
        Y = torch.cat([Y, Y.new_zeros((F, pad, D))], dim=1)
        mask[N:] = 0.0
    Yk = Y * (y_mult / y_scale)[:, None, None]
    (sigma2_0,) = psum((Yk * Yk).sum((1, 2)))
    sigma2_0 = sigma2_0 / (n_valid * D)
    s = dict(
        C=torch.zeros((F, M, D), dtype=dt, device=dev),
        P=mask.expand(F, N + pad).clone(),
        V=torch.zeros((F, N + pad, D), dtype=dt, device=dev),
        sigma2=sigma2_0,
        gamma=torch.full((F,), gamma0, dtype=dt, device=dev),
        E=torch.ones((F,), dtype=dt, device=dev),
        tecr=torch.full((F,), math.inf, dtype=dt, device=dev),
        i=torch.zeros((F,), dtype=torch.int32, device=dev),
    )
    eye = torch.eye(M, dtype=dt, device=dev)
    failed = torch.zeros((F,), dtype=torch.bool, device=dev)
    stopped = _stopped(s, max_iter, ecr)
    for k in range(max_iter):
        new, info = _em_step(s, K, U, Yk, mask, n_valid, lambda_, a, minP, compute_energy, eye, sigma2_0 * 2.0,
                             psum)
        failed |= (info != 0) & ~stopped
        s = {key: torch.where(stopped.view((F,) + (1,) * (v.dim() - 1)), v, new[key]) for key, v in s.items()}
        stopped = _stopped(s, max_iter, ecr)
        if (k + 1) % CHECK_EVERY == 0 and k + 1 < max_iter:
            _run_em.host_reads += 1
            if bool(stopped.all()):
                break
    _run_em.host_reads += 1
    if bool(failed.any()):
        raise torch.linalg.LinAlgError("SparseVFC: the M-step's Cholesky factorisation failed (lhs not SPD)")
    if not compute_energy:
        # the loop skipped the per-iteration energy; evaluate it once at the
        # fixed point (tecr has no previous E and reports NaN: not tracked)
        resid2 = ((Yk - s["V"]) ** 2).sum(-1)
        PR, Sp = psum((s["P"] * resid2).sum(-1), s["P"].sum(-1))
        s["E"] = _energy_from_sums(PR, Sp, s["sigma2"], s["C"], U, lambda_, D)
        s["tecr"] = torch.full((F,), math.nan, dtype=dt, device=dev)
    s["V"], s["P"] = s["V"][:, :N], s["P"][:, :N]
    return s


_run_em.host_reads = 0


def _sparsevfc_em(X, Y, ctrl, beta, gamma0, a, lambda_, ecr, minP, max_iter, y_mult: float = 1.0,
                  compute_energy: bool = True, psum=_no_psum, n_valid=None):
    """One field's EM on X [N, D], Y [N, D] (raw units, normalised inside to
    unit RMS), with the all-outlier retry: when gamma ends at its floor the
    fit is run again from Y scaled by 0.1 and the retry is kept if its gamma
    is larger (one host read per fit). Returns (state, y_scale, y_mult
    used). With `psum` and `n_valid`, X and Y are one rank's rows (see
    `_run_em`)."""
    N, D = Y.shape
    N = N if n_valid is None else n_valid
    (yy,) = psum((Y * Y).sum())
    y_scale = torch.sqrt(yy / (N * D)) + 1e-12
    K = con_K(X[None], ctrl[None], beta)
    U = con_K(ctrl, ctrl, beta)[None]

    def run_one(ym):
        ym_t = torch.full((1,), ym, dtype=X.dtype, device=X.device)
        s = _run_em(K, U, Y[None], y_scale[None], lambda_, gamma0, a, ecr, minP, max_iter, compute_energy, ym_t,
                    psum, n_valid)
        return {k: v[0] for k, v in s.items()}

    s = run_one(y_mult)
    if float(s["gamma"]) <= 0.06:
        retry = run_one(0.1)
        if float(retry["gamma"]) > float(s["gamma"]):
            return retry, y_scale, 0.1
    return s, y_scale, y_mult


def _median_positive_sqdist(sub: torch.Tensor) -> torch.Tensor:
    """Median of the positive pairwise squared distances (the RBF bandwidth
    heuristic h^2) of `sub` [..., n, D], on its device. An even count takes
    the mean of the two middle values, as `jnp.nanmedian` does; no positive
    distance gives NaN.

    The diagonal is set to exactly 0: the expansion rounds some self-distances
    to a small positive value, and each one counted shifts the median by half
    a rank. The JAX package's jitted version computes them as exactly 0 on the
    CPU."""
    sq = (sub * sub).sum(-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * (sub @ sub.transpose(-1, -2))
    d2 = (d2 * (1.0 - torch.eye(d2.shape[-1], dtype=d2.dtype, device=d2.device))).flatten(-2)
    pos = d2 > 0.0
    k = pos.sum(-1, keepdim=True)
    vals = torch.where(pos, d2, torch.full_like(d2, math.inf)).sort(-1).values
    lo = torch.gather(vals, -1, ((k - 1) // 2).clamp_min(0))
    hi = torch.gather(vals, -1, (k // 2).clamp_max(d2.shape[-1] - 1))
    med = 0.5 * (lo + hi)
    return torch.where(k > 0, med, torch.full_like(med, math.nan))[..., 0]


def _beta_from_h2(h2: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(h2) & (h2 > 0.0), 1.0 / h2, torch.ones_like(h2)).to(torch.float32)


def _field_jacobian(pts, ctrl, C, beta, rescale):
    """Analytic Jacobian of the learned RBF field at `pts` [..., N, D] and the
    per-point divergence (its trace) and curl (3-D: a vector; 2-D: the
    scalar z component). J[n, e, d] = dV_e/dx_d, from
    grad_x K(x, c) = -2 beta (x - c) K; leading batch dimensions are allowed,
    with one `beta` and `rescale` per batch."""
    beta = torch.as_tensor(beta, dtype=pts.dtype, device=pts.device)
    rescale = torch.as_tensor(rescale, dtype=pts.dtype, device=pts.device)
    diff = pts[..., :, None, :] - ctrl[..., None, :, :]  # [..., N, M, D]
    b = beta[..., None, None]
    Kk = torch.exp(-b * (diff**2).sum(-1))  # [..., N, M]
    J = torch.einsum("...nm,...nmd,...me->...ned", Kk, -2.0 * b[..., None] * diff, C) * rescale[..., None, None, None]
    div = torch.diagonal(J, dim1=-2, dim2=-1).sum(-1)
    if pts.shape[-1] == 3:
        curl = torch.stack(
            [J[..., 2, 1] - J[..., 1, 2], J[..., 0, 2] - J[..., 2, 0], J[..., 1, 0] - J[..., 0, 1]], dim=-1
        )
    else:  # 2-D: scalar curl (z component)
        curl = J[..., 1, 0] - J[..., 0, 1]
    return J, div, curl


def _sparsevfc_em_batch(Xs, Ys, ctrls, betas, gamma0, a, lambda_, ecr, minP, max_iter, compute_energy=False,
                        with_morphometrics=True):
    """All F fields' EMs at once on Xs, Ys [F, N, D], ctrls [F, M, D] and
    betas [F], with the analytic-Jacobian div/curl of each fixed point when
    `with_morphometrics`. The all-outlier retry is not run here (the caller
    re-fits collapsed fields one by one). Returns the state dict with
    ``y_scale`` (and ``div``/``curl``), every value batched over F."""
    F, N, D = Xs.shape
    y_scale = torch.sqrt((Ys * Ys).sum((1, 2)) / (N * D)) + 1e-12
    K = con_K(Xs, ctrls, betas)
    U = con_K(ctrls, ctrls, betas)
    ones = torch.ones((F,), dtype=Xs.dtype, device=Xs.device)
    s = _run_em(K, U, Ys, y_scale, lambda_, gamma0, a, ecr, minP, max_iter, compute_energy, ones)
    out = dict(s, y_scale=y_scale)
    if with_morphometrics:
        _, out["div"], out["curl"] = _field_jacobian(Xs, ctrls, s["C"], betas, y_scale)
    return out


def _select_ctrl(Xv: np.ndarray, M: int, rng) -> np.ndarray:
    """Pick M distinct control-point rows (cheap candidate draw first,
    global dedup fallback for duplicate-heavy data); the same draws from
    `rng`, in the same order, as the JAX package."""
    N = Xv.shape[0]
    n_cand = min(N, max(4 * M, M + 8))
    cand = rng.choice(N, n_cand, replace=False)
    direction = rng.standard_normal(Xv.shape[1])
    proj = Xv[cand].astype(np.float64) @ direction
    _, first = np.unique(proj, return_index=True)
    if len(first) < min(M, N) and n_cand < N:
        proj_all = Xv.astype(np.float64) @ direction
        _, uniq_idx = np.unique(proj_all, return_index=True)
        M_eff = min(M, len(uniq_idx))
        return uniq_idx[rng.choice(len(uniq_idx), M_eff, replace=False)]
    return cand[np.sort(first)[:M]]


def _to_host(tensors: dict) -> dict:
    """Every tensor of `tensors` in one device-to-host copy: cast to float32,
    flattened and concatenated on the device, split again on the host."""
    flat = [t.reshape(-1).to(torch.float32) for t in tensors.values()]
    buf = torch.cat(flat).cpu().numpy()
    out, o = {}, 0
    for (k, t), f in zip(tensors.items(), flat):
        out[k] = buf[o : o + f.numel()].reshape(tuple(t.shape))
        o += f.numel()
    return out


def _batch_ctrl_draws(Xs: np.ndarray, M: int, seed: int, draw_subsample: bool):
    """The batch's host draws, in the JAX package's order: each field's
    control points, then (for the bandwidth) each field's subsample of up to
    2,000 rows. Returns (ctrl_idx list, ctrls [F, M_eff, D], subs or None)."""
    F, N, _ = Xs.shape
    rng = np.random.default_rng(seed)
    ctrl_idx = [_select_ctrl(Xs[f], M, rng) for f in range(F)]
    M_eff = min(len(ci) for ci in ctrl_idx)
    ctrl_idx = [ci[:M_eff] for ci in ctrl_idx]
    ctrls = np.stack([Xs[f][ctrl_idx[f]] for f in range(F)])
    subs = None
    if draw_subsample:
        subs = np.stack([Xs[f][rng.choice(N, min(N, 2000), replace=False)] for f in range(F)])
    return ctrl_idx, ctrls, subs


def SparseVFC_batch(
    Xs,
    Ys,
    M: int = 100,
    a: float = 5.0,
    beta: Optional[float] = None,
    ecr: float = 1e-5,
    gamma: float = 0.9,
    lambda_: float = 3.0,
    minP: float = 1e-5,
    MaxIter: int = 500,
    theta: float = 0.75,
    seed: int = 0,
    morphometrics: bool = True,
    device="cuda",
) -> list:
    """Fit many vector fields at once on `device` (parity:
    `spateo_tpu.ops.vfc.SparseVFC_batch`).

    A morphometrics sweep fits one field per adjacent aligned-slice pair;
    here the F fields' EMs run batched ([F, N, M] matmuls, one upload, one
    batched copy back), with the analytic-Jacobian divergence/curl of each
    fixed point when ``morphometrics=True``. All fields share N. Returns a
    list of per-field dicts in the `SparseVFC` format (plus ``div``/``curl``).
    Fields whose inlier fraction collapsed (gamma at its floor) are re-fit
    one by one through `SparseVFC` with seed ``seed + 1 + f``."""
    Xs = np.asarray(Xs, dtype=np.float32)
    Ys = np.asarray(Ys, dtype=np.float32)
    if Xs.ndim != 3 or Xs.shape != Ys.shape:
        raise ValueError(f"Xs/Ys must be matching [F, N, D] stacks, got {Xs.shape} / {Ys.shape}")
    F, N, D = Xs.shape
    Xj = _to_device(Xs, device)
    Yj = _to_device(Ys, device)
    ctrl_idx, ctrls, subs = _batch_ctrl_draws(Xs, M, seed, beta is None)
    ctrl_j = _to_device(ctrls, device)
    if beta is None:
        betas = _beta_from_h2(_median_positive_sqdist(_to_device(subs, device)))
    else:
        betas = torch.full((F,), float(beta), dtype=torch.float32, device=Xj.device)
    out = _sparsevfc_em_batch(Xj, Yj, ctrl_j, betas, gamma, a, lambda_, ecr, minP, MaxIter,
                              compute_energy=(ecr > 0), with_morphometrics=morphometrics)
    keys = ["sigma2", "gamma", "i", "tecr", "E", "y_scale", "V", "C", "P"] + (["div", "curl"] if morphometrics else [])
    h = _to_host(dict({k: out[k] for k in keys}, betas=betas))

    results = []
    for f in range(F):
        res = {
            "X": Xs[f],
            "valid_ind": np.arange(N),
            "X_ctrl": ctrls[f],
            "ctrl_idx": ctrl_idx[f],
            "Y": Ys[f],
            "grid": None,
            "grid_V": None,
            "_device": {"X": Xj[f], "ctrl": ctrl_j[f], "C": out["C"][f], "beta": betas[f],
                        "y_rescale": out["y_scale"][f]},
        }
        if float(h["gamma"][f]) <= 0.06:
            # collapsed fit: re-run the field through the single-field retry
            single = SparseVFC(Xs[f], Ys[f], M=len(ctrl_idx[f]), a=a, beta=beta, ecr=ecr, gamma=gamma,
                               lambda_=lambda_, minP=minP, MaxIter=MaxIter, theta=theta, seed=seed + 1 + f,
                               device=device)
            for k in ("beta", "sigma2", "gamma", "iteration", "tecr_traj", "E_traj", "V", "C", "P", "VFCIndex"):
                res[k] = single[k]
            if morphometrics:
                dev = single["_device"]
                _, div, curl = _field_jacobian(dev["X"], dev["ctrl"], dev["C"], dev["beta"], dev["y_rescale"])
                res["div"], res["curl"] = div.cpu().numpy(), curl.cpu().numpy()
            results.append(res)
            continue
        rescale = float(h["y_scale"][f])
        res.update(
            beta=float(h["betas"][f]),
            sigma2=float(h["sigma2"][f]) * rescale**2,
            gamma=float(h["gamma"][f]),
            iteration=int(h["i"][f]),
            tecr_traj=np.asarray([float(h["tecr"][f])]),
            E_traj=np.asarray([float(h["E"][f])]),
            V=h["V"][f] * rescale,
            C=h["C"][f] * rescale,
            P=h["P"][f],
            VFCIndex=np.where(h["P"][f] > theta)[0],
        )
        if morphometrics:
            res["div"], res["curl"] = h["div"][f], h["curl"][f]
        results.append(res)
    return results


def SparseVFC(
    X: np.ndarray,
    Y: np.ndarray,
    Grid: Optional[np.ndarray] = None,
    M: int = 100,
    a: float = 5.0,
    beta: Optional[float] = None,
    ecr: float = 1e-5,
    gamma: float = 0.9,
    lambda_: float = 3.0,
    minP: float = 1e-5,
    MaxIter: int = 500,
    theta: float = 0.75,
    div_cur_free_kernels: bool = False,
    velocity_based_sampling: bool = True,
    seed: int = 0,
    lstsq_method: str = "drouin",
    verbose: int = 1,
    mesh=None,
    device="cuda",
) -> dict:
    """Sparse Vector Field Consensus on `device` (dynamo-compatible signature
    and return; parity: `spateo_tpu.ops.vfc.SparseVFC`).
    `div_cur_free_kernels`, `velocity_based_sampling`, `lstsq_method` and
    `verbose` are accepted and ignored, as in the JAX package.

    ``mesh``: a `torch.distributed.device_mesh.DeviceMesh` (`:545,623-637`
    of the JAX package). Every rank calls this with the same points; the
    control points and the bandwidth are drawn on the host from the whole
    input, the same on every rank. The rows of X, Y and the [N, M] feature
    matrix split over the mesh's first axis; K^T P K, K^T P Y and the sums
    of P, of the energy and of sigma2 are added over the ranks in rank
    order, and the M x M solve is replicated, so every rank stops at the
    same iteration and returns the same whole result. The mesh sets the
    device: a `device` of another type raises."""
    X = np.asarray(X, dtype=np.float32)
    Y = np.asarray(Y, dtype=np.float32)
    valid_ind = np.where(np.isfinite(Y).all(axis=1) & np.isfinite(X).all(axis=1))[0]
    Xv, Yv = X[valid_ind], Y[valid_ind]
    N, D = Xv.shape
    sh = None
    if mesh is not None:
        from ..parallel._collectives import RowShard, check_device

        check_device(mesh, device)
        sh = RowShard(mesh, N)
        device = sh.device
    Xj = _to_device(Xv, device)
    Yj = _to_device(Yv, device)

    rng = np.random.default_rng(seed)
    ctrl_idx = _select_ctrl(Xv, M, rng)
    ctrl = Xv[ctrl_idx]
    if beta is None:
        sub = Xv[rng.choice(N, min(N, 2000), replace=False)]
        beta_t = _beta_from_h2(_median_positive_sqdist(_to_device(sub, device)))
    else:
        beta_t = torch.tensor(beta, dtype=torch.float32, device=Xj.device)
    ctrl_j = _to_device(ctrl, device)

    if sh is None:
        s, y_scale_t, y_mult = _sparsevfc_em(Xj, Yj, ctrl_j, beta_t, gamma, a, lambda_, ecr, minP, MaxIter,
                                                compute_energy=(ecr > 0))
    else:
        s, y_scale_t, y_mult = _sparsevfc_em(sh.take(Xj), sh.take(Yj), ctrl_j, beta_t, gamma, a, lambda_, ecr, minP,
                                                MaxIter, compute_energy=(ecr > 0), psum=sh.sum, n_valid=N)
        s["V"], s["P"] = sh.gather_rows(s["V"]), sh.gather_rows(s["P"])
    rescale_t = y_scale_t / y_mult

    pull = dict(C=s["C"], V=s["V"], P=s["P"], sigma2=s["sigma2"], i=s["i"], tecr=s["tecr"], E=s["E"],
                rescale=rescale_t, beta=beta_t, gamma=s["gamma"])
    if Grid is not None:
        Grid = np.asarray(Grid, dtype=np.float32)
        pull["grid_V"] = con_K(_to_device(Grid, device), ctrl_j, beta_t) @ s["C"]

    # the cosine-correlation gate that `_morphofield_sparsevfc` restarts on, kept on the device
    # (the positive rescale cancels in the row-wise cosine)
    tn = Yj / (torch.linalg.norm(Yj, dim=1, keepdim=True) + 1e-20)
    pn = s["V"] / (torch.linalg.norm(s["V"], dim=1, keepdim=True) + 1e-20)
    res_t = (tn * pn).sum(1).mean()

    h = _to_host(pull)
    rescale = float(h["rescale"])
    P = h["P"]
    return {
        "X": Xv,
        "valid_ind": np.arange(len(valid_ind)),
        "X_ctrl": ctrl,
        "ctrl_idx": ctrl_idx,
        "Y": Yv,
        "grid": Grid,
        "_device": {"X": Xj, "ctrl": ctrl_j, "C": s["C"], "beta": beta_t, "y_rescale": rescale_t, "res": res_t},
        "beta": float(h["beta"]),
        "gamma": float(h["gamma"]),
        "V": h["V"] * rescale,
        "C": h["C"] * rescale,
        "P": P,
        "VFCIndex": np.where(P > theta)[0],
        "sigma2": float(h["sigma2"]) * rescale**2,
        "iteration": int(h["i"]),
        "tecr_traj": np.asarray([float(h["tecr"])]),
        "E_traj": np.asarray([float(h["E"])]),
        "grid_V": h["grid_V"] * rescale if Grid is not None else None,
    }


def vector_field_function(x: np.ndarray, vf_dict: dict, device="cuda") -> np.ndarray:
    """Evaluate a learned SparseVFC field at arbitrary points."""
    x = _to_device(np.atleast_2d(np.asarray(x, dtype=np.float32)), device)
    ctrl = _to_device(np.asarray(vf_dict["X_ctrl"], dtype=np.float32), device)
    C = _to_device(np.asarray(vf_dict["C"], dtype=np.float32), device)
    return (con_K(x, ctrl, float(vf_dict["beta"])) @ C).cpu().numpy()


def vector_field_function_torch(x: torch.Tensor, ctrl: torch.Tensor, C: torch.Tensor, beta) -> torch.Tensor:
    """Single-point field evaluation, differentiable by `torch.func`."""
    K = torch.exp(-beta * torch.sum((x[None, :] - ctrl) ** 2, dim=1))
    return K @ C
