"""Plain reference of Morpho's pairwise alignment (`morpho_align` on joint
PCs: mode SN-S, the cosine dissimilarity, the coarse init on the same PCs)
of one moving section onto one fixed section.

A frozen copy, in plain PyTorch and NumPy, of the alignment's math as the
program runs it on the card, with every hand-written kernel replaced by
the dense sums it computes: normalised coordinates, the Morton order of
the moving rows, 15 inducing points, the coarse rigid fit from mutual
top-10 matches by squared euclidean distance of the PCs (voxels of the
sampled cells, a 100-iteration robust EM), the Gaussian probability
parameter, sigma2's first guess, the cosine distance as a_i + b_j +
A_i . B_j, and 200 iterations of the SVI EM over
minibatches of a tenth of the fixed cells, the E-step summed in blocks of
columns so that it fits beside nothing else on the card. It imports
nothing of the program. What the program draws from its seed (the
inducing points, the coarse fit's samples, the parameter's samples, the
minibatch order), this file draws again from the same `default_rng(0)`
in the same order.

Matrix products run in float32 with TF32 off, as the configuration
states; `tf32=True` runs them in TF32, the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: The compared numbers and their limits (PERF.md gives the readings they
#: were set from), each the worst judged pair of a run: the largest gap of
#: a rigidly aligned coordinate and of a non-rigidly aligned one, over the
#: fixed section's extent, and the largest gap of an entry of the optimal
#: rotation.
LIMITS = {"rigid_coord_gap": 4e-5, "nonrigid_coord_gap": 5e-5, "rotation_gap": 5e-6}


# -- small helpers -------------------------------------------------------------
def euc2(X, Y):
    return torch.clamp_min((X * X).sum(1)[:, None] + (Y * Y).sum(1)[None, :] - 2.0 * (X @ Y.T), 0.0)


def unit_rows(X, eps=1e-8):
    return X / (torch.linalg.norm(X, dim=1, keepdim=True) + eps)


def cos(X, Y):
    return 0.5 - 0.5 * (unit_rows(X) @ unit_rows(Y).T)


def rotation(A):
    """argmax over 2-D rotations R of tr(R^T A)."""
    a = A[0, 0] + A[1, 1]
    b = A[1, 0] - A[0, 1]
    n = torch.sqrt(a * a + b * b) + 1e-30
    c, s = a / n, b / n
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def morton(coords, bits=16):
    c = np.asarray(coords, np.float64)
    mins = c.min(0)
    q = ((c - mins) / np.maximum(c.max(0) - mins, 1e-12) * (2**bits - 1)).astype(np.uint64)
    code = np.zeros(len(c), np.uint64)
    for b in range(bits):
        for d in range(c.shape[1]):
            code |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * c.shape[1] + d)
    return code


def pad_rows(arr, mult):
    n = arr.shape[0]
    target = -(-n // mult) * mult
    return arr if target == n or n == 0 else np.concatenate([arr, np.repeat(arr[:1], target - n, 0)])


def voxels(coords, exp, voxel_num):
    """Mean of the points and of their expression in each occupied voxel."""
    D = coords.shape[1]
    mins, maxs = coords.min(0), coords.max(0)
    size = float(np.prod(maxs - mins + 1e-12) / voxel_num) ** (1.0 / D)
    grid = np.floor((coords - mins) / max(size, 1e-12)).astype(np.int64)
    dims = grid.max(0) + 1
    flat = np.zeros(len(coords), np.int64)
    for d in range(D):
        flat = flat * dims[d] + grid[:, d]
    _, codes = np.unique(flat, return_inverse=True)
    counts = np.bincount(codes).astype(float)
    vc = np.stack([np.bincount(codes, weights=coords[:, d]) / counts for d in range(D)], 1)
    ve = np.stack([np.bincount(codes, weights=exp[:, g]) / counts for g in range(exp.shape[1])], 1)
    return vc, ve


def smallest_k(D, k):
    vals, idx = torch.sort(D, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def robust_rigid(x, y, dist, mask, n_valid, max_iter=100):
    """The coarse fit's robust EM on NN pairs (x_i -> y_i), weighted by their
    expression distance; returns (P [N, 1], R, t)."""
    N, D = x.shape
    n_valid = torch.as_tensor(n_valid, dtype=torch.float32, device=x.device)
    dist = torch.clamp_min(dist, 0.0)
    dist = dist / (torch.max(dist) / (math.log(10.0) * 2.0))
    weight = torch.exp(-dist) * mask
    sigma2 = torch.sum(((x - y) ** 2) * mask) / (D * n_valid)
    a = torch.maximum(torch.prod(x.max(0).values - x.min(0).values), torch.prod(y.max(0).values - y.min(0).values))
    decay = np.power(np.float32(0.1), np.float32(1.0 / (max_iter - 20)))
    P = weight.clone()
    gamma = torch.full((), 0.5, device=x.device)
    alpha = 1.0
    Sp = P.sum()
    for it in range(max_iter):
        mu_x, mu_y = (x * P).sum(0) / Sp, (y * P).sum(0) / Sp
        R = rotation((y - mu_y).T @ ((x - mu_x) * P))
        t = mu_y - mu_x @ R.T
        y_hat = x @ R.T + t
        term = torch.exp(-((y - y_hat) ** 2).sum(1, keepdim=True) / (2 * sigma2)) * weight
        out = torch.max(weight) * (1 - gamma) * torch.pow(2 * math.pi * sigma2, D / 2) / (gamma * a)
        P = term / (term + out)
        Sp = P.sum()
        gamma = torch.clamp(Sp / n_valid, 0.01, 0.99)
        P = torch.clamp_min(P, 1e-6) * mask
        sigma2 = ((y_hat - y) ** 2 * P).sum() / (D * Sp)
        if it > 20:
            alpha = np.float32(alpha) * decay
            weight = torch.exp(-dist * float(alpha)) * mask
            weight = weight / torch.max(weight)
    term = torch.exp(-((y - y_hat) ** 2).sum(1, keepdim=True) / (2 * 1e-2)) * weight
    out = torch.max(weight) * (1 - 0.1) * math.pow(2 * math.pi * 1e-2, D / 2) / (0.1 * a)
    return term / (term + out) * mask, R, t


def coarse_fit(XA, XB, cA, cB, n1, n2, top_k):
    """Mutual top-K matches of the voxels by squared euclidean distance, then the robust rigid fit;
    returns (matched moving points, matched fixed points, their weights,
    R, t)."""
    dev = XA.device
    n1p, n2p = XA.shape[0], XB.shape[0]
    D = euc2(XA, XB)
    valid = (torch.arange(n1p, device=dev)[:, None] < n1) & (torch.arange(n2p, device=dev)[None, :] < n2)
    D = torch.where(valid, D, torch.finfo(D.dtype).max)
    row_vals, row_idx = smallest_k(D, top_k)
    col_vals, col_idx = smallest_k(D.T, top_k)
    b_idx = torch.cat([torch.arange(n2p, device=dev).repeat_interleave(top_k), row_idx.ravel()])
    a_idx = torch.cat([col_idx.ravel(), torch.arange(n1p, device=dev).repeat_interleave(top_k)])
    dist = torch.cat([col_vals.ravel(), row_vals.ravel()])
    mask = torch.cat([(torch.arange(n2p, device=dev) < n2).repeat_interleave(top_k),
                      (torch.arange(n1p, device=dev) < n1).repeat_interleave(top_k)]).to(torch.float32)[:, None]
    dist = torch.where(mask > 0, dist[:, None], 0.0)
    x, y = cA[a_idx], cB[b_idx]
    P, R, t = robust_rigid(x, y, dist, mask, float((n1 + n2) * top_k))
    thr = torch.clamp_max(torch.topk(P[:, 0], min(20, x.shape[0] - 1) + 1).values[-1], 0.5)
    return x, y, torch.where(P > thr, P, 0.0), R, t


def estep(XAHat, cA, cB, a, b, A, Bf, sigma2, mm, gamma, samples_s, s2v, pparam, n_blocks):
    """The E-step's sums over the [NA, B] assignment, in column blocks: each
    sum over a row of P = w_j * q_ij (a column weight times an unnormalised
    term) is the product of q with the column weights."""
    NA, Dim = XAHat.shape[0], float(XAHat.shape[1])
    outlier = torch.pow(2 * math.pi * sigma2, Dim / 2) * (1 - gamma) / (gamma * samples_s * NA)
    acc = {k: 0.0 for k in ("K_NA", "K_NA_spatial", "K_NA_sigma2", "Sp", "sigma2_related", "PXB", "M1")}
    K_NB = []
    m = mm[:, None]
    for cols in torch.arange(cB.shape[0], device=cB.device).chunk(n_blocks):
        cb = cB[cols]
        d = euc2(XAHat, cb)
        q = torch.exp(d / (-2 * sigma2 / s2v))  # the spatial term at the robust variance
        inlier = 1 - outlier / (outlier + q.sum(0))
        q.mul_(m)
        K_NA_spatial = q @ (1.0 / (outlier + q.sum(0)))
        q = torch.exp(d / (-2 * sigma2)).mul_(m)  # the spatial term, weighted
        w2 = inlier / (q.sum(0) + 1e-8)
        K_NA_sigma2 = q @ w2
        sig_rel = (q * d).sum(0) @ w2
        del d
        e = torch.addmm(a[:, None] + b[cols][None, :], A, Bf[cols].T)  # the expression distance
        q.mul_(torch.exp_(e.div_(-2 * pparam)))
        del e
        w3 = inlier / (q.sum(0) + 1e-8)
        pxb = q @ (cb * w3[:, None])
        K_NB.append(q.sum(0) * w3)
        for k, v in (("K_NA", q @ w3), ("K_NA_spatial", K_NA_spatial), ("K_NA_sigma2", K_NA_sigma2),
                     ("Sp", K_NB[-1].sum()), ("sigma2_related", sig_rel), ("PXB", pxb), ("M1", cA.T @ pxb)):
            acc[k] = acc[k] + v
        del q
    acc["K_NB"] = torch.cat(K_NB)
    return acc


def em(cA, cB, a, b, A, Bf, U, Gamma, perm, rank_B, inA, inB, inP, pparam, sigma2, samples_s, B, n_blocks,
       max_iter=200, nonrigid_start=80, lambdaVF=1e2, robust=10.0, decay_svi=10.0):
    """The SVI EM (no guidance, the coarse matches as priors); returns
    (XAHat, optimal R, optimal t, optimal RnA, sigma2), all in the sorted,
    normalised frame."""
    NA, D = cA.shape
    K = U.shape[1]
    dev = cA.device
    f32 = dict(dtype=torch.float32, device=dev)
    pos = torch.arange(max_iter, device=dev)[:, None] * B + torch.arange(B, device=dev)[None, :]
    drawn = perm.long()[pos % perm.shape[0]]
    schedule = torch.gather(drawn, 1, torch.argsort(rank_B.long()[drawn], dim=1))
    s2v_end, s2v_step = robust, robust ** (1.0 / 100.0)
    in_sum = inP.sum()
    dig_B = torch.special.digamma(torch.full((), 1.0 + 1.0 + B, **f32))
    eye = torch.eye(K, **f32)
    s = dict(alpha=torch.ones(NA, **f32), sigma2=sigma2.reshape(()), s2v=torch.full((), 1.0, **f32),
             VnA=torch.zeros((NA, D), **f32), RnA=cA, XAHat=cA, SigmaDiag=torch.zeros(NA, **f32),
             R=torch.eye(D, **f32), t=torch.zeros(D, **f32), SigmaInv=torch.zeros((K, K), **f32),
             PXB_term=torch.zeros((NA, D), **f32), Sp=torch.zeros((), **f32), Sp_spatial=torch.zeros((), **f32),
             Sp_sigma2=torch.zeros((), **f32), gamma=torch.full((), 0.5, **f32), nonrigid=False)
    for it in range(max_iter):
        step = float(np.minimum(np.float32(1.0), np.float32(decay_svi) / np.float32(it + 1.0)))
        keep = float(np.float32(1.0) - np.float32(step))
        idx = schedule[it]
        cb = cB[idx]
        sig2 = s["sigma2"]
        mm = s["alpha"] * torch.exp(-s["SigmaDiag"] / sig2)
        red = estep(s["XAHat"], cA, cb, a, b[idx], A, Bf[idx], sig2, mm, s["gamma"], samples_s, s["s2v"], pparam,
                    n_blocks)
        K_NA, K_NB, Sp = red["K_NA"], red["K_NB"], red["Sp"]
        nonrigid = s["nonrigid"] or it > nonrigid_start
        cA_KNA = K_NA @ cA
        Sp_spatial = step * red["K_NA_spatial"].sum() + keep * s["Sp_spatial"]
        Sp_total = step * Sp + keep * s["Sp"]
        Sp_sigma2 = step * red["K_NA_sigma2"].sum() + keep * s["Sp_sigma2"]
        sig_rel = red["sigma2_related"] / (D * Sp_sigma2)
        gamma = torch.clamp(torch.exp(torch.special.digamma(1.0 + Sp_spatial) - dig_B), 0.01, 0.99)
        alpha = step * torch.exp(torch.special.digamma(1.0 + red["K_NA_spatial"])
                                 - torch.special.digamma(1.0 * NA + Sp_spatial)) + keep * s["alpha"]
        VnA, SigmaDiag, SigmaInv, PXB_term = s["VnA"], s["SigmaDiag"], s["SigmaInv"], s["PXB_term"]
        if nonrigid:
            PXB_term = step * (red["PXB"] - s["RnA"] * K_NA[:, None]) + keep * s["PXB_term"]
            SigmaInv = step * (sig2 * lambdaVF * Gamma + U.T @ (U * K_NA[:, None])) + keep * s["SigmaInv"]
            reg = SigmaInv + (1e-4 * torch.trace(SigmaInv) / K + 1e-8) * eye
            Coff = torch.linalg.solve_ex(reg, U.T @ PXB_term).result
            VnA = U @ Coff
            SigmaDiag = sig2 * torch.clamp_min(torch.einsum("ij,ji->i", U, torch.linalg.solve_ex(reg, U.T).result), 0.0)
        PVA = (K_NA @ VnA)[None, :]
        s2_diag = red["K_NA_sigma2"] @ SigmaDiag
        PXA, PXB = cA_KNA[None, :], (K_NB @ cb)[None, :]
        nn = sig2 * Sp_total / in_sum
        mu_XB = (PXB + nn * (inP.T @ inB)) / (Sp_total + nn * in_sum)
        mu_XA = (PXA + nn * (inP.T @ inA)) / (Sp_total + nn * in_sum)
        mu_Vn = PVA / Sp_total
        cB_KNB = K_NB @ cb
        cross = red["M1"] - torch.outer(cA_KNA, mu_XB[0]) - torch.outer(mu_XA[0], cB_KNB) \
            + Sp * torch.outer(mu_XA[0], mu_XB[0])
        XV = (cA - mu_XA).T @ ((VnA - mu_Vn) * K_NA[:, None])
        A_mat = -(XV - cross).T - nn * (((inA - mu_XA) * inP).T @ (-(inB - mu_XB))).T
        R = rotation(A_mat)
        R = step * R + keep * s["R"] if step < 1 else R
        t_new = ((PXB - PVA - PXA @ R.T + nn * (inP.T @ (inB - inA @ R.T))) / (Sp_total + nn * in_sum))[0]
        t = step * t_new + keep * s["t"] if step < 1 else t_new
        RnA = cA @ R.T + t
        sig_new = torch.clamp_min(sig_rel + s2_diag / Sp_sigma2, 1e-3)
        if it < 100:
            sig_new = torch.clamp_min(sig_new, 1e-2)
        s.update(alpha=alpha, sigma2=sig_new, s2v=torch.clamp_max(s["s2v"] * s2v_step, s2v_end), VnA=VnA, RnA=RnA,
                 XAHat=VnA + RnA, SigmaDiag=SigmaDiag, R=R, t=t, SigmaInv=SigmaInv, PXB_term=PXB_term, Sp=Sp_total,
                 Sp_spatial=Sp_spatial, Sp_sigma2=Sp_sigma2, gamma=gamma, nonrigid=nonrigid, M1=red["M1"], Sp_raw=Sp,
                 K_NA=K_NA, K_NB=K_NB, cb=cb)
    cA_KNA = s["K_NA"] @ cA
    mu_A = cA_KNA / s["Sp"]
    cb = s["cb"]
    mu_B = (s["K_NB"] @ cb) / s["Sp"]
    A_opt = s["M1"].T - torch.outer(s["K_NB"] @ cb, mu_A) - torch.outer(mu_B, cA_KNA) \
        + s["Sp_raw"] * torch.outer(mu_B, mu_A)
    R_opt = rotation(A_opt)
    t_opt = mu_B - mu_A @ R_opt.T
    return s["XAHat"], R_opt, t_opt, cA @ R_opt.T + t_opt, s["sigma2"]


def align(fixed, moving, settings: dict, device, tf32: bool = False) -> dict:
    """Align `moving` onto `fixed`, each (coords [N, 2], joint PCs [N, G]).
    Returns the moving section's
    rigid and non-rigid coordinates in the fixed section's frame and the
    optimal rotation; `aligned` is the rigid result, as mode SN-S returns
    it."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        with torch.no_grad():
            return _align(fixed, moving, settings, torch.device(device))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _align(fixed, moving, settings, dev):
    want = {"rep_field": "obsm", "dissimilarity": "cos", "init_field": "obsm"}
    if any(settings.get(k) != v for k, v in want.items()):
        raise ValueError(f"the reference follows {want} only")
    cA, XA = np.asarray(moving[0], np.float32), np.asarray(moving[1], np.float32)
    cB, XB = np.asarray(fixed[0], np.float32), np.asarray(fixed[1], np.float32)
    NA, NB = len(cA), len(cB)
    means = np.stack([cA.mean(0), cB.mean(0)])
    cA, cB = cA - means[0], cB - means[1]
    scale = np.array([np.sqrt((c**2).sum() / c.shape[0]) for c in (cA, cB)]).mean()
    cA, cB = cA / scale, cB / scale
    orderA = np.argsort(morton(cA), kind="stable")
    invA = np.argsort(orderA)
    cA, XA_s = cA[orderA], XA[orderA]
    rank_B = np.argsort(np.argsort(morton(cB), kind="stable")).astype(np.int32)
    rng = np.random.default_rng(0)
    up = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)

    # inducing points
    uniq, uidx = np.unique(cA, return_index=True, axis=0)
    K = int(settings.get("K", 15))
    pick = rng.choice(uniq.shape[0], K, replace=False) if uniq.shape[0] > K else np.arange(uniq.shape[0])
    inducing = up(cA[uidx[pick]])
    beta = float(settings.get("beta", 0.01))
    Gamma = torch.exp(-beta * euc2(inducing, inducing))

    # coarse rigid fit on voxels of at most 20,000 sampled cells a section
    sa = rng.choice(NA, 20000, replace=False) if NA > 20000 else np.arange(NA)
    sb = rng.choice(NB, 20000, replace=False) if NB > 20000 else np.arange(NB)
    vA, eA = voxels(cA[sa], XA[orderA[sa]], max(min(int(len(sa) / 20), 1000), 100))
    vB, eB = voxels(cB[sb], XB[sb], max(min(int(len(sb) / 20), 1000), 100))
    n1, n2 = len(vA), len(vB)
    pad = lambda x: up(pad_rows(x.astype(np.float32), 256))
    inA, inB, inP, R0, t0 = coarse_fit(pad(eA), pad(eB), pad(vA), pad(vB), n1, n2, min(10, n1 - 1, n2 - 1))
    inA = inA @ R0.T + t0
    cA_t = up(cA) @ R0.T + t0
    inducing = inducing @ R0.T + t0

    # the Gaussian's parameter from 20,000 sampled cells a section
    eA_d, eB_d = up(XA_s), up(XB)
    sub_A = eA_d[torch.as_tensor(rng.choice(NA, 20000, replace=False), device=dev)] if NA > 20000 else eA_d
    sub_B = eB_d[torch.as_tensor(rng.choice(NB, 20000, replace=False), device=dev)] if NB > 20000 else eB_d
    kth = int(sub_A.shape[0] * 0.05)
    pparam = torch.clamp_min(torch.sort(cos(sub_A, sub_B).min(1).values).values[kth] / 5, 0.01)
    del sub_A, sub_B

    # sigma2's first guess from its own default_rng(0)
    r2 = np.random.default_rng(0)
    ga = r2.choice(NA, 20000, replace=False) if NA > 20000 else np.arange(NA)
    gb = r2.choice(NB, 20000, replace=False) if NB > 20000 else np.arange(NB)
    cB_d = up(cB)
    sig0 = 0.1 * (euc2(cA_t[torch.as_tensor(ga, device=dev)], cB_d[torch.as_tensor(gb, device=dev)]) ** 2).sum() \
        / (2 * len(ga) * len(ga))
    samples_s = torch.maximum(torch.prod(cA_t.max(0).values - cA_t.min(0).values),
                              torch.prod(cB_d.max(0).values - cB_d.min(0).values))
    U = torch.exp(-beta * euc2(cA_t, inducing))

    # the cosine distance 0.5 - 0.5 cos as a_i + b_j + A_i . B_j
    a = torch.full((NA,), 0.25, dtype=torch.float32, device=dev)
    b = torch.full((NB,), 0.25, dtype=torch.float32, device=dev)
    Xp, Bf = -0.5 * unit_rows(eA_d), unit_rows(eB_d)
    batch = min(max(int(NB / 10), 1000), NB)
    perm = torch.as_tensor(rng.permutation(NB).astype(np.int32), device=dev)
    n_blocks = max(1, -(-NA * batch // 250_000_000))  # [NA, columns] blocks of up to 1 GB of float32
    XAHat, R, _, RnA, _ = em(cA_t, cB_d, a, b, Xp, Bf, U, Gamma, perm, torch.as_tensor(rank_B, device=dev),
                                  inA, inB, inP, pparam, sig0, samples_s, batch, n_blocks,
                                  max_iter=int(settings.get("max_iter", 200)))
    host = lambda x: x.detach().cpu().numpy()
    rigid = host(RnA)[invA] * scale + means[1]
    return {"rigid": rigid, "nonrigid": host(XAHat)[invA] * scale + means[1], "aligned": rigid, "R": host(R)}
