"""Alignment math: pairwise distances, probabilities, SE kernels, the coarse
robust rigid fit and the P-free (flash) Morpho E-step.

Counterpart of `spateo_tpu.alignment.methods.math`, function for function.
Every tensor function runs on the device of its inputs. Host arrays enter
through `as_tensor`, which narrows float64 to float32 as `jnp.asarray` does
with x64 off, so both packages compute in f32.

Metric naming follows the reference: metric "euc" returns SQUARED euclidean
distances, which is what the Gaussian probabilities expect.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor on `device` (default: where `x` is, or the CPU); float64
    input becomes float32."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t if device is None else t.to(device)


def _device_of(*xs, default="cpu") -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device(default)


def euc_dist(X: torch.Tensor, Y: torch.Tensor, squared: bool = True) -> torch.Tensor:
    """Pairwise (squared) euclidean distance through the expansion
    ||x||^2 + ||y||^2 - 2 x.y (one GEMM for the cross term)."""
    x2 = torch.sum(X * X, dim=1)[:, None]
    y2 = torch.sum(Y * Y, dim=1)[None, :]
    d2 = torch.clamp_min(x2 + y2 - 2.0 * (X @ Y.T), 0.0)
    return d2 if squared else torch.sqrt(d2)


def kl_dist(X: torch.Tensor, Y: torch.Tensor, probabilistic: bool = True, eps: float = 1e-8) -> torch.Tensor:
    """Pairwise KL(X_i || Y_j): rows shifted by +0.01 and normalised, then
    KL = sum_d x log x - x log y; the cross term is one GEMM."""
    X = X + 0.01
    Y = Y + 0.01
    if probabilistic:
        X = X / torch.sum(X, dim=1, keepdim=True)
        Y = Y / torch.sum(Y, dim=1, keepdim=True)
    log_X = torch.log(X + eps)
    log_Y = torch.log(Y + eps)
    entropy = torch.sum(X * log_X, dim=1)[:, None]
    return entropy - X @ log_Y.T


def cosine_dist(X: torch.Tensor, Y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    Xn = X / (torch.linalg.norm(X, dim=1, keepdim=True) + eps)
    Yn = Y / (torch.linalg.norm(Y, dim=1, keepdim=True) + eps)
    return 0.5 - 0.5 * (Xn @ Yn.T)


def label_dist(X_labels: torch.Tensor, Y_labels: torch.Tensor, label_transfer: torch.Tensor) -> torch.Tensor:
    """Pairwise label-transfer cost: lookup into a (K, L) cost matrix."""
    return label_transfer[X_labels.long()[:, None], Y_labels.long()[None, :]]


def calc_distance(
    X,
    Y,
    metric: Union[List[str], str] = "euc",
    label_transfer=None,
) -> List[torch.Tensor]:
    """Pairwise distances for (lists of) representations (parity:
    reference methods/utils.py:866)."""
    if not isinstance(X, list):
        X = [X]
    if not isinstance(Y, list):
        Y = [Y]
    if not isinstance(metric, list):
        metric = [metric] * len(X)
    out = []
    for x, y, m in zip(X, Y, metric):
        dev = _device_of(x, y)
        x = as_tensor(x, dev)
        y = as_tensor(y, dev)
        if m == "label":
            if label_transfer is None:
                raise ValueError("label_transfer must be provided for metric 'label'.")
            out.append(label_dist(x, y, as_tensor(label_transfer, dev)))
        elif m in ("euc", "euclidean"):
            out.append(euc_dist(x, y, squared=True))
        elif m in ("square_euc", "square_euclidean"):
            out.append(euc_dist(x, y, squared=False))
        elif m == "kl":
            out.append(kl_dist(x, y))
        elif m == "sym_kl":
            out.append((kl_dist(x, y) + kl_dist(y, x).T) / 2)
        elif m in ("cos", "cosine"):
            out.append(cosine_dist(x, y))
        else:
            raise ValueError(f"Unsupported metric {m}")
    return out


def calc_probability(distance_matrix: torch.Tensor, probability_type: str = "gauss", probability_parameter=None):
    """Distance -> unnormalised probability (parity: methods/utils.py:944)."""
    if probability_type.lower() in ("gauss", "gaussian"):
        if probability_parameter is None:
            raise ValueError("probability_parameter must be provided for 'Gauss' probability type.")
        return torch.exp(-distance_matrix / (2 * probability_parameter))
    if probability_type.lower() in ("cos", "cosine"):
        return 1 - distance_matrix
    if probability_type.lower() == "prob":
        return distance_matrix
    raise ValueError(f"Unsupported probability type: {probability_type}")


def procrustes_rotation(A: torch.Tensor) -> torch.Tensor:
    """argmax_{R in SO(D)} tr(R^T A). D=2 in closed form, R = [[c,-s],[s,c]]
    with (c, s) proportional to (A00+A11, A10-A01); D>=3 by SVD with the
    det(+1) correction. Neither reads anything back to the host."""
    D = A.shape[0]
    if D == 2:
        a = A[0, 0] + A[1, 1]
        b = A[1, 0] - A[0, 1]
        n = torch.sqrt(a * a + b * b) + 1e-30
        c, s = a / n, b / n
        return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    svdU, _, svdV = torch.linalg.svd(A)
    C = torch.eye(D, dtype=A.dtype, device=A.device)
    C[-1, -1] = torch.linalg.det(svdU @ svdV)
    return svdU @ C @ svdV


def con_K(X, Y, beta: float = 0.01) -> torch.Tensor:
    """Squared-exponential kernel K(i,j)=exp(-beta ||X_i - Y_j||^2)
    (parity: methods/utils.py:1132)."""
    dev = _device_of(X, Y)
    return torch.exp(-beta * euc_dist(as_tensor(X, dev), as_tensor(Y, dev), squared=True))


def get_P_core(
    Dim: float,
    spatial_dist: torch.Tensor,  # [NA, M] squared distances
    exp_dist: List[torch.Tensor],  # list of [NA, M]
    sigma2,
    model_mul,  # [NA, 1]: alpha * exp(-SigmaDiag / sigma2)
    gamma,
    samples_s,
    sigma2_variance,
    probability_type: List[str],
    probability_parameters: List,
    eps: float = 1e-8,
):
    """E-step soft-assignment core (parity: reference methods/utils.py:993).
    The outlier model normalises over COLUMNS. Returns (P, K_NA_spatial,
    K_NA_sigma2, sigma2_related)."""
    spatial_prob = calc_probability(spatial_dist, "gauss", sigma2 / sigma2_variance)
    outlier_s = samples_s * spatial_dist.shape[0]
    spatial_outlier = torch.pow(2 * math.pi * sigma2, Dim / 2) * (1 - gamma) / (gamma * outlier_s)
    spatial_inlier = 1 - spatial_outlier / (spatial_outlier + torch.sum(spatial_prob, dim=0, keepdim=True))
    spatial_prob = spatial_prob * model_mul

    P = spatial_prob / (spatial_outlier + torch.sum(spatial_prob, dim=0, keepdim=True))
    K_NA_spatial = P.sum(1)

    spatial_prob = calc_probability(spatial_dist, "gauss", sigma2) * model_mul
    P = spatial_inlier * spatial_prob / (torch.sum(spatial_prob, dim=0, keepdim=True) + eps)
    K_NA_sigma2 = P.sum(1)
    sigma2_related = (P * spatial_dist).sum()

    for e_d, p_t, p_p in zip(exp_dist, probability_type, probability_parameters):
        spatial_prob = spatial_prob * calc_probability(e_d, p_t, p_p)

    P = spatial_inlier * spatial_prob / (torch.sum(spatial_prob, dim=0, keepdim=True) + eps)
    return P, K_NA_spatial, K_NA_sigma2, sigma2_related


def _inlier_from_NN_kernel(train_x, train_y, distance, mask, n_valid, max_iter: int = 100):
    """Robust rigid fit from noisy NN matches (parity: methods/utils.py:1220).
    2-D on a CUDA device: the hand-written kernel `ops/inlier_cuda.py::
    inlier_fit` (all iterations in one launch). Otherwise its plain version,
    a Python loop over device tensors with no read back to the host.
    Returns (P [N, 1], R, t, weight0 [N, 1], sigma2, gamma)."""
    from ...ops.inlier_cuda import inlier_fit, inlier_reference

    fit = inlier_fit if train_x.device.type == "cuda" and train_x.shape[1] == 2 else inlier_reference
    return fit(train_x, train_y, distance, mask, n_valid, max_iter=max_iter)


def smallest_k(D: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row and their column indices, ties
    broken toward the lower index, as `jax.lax.top_k(-D, k)` breaks them
    (`torch.topk` promises no order among ties). A stable sort of each
    row."""
    vals, idx = torch.sort(D, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def min_dist_order_stat(X, Y, kth: int, metric: str = "kl"):
    """kth order statistic of the per-row minimum pairwise distance; stays
    on the device."""
    [D] = calc_distance(X, Y, metric=metric)
    return torch.sort(torch.min(D, dim=1).values).values[kth]


def mutual_topk_distance(X, Y, n_x: int, n_y: int, metric: str = "kl", top_k: int = 10):
    """Mutual top-K nearest matching on a padded distance matrix: per row
    and per column the K smallest entries, padding rows/cols masked out.
    Returns (row_vals [Nx,K], row_idx [Nx,K], col_vals [Ny,K], col_idx
    [Ny,K])."""
    [D] = calc_distance(X, Y, metric=metric)
    big = torch.finfo(D.dtype).max
    valid = (torch.arange(D.shape[0], device=D.device)[:, None] < n_x) & (
        torch.arange(D.shape[1], device=D.device)[None, :] < n_y
    )
    Dm = torch.where(valid, D, big)
    row_vals, row_idx = smallest_k(Dm, top_k)
    col_vals, col_idx = smallest_k(Dm.T, top_k)
    return row_vals, row_idx, col_vals, col_idx


def morton_code(coords: np.ndarray, bits: int = 16) -> np.ndarray:
    """Morton (Z-order) code of each point: quantise each dimension to
    `bits` and interleave. Sorting rows by it makes consecutive rows spatial
    neighbours, so the E-step's [row-tile, col-tile] blocks are spatial
    neighbourhoods and far-apart tiles can be skipped."""
    c = np.asarray(coords, np.float64)
    mins = c.min(axis=0)
    spans = np.maximum(c.max(axis=0) - mins, 1e-12)
    q = ((c - mins) / spans * (2**bits - 1)).astype(np.uint64)
    D = c.shape[1]
    code = np.zeros(len(c), np.uint64)
    for b in range(bits):
        for d in range(D):
            code |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * D + d)
    return code


def pad_rows_bucket(arr: np.ndarray, mult: int = 1024) -> np.ndarray:
    """Pad the row count up to a multiple of `mult` with copies of row 0.
    Kept so that the port feeds its coarse fit the same padded rows as the
    JAX package (the extent and max statistics include them)."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    target = ((n + mult - 1) // mult) * mult
    if target == n or n == 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[:1], target - n, axis=0)], axis=0)


def inlier_from_NN(train_x, train_y, distance, device="cuda") -> Tuple[np.ndarray, ...]:
    """Host-facing wrapper returning numpy (parity signature with the
    reference); rows are padded to a 2048-multiple as in the JAX package.
    Runs on the card unless `device="cpu"`."""
    n = np.asarray(train_x).shape[0]
    tx = pad_rows_bucket(np.asarray(train_x, np.float32), 2048)
    ty = pad_rows_bucket(np.asarray(train_y, np.float32), 2048)
    dd = pad_rows_bucket(np.asarray(distance, np.float32), 2048)
    mask = np.zeros((tx.shape[0], 1), np.float32)
    mask[:n] = 1.0
    P, R, t, w, sigma2, gamma = _inlier_from_NN_kernel(
        as_tensor(tx, device), as_tensor(ty, device), as_tensor(dd, device), as_tensor(mask, device), float(n)
    )
    return (
        P.cpu().numpy()[:n], R.cpu().numpy(), t.cpu().numpy(), w.cpu().numpy()[:n], float(sigma2), float(gamma)
    )


def voxel_data(
    coords: np.ndarray,
    gene_exp: np.ndarray,
    voxel_size: Optional[float] = None,
    voxel_num: Optional[int] = 10000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mean-pool points and expression into spatial voxels (parity:
    methods/utils.py:1283). Host-side; returns float64 like the JAX
    package's, which its callers narrow to float32."""
    coords = np.asarray(coords)
    gene_exp = np.asarray(gene_exp)
    D = coords.shape[1]
    mins, maxs = coords.min(0), coords.max(0)
    if voxel_size is None:
        voxel_size = float(np.prod(maxs - mins + 1e-12) / voxel_num) ** (1.0 / D)
    grid = np.floor((coords - mins) / max(voxel_size, 1e-12)).astype(np.int64)
    dims = grid.max(0) + 1
    flat = np.zeros(len(coords), dtype=np.int64)
    for d in range(D):
        flat = flat * dims[d] + grid[:, d]
    uniq, codes = np.unique(flat, return_inverse=True)
    n = len(uniq)
    counts = np.bincount(codes).astype(float)
    vox_coords = np.zeros((n, D))
    for d in range(D):
        vox_coords[:, d] = np.bincount(codes, weights=coords[:, d]) / counts
    vox_exp = np.zeros((n, gene_exp.shape[1]), dtype=float)
    for g in range(gene_exp.shape[1]):
        vox_exp[:, g] = np.bincount(codes, weights=gene_exp[:, g]) / counts
    return vox_coords, vox_exp


def init_guess_sigma2(XA, XB, subsample: int = 20000, device=None) -> float:
    """Initial sigma2 guess (parity: methods/utils.py:1339), read back as a
    float. Runs where a tensor argument lies, else on the card unless
    `device="cpu"`."""
    return float(init_guess_sigma2_dev(XA, XB, subsample=subsample, device=device))


def init_guess_sigma2_dev(XA, XB, subsample: int = 20000, device=None) -> torch.Tensor:
    """init_guess_sigma2 as a 0-d tensor on the device, so that the EM chains
    on it with no read back. Draws its subsamples from its own
    `default_rng(0)`, as the JAX package does. Runs on `device`, else where
    a tensor argument lies, else on the card."""
    device = device if device is not None else _device_of(XA, XB, default="cuda")
    rng = np.random.default_rng(0)
    NA, NB, D = XA.shape[0], XB.shape[0], XA.shape[1]
    sa = rng.choice(NA, subsample, replace=False) if NA > subsample else np.arange(NA)
    sb = rng.choice(NB, subsample, replace=False) if NB > subsample else np.arange(NB)
    XA_s = as_tensor(XA, device)[torch.from_numpy(sa).to(device)]
    XB_s = as_tensor(XB, device)[torch.from_numpy(sb).to(device)]
    return torch.sum(euc_dist(XA_s, XB_s, squared=True) ** 2) / (D * len(sa) * len(sa))


def normalize_coords(
    coords: List[np.ndarray],
    separate_mean: bool = True,
    separate_scale: bool = False,
) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """Zero-centre and scale-normalise coordinate sets (parity:
    methods/utils.py:516). Host-side numpy, float32 in, float32 out."""
    D = coords[0].shape[1]
    normalize_means = np.stack([c.mean(0) for c in coords])
    if not separate_mean:
        normalize_means = np.tile(normalize_means.mean(0), (len(coords), 1))
    coords = [c - m for c, m in zip(coords, normalize_means)]
    normalize_scales = np.array([np.sqrt((c**2).sum() / c.shape[0]) for c in coords])
    if not separate_scale:
        normalize_scales = np.full(len(coords), normalize_scales.mean())
    coords = [c / s for c, s in zip(coords, normalize_scales)]
    return coords, normalize_scales, normalize_means


def factorize_distance(
    X,
    Y,
    metric: str = "euc",
    label_transfer=None,
    eps: float = 1e-8,
):
    """Factor a pairwise distance as `d_ij = a_i + b_j + (A @ B.T)_ij`, so
    the EM evaluates minibatch distances on the fly (O((NA+NB)·G) memory).

    Returns (a_row [NA], b_col [NB], A_feat [NA, G'], B_feat [NB, G'])."""
    dev = _device_of(X, Y)
    X = as_tensor(X, dev).to(torch.float32)
    Y = as_tensor(Y, dev).to(torch.float32)
    NA, NB = X.shape[0], Y.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    if metric in ("euc", "euclidean"):
        return torch.sum(X * X, dim=1), torch.sum(Y * Y, dim=1), -2.0 * X, Y
    if metric == "kl":
        Xp = X + 0.01
        Yp = Y + 0.01
        Xp = Xp / torch.sum(Xp, dim=1, keepdim=True)
        Yp = Yp / torch.sum(Yp, dim=1, keepdim=True)
        return torch.sum(Xp * torch.log(Xp + eps), dim=1), torch.zeros(NB, **f32), Xp, -torch.log(Yp + eps)
    if metric == "sym_kl":
        Xp = X + 0.01
        Yp = Y + 0.01
        Xp = Xp / torch.sum(Xp, dim=1, keepdim=True)
        Yp = Yp / torch.sum(Yp, dim=1, keepdim=True)
        lX = torch.log(Xp + eps)
        lY = torch.log(Yp + eps)
        A = 0.5 * torch.cat([Xp, lX], dim=1)
        B = torch.cat([-lY, -Yp], dim=1)
        return 0.5 * torch.sum(Xp * lX, dim=1), 0.5 * torch.sum(Yp * lY, dim=1), A, B
    if metric in ("cos", "cosine"):
        Xn = X / (torch.linalg.norm(X, dim=1, keepdim=True) + eps)
        Yn = Y / (torch.linalg.norm(Y, dim=1, keepdim=True) + eps)
        # d = 0.5 - 0.5 * sim (reference methods/utils.py:741)
        return torch.full((NA,), 0.25, **f32), torch.full((NB,), 0.25, **f32), -0.5 * Xn, Yn
    if metric == "label":
        if label_transfer is None:
            raise ValueError("label_transfer must be provided for metric 'label'.")
        lt = as_tensor(label_transfer, dev).to(torch.float32)
        C1, C2 = lt.shape
        onehot_x = torch.nn.functional.one_hot(X.long().ravel(), C1).to(torch.float32)
        onehot_y = torch.nn.functional.one_hot(Y.long().ravel(), C2).to(torch.float32)
        return torch.zeros(NA, **f32), torch.zeros(NB, **f32), onehot_x @ lt, onehot_y
    raise ValueError(f"Unsupported metric {metric}")


def estep_reduced(
    Dim: float,
    XAHat: torch.Tensor,  # [NA, D]
    coordsA: torch.Tensor,  # [NA, D] (original, for the M1 cross term)
    coordsB_batch: torch.Tensor,  # [B, D]
    exp_a_rows,  # tuple of [NA]
    exp_b_batch,  # tuple of [B]
    exp_A_feats,  # tuple of [NA, G_l]
    exp_B_batch,  # tuple of [B, G_l]
    sigma2,
    model_mul_vec: torch.Tensor,  # [NA]
    gamma,
    samples_s,
    sigma2_variance,
    probability_type,
    probability_parameters,
    n_chunks: int = 8,
    eps: float = 1e-8,
    sparse_top_k: int = 0,
    use_kernel: bool = True,
    shard=None,
):
    """Flash-style E-step: every consumer of the [NA, B] assignment matrix is
    a reduction, so P is never kept. Returns (K_NA, K_NB, Sp, K_NA_spatial,
    K_NA_sigma2, sigma2_related, PXB = P @ coordsB_batch, M1 = coordsA^T P
    coordsB_batch) as a dict, the same math as `get_P_core` plus the P-sums
    of the EM body.

    Routes: on a CUDA tensor, for 2-D coordinates, one 'gauss' layer of
    width <= 1024 and no sparse top-k, the two hand-written kernels
    (`ops/estep_cuda.py`; `use_kernel=False` opts out), whatever the size.
    Otherwise the JAX package's CPU route: the dense single pass when
    `n_chunks <= 1`, the column-chunked streaming pass when larger.

    `sparse_top_k > 0` is the reference's sparse calculation mode: P is cut
    to the top-k entries of each COLUMN before the M-step reductions; the
    normalisers and sigma2 statistics come from the dense P.

    With `shard` (`parallel._collectives.RowShard`), the [NA]-row inputs are
    one rank's rows of the moving slice: the per-column sums over the rows
    are added over the ranks before the normalisers use them, and K_NB, Sp,
    sigma2_related and M1 after; the per-row outputs are this rank's. The
    sparse top-k's threshold is the k-th largest value of each column over
    every rank's rows (`_column_kth`)."""
    NA, D = XAHat.shape
    B = coordsB_batch.shape[0]

    if (
        use_kernel
        and XAHat.device.type == "cuda"
        and D == 2
        and len(exp_a_rows) == 1
        and list(probability_type) == ["gauss"]
        and not sparse_top_k
        and exp_A_feats[0].shape[1] <= 1024
    ):
        from ...ops.estep_cuda import estep_cuda

        return estep_cuda(
            XAHat, coordsA, coordsB_batch,
            exp_a_rows[0], exp_b_batch[0], exp_A_feats[0], exp_B_batch[0],
            model_mul_vec, sigma2, gamma, samples_s, sigma2_variance,
            probability_parameters[0], eps=eps, shard=shard,
        )

    NA_total = NA if shard is None else shard.n
    k_sparse = min(int(sparse_top_k), NA_total) if sparse_top_k and sparse_top_k > 0 else 0
    outlier_s = samples_s * NA_total
    colsum = (lambda *c: shard.sum(torch.stack(c))[0]) if shard is not None else (lambda *c: torch.stack(c))
    spatial_outlier = torch.pow(2 * math.pi * sigma2, Dim / 2) * (1 - gamma) / (gamma * outlier_s)

    if n_chunks <= 1:
        b2d = torch.sum(coordsB_batch * coordsB_batch, dim=1)[None, :]
        d = torch.clamp_min(torch.sum(XAHat * XAHat, 1)[:, None] + b2d - 2.0 * (XAHat @ coordsB_batch.T), 0.0)
        prob_v = torch.exp(-d / (2 * sigma2 / sigma2_variance))
        prob_s = torch.exp(-d / (2 * sigma2))
        full = prob_s
        for l in range(len(exp_a_rows)):
            e_d = exp_a_rows[l][:, None] + exp_b_batch[l][None, :] + exp_A_feats[l] @ exp_B_batch[l].T
            full = full * calc_probability(e_d, probability_type[l], probability_parameters[l])
        mm = model_mul_vec[:, None]
        prob_v_m = prob_v * mm
        prob_s_m = prob_s * mm
        full_m = full * mm

        c1_raw, c1m, c2, c3 = colsum(prob_v.sum(0), prob_v_m.sum(0), prob_s_m.sum(0), full_m.sum(0))
        spatial_inlier = 1 - spatial_outlier / (spatial_outlier + c1_raw)
        P1 = prob_v_m / (spatial_outlier + c1m)[None, :]
        P2 = spatial_inlier[None, :] * prob_s_m / (c2 + eps)[None, :]
        P3 = spatial_inlier[None, :] * full_m / (c3 + eps)[None, :]
        if k_sparse and k_sparse < NA_total:
            P3 = torch.where(full_m >= _column_kth(full_m, k_sparse, shard)[None, :], P3, 0.0)
        PXB = P3 @ coordsB_batch
        out = dict(
            K_NA=P3.sum(1),
            K_NA_spatial=P1.sum(1),
            K_NA_sigma2=P2.sum(1),
            K_NB=P3.sum(0),
            Sp=P3.sum(),
            sigma2_related=(P2 * d).sum(),
            PXB=PXB,
            M1=coordsA.T @ PXB,
        )
        return _sum_columns(out, shard)

    # ---- chunked path: iterate over COLUMNS of the [NA, B] block. The
    # normalisers are per-column sums over the whole NA axis, so a column
    # chunk sees its full denominators at once: one streaming pass. ----
    Bc = -(-B // n_chunks)
    padB = Bc * n_chunks - B

    def pad_cols(x, fill=0.0):
        if padB == 0:
            return x
        pad = torch.full((padB,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, pad])

    # padded columns sit far away (prob 0); their normalisers degenerate to
    # the outlier-only denominator, giving exact zero contributions
    cB_p = pad_cols(coordsB_batch, 1e6).reshape(n_chunks, Bc, D)
    b_p = [pad_cols(b, 0.0).reshape(n_chunks, Bc) for b in exp_b_batch]
    B_p = [pad_cols(Bf, 0.0).reshape(n_chunks, Bc, -1) for Bf in exp_B_batch]

    a2 = torch.sum(XAHat * XAHat, dim=1)[:, None]
    mm_col = model_mul_vec[:, None]
    f32 = dict(dtype=torch.float32, device=XAHat.device)
    K_NA = torch.zeros(NA, **f32)
    K_NA_sp = torch.zeros(NA, **f32)
    K_NA_s2 = torch.zeros(NA, **f32)
    K_NB = torch.zeros(Bc * n_chunks, **f32)
    Sp = torch.zeros((), **f32)
    sig_rel = torch.zeros((), **f32)
    PXB = torch.zeros((NA, D), **f32)
    M1 = torch.zeros((D, D), **f32)
    for idx in range(n_chunks):
        cb = cB_p[idx]
        d = torch.clamp_min(a2 + torch.sum(cb * cb, 1)[None, :] - 2.0 * (XAHat @ cb.T), 0.0)
        prob_v = torch.exp(-d / (2 * sigma2 / sigma2_variance))
        prob_s = torch.exp(-d / (2 * sigma2))
        full = prob_s
        for l in range(len(exp_a_rows)):
            e_d = exp_a_rows[l][:, None] + b_p[l][idx][None, :] + exp_A_feats[l] @ B_p[l][idx].T
            full = full * calc_probability(e_d, probability_type[l], probability_parameters[l])
        prob_s_m, full_m, prob_v_m = prob_s * mm_col, full * mm_col, prob_v * mm_col
        c1_raw, c1m, c2, c3 = colsum(prob_v.sum(0), prob_v_m.sum(0), prob_s_m.sum(0), full_m.sum(0))
        spatial_inlier = 1 - spatial_outlier / (spatial_outlier + c1_raw)
        P1 = prob_v_m / (spatial_outlier + c1m)[None, :]
        P2 = spatial_inlier[None, :] * prob_s_m / (c2 + eps)[None, :]
        P3 = spatial_inlier[None, :] * full_m / (c3 + eps)[None, :]
        if k_sparse and k_sparse < NA_total:
            P3 = torch.where(full_m >= _column_kth(full_m, k_sparse, shard)[None, :], P3, 0.0)
        K_NA = K_NA + P3.sum(1)
        K_NA_sp = K_NA_sp + P1.sum(1)
        K_NA_s2 = K_NA_s2 + P2.sum(1)
        K_NB[idx * Bc:(idx + 1) * Bc] = P3.sum(0)
        Sp = Sp + P3.sum()
        sig_rel = sig_rel + (P2 * d).sum()
        pxb = P3 @ cb
        PXB = PXB + pxb
        M1 = M1 + coordsA.T @ pxb
    return _sum_columns(dict(
        K_NA=K_NA,
        K_NA_spatial=K_NA_sp,
        K_NA_sigma2=K_NA_s2,
        K_NB=K_NB[:B],
        Sp=Sp,
        sigma2_related=sig_rel,
        PXB=PXB,
        M1=M1,
    ), shard)


def _column_kth(full_m: torch.Tensor, k: int, shard) -> torch.Tensor:
    """[B]: the k-th largest value of each column of `full_m` over all its
    rows, and with `shard` over every rank's rows: each rank's top
    min(k, rows) values of a column (padded with -inf) meet the other ranks'
    in one [world, B, k] stack, and a second top-k over those world * k
    candidates picks the same value on every rank."""
    if shard is None:
        return torch.topk(full_m, k, dim=0).values[-1]
    rows, B = full_m.shape
    local = torch.full((B, k), float("-inf"), dtype=full_m.dtype, device=full_m.device)
    kl = min(k, rows)
    if kl:
        local[:, :kl] = torch.topk(full_m, kl, dim=0).values.T
    cand = shard.stack(local).permute(1, 0, 2).reshape(B, -1)  # [B, world * k]
    return torch.topk(cand, k, dim=1).values[:, -1]


def _sum_columns(out: dict, shard) -> dict:
    """The E-step's sums over the moving slice's rows (K_NB, Sp,
    sigma2_related, M1) added over the ranks of `shard`, in one collective."""
    if shard is None:
        return out
    keys = ("K_NB", "Sp", "sigma2_related", "M1")
    out.update(zip(keys, shard.sum(*(out[k] for k in keys))))
    return out
