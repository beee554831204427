"""Optimal transport on the device: log-domain Sinkhorn, the batched Sinkhorn
gene scan's solver, entropic (F)GW, and the exact host solvers (counterpart of
`spateo_tpu.ops.ot`, function for function).

Plain PyTorch; no TPU kernel lies under these solvers (the JAX package runs
them as XLA while loops). Everything stays in float32, as the JAX package does
with x64 off: ``1e-300`` rounds to 0 there, so ``log(x + 1e-300)`` is ``-inf``
where x is 0 in both packages, and a target bin of 0 makes the stop test NaN
(``-inf - -inf``), which stops the loop (``NaN > tol`` is false). The stop
rules and iteration counts are the JAX package's:

- `sinkhorn_log` tests ``max|g_new - g| > tol`` before every iteration. The
  port runs blocks of `CHECK_EVERY` iterations on the device with a stop flag
  that freezes the state once the test fails, and reads the flag once a block.
- `fgw_entropic` tests ``max|T_new - T| > tol`` once an outer iteration (one
  host read each); its inner Sinkhorn loop is a fixed ``inner_iter`` sweeps.

`emd_exact` and `fgw_exact` are the JAX package's host LP solvers (scipy
HiGHS), copied.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..alignment.methods.math import as_tensor

#: Iterations of `sinkhorn_log` between two host reads of its stop flag.
CHECK_EVERY = 10


def _sinkhorn_log_run(a, b, M, eps: float, max_iter: int, tol: float):
    """`sinkhorn_log`'s loop: the plan and the iterations run."""
    log_a = torch.log(a + 1e-300)
    log_b = torch.log(b + 1e-300)
    Mk = -M / eps
    f, g = torch.zeros_like(a), torch.zeros_like(b)
    it = torch.zeros((), dtype=torch.int32, device=a.device)
    err = torch.full((), float("inf"), dtype=a.dtype, device=a.device)
    while True:
        for _ in range(CHECK_EVERY):
            live = (it < max_iter) & (err > tol)
            f_new = eps * (log_a - torch.logsumexp(Mk + g[None, :] / eps, dim=1))
            g_new = eps * (log_b - torch.logsumexp(Mk + f_new[:, None] / eps, dim=0))
            err_new = torch.amax(torch.abs(g_new - g))  # NaN propagates, as jnp.max
            f = torch.where(live, f_new, f)
            g = torch.where(live, g_new, g)
            err = torch.where(live, err_new, err)
            it = it + live.to(it.dtype)
        _sinkhorn_log_run.host_reads += 1
        if not bool((it < max_iter) & (err > tol)):
            break
    return torch.exp(Mk + f[:, None] / eps + g[None, :] / eps), int(it)


_sinkhorn_log_run.host_reads = 0


def sinkhorn_log(a, b, M, eps: float = 1e-2, max_iter: int = 1000, tol: float = 1e-9) -> torch.Tensor:
    """Entropic OT plan via log-domain Sinkhorn (stable for small eps), on the
    device of the inputs."""
    return _sinkhorn_log_run(a, b, M, eps, max_iter, tol)[0]


def sinkhorn_distance(a, b, M, eps: float = 1e-2, max_iter: int = 1000, device="cuda") -> float:
    """<T, M> under the entropic plan (eps-approximation of emd2)."""
    a, b, M = (as_tensor(x, device) for x in (a, b, M))
    T = sinkhorn_log(a, b, M, eps, max_iter)
    return float(torch.sum(T * M))


def _gw_const(C1, C2, a, b):
    """constC for the square loss decomposition (Peyre et al. 2016):
    L(C1, C2) (x) T = constC - 2 C1 T C2^T for marginal-feasible T."""
    constC1 = ((C1**2) @ a[:, None]) @ torch.ones_like(b)[None, :]
    constC2 = torch.ones_like(a)[:, None] @ (b[None, :] @ (C2**2).T)
    return constC1 + constC2


def _fgw_entropic_run(M, C1, C2, a, b, alpha, eps, outer_iter, inner_iter, tol):
    """`fgw_entropic`'s loop: the plan, the objective and the outer
    iterations run."""
    constC = _gw_const(C1, C2, a, b)
    T = a[:, None] * b[None, :]
    log_a = torch.log(a + 1e-300)
    log_b = torch.log(b + 1e-300)

    def gw_terms(T):
        return constC - 2.0 * (C1 @ T @ C2.T)

    it = 0
    err = torch.full((), float("inf"), dtype=a.dtype, device=a.device)
    while it < outer_iter and bool(err > tol):
        grad = (1 - alpha) * M + 2.0 * alpha * gw_terms(T)
        # mirror step: kernel = log T - grad/eps, then Sinkhorn projection
        logK = torch.log(T + 1e-300) - grad / eps
        f, g = torch.zeros_like(a), torch.zeros_like(b)
        for _ in range(inner_iter):
            f = log_a - torch.logsumexp(logK + g[None, :], dim=1)
            g = log_b - torch.logsumexp(logK + f[:, None], dim=0)
        T_new = torch.exp(logK + f[:, None] + g[None, :])
        err = torch.amax(torch.abs(T_new - T))
        T = T_new
        it += 1
    obj = (1 - alpha) * torch.sum(M * T) + alpha * torch.sum(gw_terms(T) * T)
    return T, obj, it


def fgw_entropic(
    M: torch.Tensor,
    C1: torch.Tensor,
    C2: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    alpha: float = 0.1,
    eps: float = 5e-3,
    outer_iter: int = 100,
    inner_iter: int = 100,
    tol: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entropic-proximal fused Gromov-Wasserstein, on the device of the inputs.

    Mirror-descent outer loop: T <- Sinkhorn-projection of
    T * exp(-grad/eps), where grad = (1-alpha) M + 2 alpha (constC - 2 C1 T C2^T).
    Returns (T, fgw_objective) as device tensors.
    """
    T, obj, _ = _fgw_entropic_run(M, C1, C2, a, b, alpha, eps, outer_iter, inner_iter, tol)
    return T, obj


#: emd_exact size envelope: the LP has n*m variables and n+m-1 equality
#: constraints; scipy's HiGHS handles a few hundred support points per side
#: in seconds, but not thousands.
EMD_EXACT_MAX_VARIABLES = 1_000_000  # n*m cap (~1000x1000)


def emd_exact(a: np.ndarray, b: np.ndarray, M: np.ndarray) -> np.ndarray:
    """EXACT optimal transport plan via linear programming (scipy HiGHS), on
    the host. For validation-size problems (n*m <= EMD_EXACT_MAX_VARIABLES);
    larger problems take the entropic `sinkhorn_log` / `fgw` device path.
    Returns the [n, m] plan."""
    from scipy.optimize import linprog
    from scipy.sparse import coo_matrix, vstack

    M = np.asarray(M, float)
    n, m = M.shape
    if n * m > EMD_EXACT_MAX_VARIABLES:
        raise ValueError(
            f"emd_exact: problem size {n}x{m} = {n * m} LP variables exceeds the "
            f"{EMD_EXACT_MAX_VARIABLES}-variable envelope of the scipy/HiGHS dense-LP "
            "formulation. Use the entropic device path instead: spateo_tpu_torch.ops.ot.sinkhorn_log "
            "(or fgw for fused GW), which handles thousands of points on the GPU."
        )
    a = np.asarray(a, float).ravel()
    b = np.asarray(b, float).ravel()
    a = a / a.sum()
    b = b / b.sum()
    rows_i = np.repeat(np.arange(n), m)
    cols_j = np.tile(np.arange(m), n)
    var = np.arange(n * m)
    A_rows = coo_matrix((np.ones(n * m), (rows_i, var)), shape=(n, n * m))
    keep = cols_j < m - 1  # last column constraint is implied
    A_cols = coo_matrix((np.ones(int(keep.sum())), (cols_j[keep], var[keep])), shape=(m - 1, n * m))
    A_eq = vstack([A_rows, A_cols]).tocsr()
    b_eq = np.concatenate([a, b[:-1]])
    res = linprog(M.ravel(), A_eq=A_eq, b_eq=b_eq, bounds=(0, None), method="highs")
    if not res.success:
        raise RuntimeError(f"exact EMD LP failed: {res.message}")
    return res.x.reshape(n, m)


def fgw_exact(
    M: np.ndarray,
    C1: np.ndarray,
    C2: np.ndarray,
    a: Optional[np.ndarray] = None,
    b: Optional[np.ndarray] = None,
    alpha: float = 0.1,
    G_init: Optional[np.ndarray] = None,
    max_iter: int = 100,
    tol: float = 1e-9,
) -> Tuple[np.ndarray, float]:
    """Exact fused Gromov-Wasserstein by conditional gradient (Frank-Wolfe)
    with EXACT EMD linear subproblems (`emd_exact`), on the host, for small
    pairs; `fgw` is the entropic device path. ``constC`` is formed in float32,
    as the JAX package forms it; the rest runs in float64."""
    M = np.asarray(M, float)
    C1 = np.asarray(C1, float)
    C2 = np.asarray(C2, float)
    n, m = M.shape
    a = np.ones(n) / n if a is None else np.asarray(a, float)
    b = np.ones(m) / m if b is None else np.asarray(b, float)
    constC = _gw_const(*(as_tensor(x) for x in (C1, C2, a, b))).numpy()
    T = np.outer(a, b) if G_init is None else np.asarray(G_init, float)

    def tens_of(T):
        return constC - 2.0 * (C1 @ T @ C2.T)

    def obj_of(T, tens):
        return (1 - alpha) * float((M * T).sum()) + alpha * float((tens * T).sum())

    tens = tens_of(T)
    f_val = obj_of(T, tens)
    for _ in range(max_iter):
        grad = (1 - alpha) * M + 2.0 * alpha * tens
        T_fw = emd_exact(a, b, grad)
        delta = T_fw - T
        # exact line search of the quadratic objective along delta
        dot = C1 @ delta @ C2.T
        a_coef = -2.0 * alpha * float((dot * delta).sum())
        b_coef = float(((1 - alpha) * M * delta).sum()) + 2.0 * alpha * float((tens * delta).sum())
        if a_coef > 0:
            t = np.clip(-b_coef / (2 * a_coef), 0.0, 1.0)
        else:
            t = 1.0 if (a_coef + b_coef) < 0 else 0.0
        if t <= 0:
            break
        T = T + t * delta
        tens = tens_of(T)
        f_new = obj_of(T, tens)
        if abs(f_val - f_new) < tol:
            f_val = f_new
            break
        f_val = f_new
    return T, f_val


def fgw(
    M,
    C1,
    C2,
    a: Optional[np.ndarray] = None,
    b: Optional[np.ndarray] = None,
    alpha: float = 0.1,
    eps: float = 5e-3,
    G_init: Optional[np.ndarray] = None,
    max_iter: int = 100,
    device="cuda",
) -> Tuple[np.ndarray, float]:
    """Host-facing FGW wrapper returning (plan, objective). The inputs (host
    arrays or tensors) go to `device` in float32. ``G_init`` is accepted and,
    as in the JAX package, not used: the entropic loop starts from a b^T."""
    n, m = M.shape
    a = np.ones(n) / n if a is None else a
    b = np.ones(m) / m if b is None else b
    M, C1, C2, a, b = (as_tensor(x, device).to(torch.float32) for x in (M, C1, C2, a, b))
    T, obj = fgw_entropic(M, C1, C2, a, b, alpha=alpha, eps=eps, outer_iter=max_iter)
    return T.cpu().numpy(), float(obj)
