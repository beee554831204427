"""The port's OT solvers (`spateo_tpu_torch.ops.ot`, the batched Sinkhorn of
`spateo_tpu_torch.svg.utils`) against the JAX package's on the CPU.

Both packages compute in float32. The JAX loops return no iteration count,
so each test checks the port's count n against the JAX function rerun with
limits n and n - 1 (one block less for the batched scan): the first result
must be bit-identical to the unlimited run's and the second must not (the
loop stops at n, and an earlier stop changes the result). The port's
`_*_run` helpers return their counts.

Bars:

- Sinkhorn plans and batched scores: 1e-5 of scale, equal stop iterations
  (measured 2.8e-6 and 1.0e-6).
- `sinkhorn_log` at its default tol 1e-9 stops where g stops changing in
  float32 (1e-9 is below one ulp of g), and when that happens is set by
  rounding: 496 iterations in the port and 511 in the JAX package on
  `test_sinkhorn_log_default_tol_is_set_by_rounding`'s problem. Its counts
  are compared at tolerances above the rounding floor; the plans at the
  default.
- Entropic FGW at alpha 0.1: objective 5e-5 relative, plan 5e-5 of scale
  (measured <= 1.2e-7 and 1.6e-6). Pure GW (alpha 1): objective 5e-5
  relative (measured <= 2.6e-5); the plan to 1e-3 of scale, because a
  float32 GW plan moves by 6e-5-3.8e-4 of its scale in the port itself when
  C1 moves by one ulp (measured over the three seeds of
  `test_fgw_entropic_matches_jax`), and by up to 4.1e-4 against the JAX
  package.
- Exact solvers (host float64 LPs): plans equal to 1e-9. `fgw_exact` forms
  constC in float32 as the JAX package does; XLA's and torch's float32
  matrix-vector sums round differently in the last bit, so its objective is
  held to 1e-9 relative on integer costs (where that sum is exact) and to
  1e-6 of its terms' scale on real-valued costs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist

from spateo_tpu.ops import ot as jot
from spateo_tpu.svg import utils as jsu
from spateo_tpu_torch.ops import ot as tot
from spateo_tpu_torch.svg import utils as tsu

PLAN_TOL = 1e-5
FGW_TOL = 5e-5
GW_PLAN_TOL = 1e-3


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _jax_stops_at(run, n, ref, step=1):
    """Whether the JAX loop `run(limit)` stops at n: limited to n it gives
    `ref`, limited to n - step it does not."""
    same = np.array_equal(np.asarray(run(n)), ref)
    return same and (n <= step or not np.array_equal(np.asarray(run(n - step)), ref))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU among its
    workers, where torch's thread pools only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ot_problem(n=60, seed=0, zero_bins=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, (n, 2))
    M = cdist(x, x).astype(np.float32)
    M /= M.max()
    a = rng.dirichlet(np.ones(n)).astype(np.float32)
    b = rng.dirichlet(np.ones(n)).astype(np.float32)
    b[:zero_bins] = 0
    return a, (b / b.sum()).astype(np.float32), M


@pytest.mark.parametrize("tol,zero_bins", [(1e-5, 0), (1e-6, 0), (1e-9, 5)])
def test_sinkhorn_log_matches_jax(tol, zero_bins):
    """Plans to 1e-5 of scale and equal iteration counts. A target with zero
    bins makes log(b + 1e-300) -inf in float32 (1e-300 rounds to 0), g -inf
    there, and the second stop test NaN: both packages stop after 2
    iterations."""
    a, b, M = _ot_problem(zero_bins=zero_bins)
    ref = np.asarray(jot.sinkhorn_log(*_j(a, b, M), 1e-2, 1000, tol))
    T, it = tot._sinkhorn_log_run(*_t(a, b, M), 1e-2, 1000, tol)
    assert _scaled(T, ref) <= PLAN_TOL
    assert _jax_stops_at(lambda k: jot.sinkhorn_log(*_j(a, b, M), 1e-2, k, tol), it, ref)
    if zero_bins:
        assert it == 2 and np.all(T.numpy()[:, :zero_bins] == 0)


def test_sinkhorn_log_host_reads_once_a_block():
    """The stop flag is read once per `CHECK_EVERY` iterations, and the state
    is frozen after the stop (the plan equals a run limited to the count)."""
    a, b, M = _ot_problem()
    before = tot._sinkhorn_log_run.host_reads
    T, it = tot._sinkhorn_log_run(*_t(a, b, M), 1e-2, 1000, 1e-5)
    assert tot._sinkhorn_log_run.host_reads - before == -(-it // tot.CHECK_EVERY)
    T2, it2 = tot._sinkhorn_log_run(*_t(a, b, M), 1e-2, it, 0.0)
    assert it2 == it and torch.equal(T, T2)


def test_sinkhorn_log_default_tol_is_set_by_rounding():
    """At tol 1e-9 both packages run until g stops changing in float32; the
    plans agree to 1e-5 of scale, the counts only up to rounding (496 and
    511 here, measured)."""
    a, b, M = _ot_problem()
    ref = np.asarray(jot.sinkhorn_log(*_j(a, b, M)))
    assert _scaled(tot.sinkhorn_log(*_t(a, b, M)), ref) <= PLAN_TOL
    assert tot.sinkhorn_distance(a, b, M, device="cpu") == pytest.approx(jot.sinkhorn_distance(a, b, M), rel=PLAN_TOL)


def _scan_problem(N=64, G=16, seed=0, zero_bins=0, unit_cost=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, (N, 2))
    M = cdist(x, x).astype(np.float32)
    if unit_cost:
        M /= M.max()
    A = rng.dirichlet(np.ones(N) * 0.5, G).astype(np.float32)
    b = rng.dirichlet(np.ones(N)).astype(np.float32)
    b[:zero_bins] = 0
    return A, (b / b.sum()).astype(np.float32), M


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("eps_scale,zero_bins,unit_cost,expect", [(5e-3, 0, False, 200), (0.05, 0, True, None),
                                                                  (0.1, 0, True, None), (5e-3, 3, False, 20)])
def test_sinkhorn_batch_kernel_matches_jax(seed, eps_scale, zero_bins, unit_cost, expect):
    """Scores to 1e-5 relative and the same number of sweeps: all 200 at the
    scan's default eps (5e-3 of max M), fewer at a larger eps on unit costs
    (the block test passes; 30-190 sweeps), and exactly 20 when the target
    has zero bins (the second block's test is NaN). Where g itself is large
    (eps of 0.2-1 x max M on costs of 14), one ulp of g reaches the 1e-6 bar
    and the stop is set by rounding in either package: 30-60 sweeps in the
    port against 10-30 in the JAX package, measured; no count is compared
    there."""
    A, b, M = _scan_problem(seed=seed, zero_bins=zero_bins, unit_cost=unit_cost)
    eps = float(M.max() * eps_scale)
    ref = np.asarray(jsu._sinkhorn_batch_kernel(*_j(A, b, M), eps, 200))
    d, it = tsu._sinkhorn_batch_run(*_t(A, b, M), eps, 200)
    assert _scaled(d, ref) <= PLAN_TOL
    assert _jax_stops_at(lambda k: jsu._sinkhorn_batch_kernel(*_j(A, b, M), eps, k), it, ref, step=10)
    if expect is not None:
        assert it == expect
    else:
        assert it < 200


def test_zero_bin_target_scores_are_the_20_sweep_scores():
    """The NaN stop is part of the semantics: with zero target bins the scan
    stops after 20 sweeps, so n_iter 20 and 200 give identical scores in
    both packages."""
    A, b, M = _scan_problem(zero_bins=3)
    eps = float(M.max() * 5e-3)
    d20 = tsu._sinkhorn_batch_kernel(*_t(A, b, M), eps, 20)
    d200 = tsu._sinkhorn_batch_kernel(*_t(A, b, M), eps, 200)
    assert torch.equal(d20, d200)
    assert np.array_equal(np.asarray(jsu._sinkhorn_batch_kernel(*_j(A, b, M), eps, 20)),
                          np.asarray(jsu._sinkhorn_batch_kernel(*_j(A, b, M), eps, 200)))


@pytest.mark.parametrize("G,chunk", [(21, 8), (30, None), (5, 16)])
def test_cal_wass_dis_batch_ragged_chunks(G, chunk):
    """The scan over chunks with a ragged, padded last chunk equals the JAX
    package's to 1e-5 relative; the chunk size is the JAX formula."""
    A, b, M = _scan_problem(G=G, seed=3)
    ref = jsu.cal_wass_dis_batch(M, A, b=b, chunk=chunk)
    out = tsu.cal_wass_dis_batch(M, A, b=b, chunk=chunk, device="cpu")
    assert out.shape == (G,) and _scaled(out, ref) <= PLAN_TOL
    uniform = tsu.cal_wass_dis_batch(M, A, chunk=chunk, device="cpu")
    assert _scaled(uniform, jsu.cal_wass_dis_batch(M, A, chunk=chunk)) <= PLAN_TOL
    assert tsu.cal_wass_dis(M, A[0], device="cpu") == pytest.approx(jsu.cal_wass_dis(M, A[0]), rel=PLAN_TOL)


@pytest.mark.parametrize("N,G,chunk,expect", [(400, 4000, None, 784), (64, 16, None, 16), (64, 21, 8, 8),
                                              (1000, 10, None, 16), (400, 5, None, 8)])
def test_scan_chunk_formula(N, G, chunk, expect):
    """[chunk, N, N] under ~0.5 GB, rounded up to a multiple of 8."""
    assert tsu.scan_chunk(N, G, chunk) == expect


def _fgw_problem(seed, n=100, m=90):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(0, 1, (n, 2)), rng.uniform(0, 1, (m, 2))
    C1, C2 = cdist(x, x).astype(np.float32), cdist(y, y).astype(np.float32)
    M = rng.uniform(0, 1, (n, m)).astype(np.float32)
    a = rng.dirichlet(np.ones(n) * 5).astype(np.float32)
    b = rng.dirichlet(np.ones(m) * 5).astype(np.float32)
    return M, C1, C2, a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("alpha", [0.1, 1.0])
def test_fgw_entropic_matches_jax(seed, alpha):
    """30 outer iterations of 100 inner sweeps at the package's eps (5e-3
    for FGW, the between-slice scan's max(C) / 100 for GW)."""
    M, C1, C2, a, b = _fgw_problem(seed)
    eps = 5e-3 if alpha < 1 else max(float(C1.max()) * 1e-2, 1e-4)
    Tj, oj = jot.fgw_entropic(*_j(M, C1, C2, a, b), alpha=alpha, eps=eps, outer_iter=30)
    T, obj, it = tot._fgw_entropic_run(*_t(M, C1, C2, a, b), alpha, eps, 30, 100, 1e-8)
    assert abs(float(obj) - float(oj)) <= FGW_TOL * abs(float(oj))
    assert _scaled(T, Tj) <= (FGW_TOL if alpha < 1 else GW_PLAN_TOL)
    assert it == 30


@pytest.mark.parametrize("alpha,tol", [(0.1, 1e-5), (1.0, 1e-4)])
def test_fgw_entropic_stops_with_jax(alpha, tol):
    """Where the outer test passes before the limit, both packages stop at
    the same outer iteration (88 of 100 here). The mirror-descent plan keeps
    sharpening, so at the default tol 1e-8 the loop runs to its limit in
    both packages."""
    M, C1, C2, a, b = _fgw_problem(4, n=50, m=40)
    eps = 5e-2
    Tj, _ = jot.fgw_entropic(*_j(M, C1, C2, a, b), alpha=alpha, eps=eps, outer_iter=100, tol=tol)
    T, _, it = tot._fgw_entropic_run(*_t(M, C1, C2, a, b), alpha, eps, 100, 100, tol)
    assert it < 100 and _jax_stops_at(
        lambda k: jot.fgw_entropic(*_j(M, C1, C2, a, b), alpha=alpha, eps=eps, outer_iter=k, tol=tol)[0], it,
        np.asarray(Tj))


def test_fgw_ignores_G_init_as_jax_does():
    """`fgw` accepts G_init and does not use it (the JAX package never passes
    it on); the plan and objective match the JAX wrapper's."""
    M, C1, C2, a, b = _fgw_problem(0, n=40, m=30)
    G = np.random.default_rng(1).uniform(size=(40, 30))
    T, obj = tot.fgw(M, C1, C2, a, b, alpha=0.1, max_iter=20, device="cpu")
    T2, obj2 = tot.fgw(M, C1, C2, a, b, alpha=0.1, max_iter=20, G_init=G, device="cpu")
    assert np.array_equal(T, T2) and obj == obj2
    Tj, oj = jot.fgw(M, C1, C2, a, b, alpha=0.1, max_iter=20, G_init=G)
    assert _scaled(T, Tj) <= FGW_TOL and abs(obj - oj) <= FGW_TOL * abs(oj)


def test_emd_exact_matches_jax():
    rng = np.random.default_rng(0)
    Mx = rng.uniform(0, 1, (30, 25))
    a, b = rng.dirichlet(np.ones(30)), rng.dirichlet(np.ones(25))
    T = tot.emd_exact(a, b, Mx)
    np.testing.assert_allclose(T, jot.emd_exact(a, b, Mx), atol=1e-9)
    np.testing.assert_allclose(T.sum(1), a, atol=1e-9)
    assert tsu.cal_wass_dis_exact(Mx, a, b) == pytest.approx(jsu.cal_wass_dis_exact(Mx, a, b), rel=1e-9)
    n = int(np.sqrt(tot.EMD_EXACT_MAX_VARIABLES)) + 10
    with pytest.raises(ValueError, match="sinkhorn"):
        tot.emd_exact(np.ones(n) / n, np.ones(n) / n, np.zeros((n, n), np.float32))


@pytest.mark.parametrize("integer_costs", [True, False])
def test_fgw_exact_matches_jax(integer_costs):
    """Frank-Wolfe FGW with LP subproblems: plans equal to 1e-9. On integer
    costs with 1/32 weights constC's float32 sums are exact in both packages
    and the objectives agree to 1e-9 relative; on real-valued costs they
    differ by constC's last-bit rounding, held to 1e-6 of the terms' scale."""
    rng = np.random.default_rng(2)
    n = 32
    x = rng.uniform(0, 6, (n, 2))
    y = x + rng.normal(0, 0.3, (n, 2))
    C1, C2 = cdist(x, x), cdist(y, y)
    if integer_costs:
        C1, C2 = np.round(C1), np.round(C2)
    M = rng.uniform(0, 1, (n, n))
    G = np.full((n, n), 1.0 / n**2)
    Tj, oj = jot.fgw_exact(M, C1, C2, alpha=0.1, G_init=G, max_iter=20)
    T, obj = tot.fgw_exact(M, C1, C2, alpha=0.1, G_init=G, max_iter=20)
    np.testing.assert_allclose(T, Tj, atol=1e-9)
    if integer_costs:
        assert obj == pytest.approx(oj, rel=1e-9)
    else:
        const = (C1**2).mean() + (C2**2).mean()
        assert abs(obj - oj) <= 1e-6 * 0.1 * const


def test_zero_bin_stop_leaves_scores_short_of_convergence():
    """The JAX package's fault that the port keeps (ROADMAP Queue 3): with
    zero target bins the scan stops after 20 sweeps, far from the plan
    Sinkhorn converges to once those bins are dropped. Measured on
    `_scan_problem(seed=0, zero_bins=3)`'s 16 genes: the 20-sweep scores are
    0.43-0.82 (median 0.63) of `sinkhorn_log`'s after up to 5,000
    iterations; here on its first 4 genes, and the same in both packages."""
    A, b, M = _scan_problem(seed=0, zero_bins=3)
    A = A[:4]
    eps = float(M.max() * 5e-3)
    short = tsu._sinkhorn_batch_kernel(*_t(A, b, M), eps, 200).numpy()
    assert _scaled(short, np.asarray(jsu._sinkhorn_batch_kernel(*_j(A, b, M), eps, 200))) <= PLAN_TOL
    keep = b > 0
    Mk = np.ascontiguousarray(M[:, keep])
    full = np.array([float(torch.sum(tot.sinkhorn_log(*_t(a, b[keep], Mk), eps, 5000) * torch.from_numpy(Mk)))
                     for a in A])
    assert np.all(short / full < 0.9)
