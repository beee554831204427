"""How the port's redesigned kernels cut their work, checked on the CPU.

The kernels run only on the card, but the rules they follow to divide work
are plain index arithmetic, mirrored here:

- sweep 1 of the E-step (`csrc/estep.cu` `colnorm_kernel`): each column
  tile's live row tiles (by the bounding-box mask) are listed in order and
  the k-th goes to split k % S; `estep_cuda.colnorm_assignment` states the
  rule, and `_kernel_lists` below replays the kernel's own ballot-and-prefix
  construction of the lists, 256 row tiles at a time;
- the coarse fit (`csrc/inlier.cu`): `inlier_cuda.inlier_layout` splits N
  rows over the cluster's ranks, each thread holding some in registers and
  walking the rest from global memory; `_inlier_rows` replays the kernel's
  index arithmetic.
"""

import numpy as np
import pytest
import torch

from spateo_tpu_torch.ops import estep_cuda, inlier_cuda

SMEM_PER_BLOCK = 232_448  # bytes an H100 block may use


def _mask(kind, n_ta, n_tb, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        m = rng.uniform(size=(n_ta, n_tb)) < 0.6
    elif kind == "all_skip":
        m = np.ones((n_ta, n_tb), bool)
    elif kind == "no_skip":
        m = np.zeros((n_ta, n_tb), bool)
    else:  # "band": Morton-like, each column tile's live rows in one narrow run
        m = np.ones((n_ta, n_tb), bool)
        width = max(1, n_ta // 10)
        for jt in range(n_tb):
            start = (jt * n_ta) // n_tb
            m[start:start + width, jt] = False
    return torch.from_numpy(m.astype(np.uint8).reshape(-1))


def _kernel_lists(skip, n_ta, n_tb, S, NT=256):
    """The kernel's list construction, thread by thread: NT row tiles at a
    time, a warp ballot of the live ones, each live tile's index k from the
    running count, the warps before it and the lanes before it; split s
    keeps list[k // S] = it when k % S == s."""
    live = (skip.numpy().reshape(n_ta, n_tb) == 0)
    lists = [[{} for _ in range(S)] for _ in range(n_tb)]
    for jt in range(n_tb):
        n_live = 0
        for base in range(0, n_ta, NT):
            lv = [base + t < n_ta and bool(live[base + t, jt]) for t in range(NT)]
            warp_counts = [sum(lv[w * 32:(w + 1) * 32]) for w in range(NT // 32)]
            for t in range(NT):
                if not lv[t]:
                    continue
                w, lane = divmod(t, 32)
                k = n_live + sum(warp_counts[:w]) + sum(lv[w * 32:w * 32 + lane])
                lists[jt][k % S][k // S] = base + t
            n_live += sum(warp_counts)
    return [[[d[i] for i in range(len(d))] for d in per] for per in lists]


@pytest.mark.parametrize("kind", ["random", "all_skip", "no_skip", "band"])
@pytest.mark.parametrize("NA,B", [(1000, 333), (20000, 2000), (30000, 700), (100000, 10000)])
def test_colnorm_deals_each_live_tile_to_one_split(kind, NA, B):
    """Every live row tile of a column tile is computed by exactly one of
    its splits, no skipped tile is, the splits' counts differ by at most
    one, and each block's list fits the shared memory the entry reserves
    (ceil(n_ta / S) ints)."""
    n_ta, n_tb = -(-NA // estep_cuda.TM), -(-B // estep_cuda.TN)
    skip = _mask(kind, n_ta, n_tb, seed=NA + B)
    S = estep_cuda.colnorm_splits(NA, B)
    assert 1 <= S <= max(n_ta, 1)
    live = skip.numpy().reshape(n_ta, n_tb) == 0
    assignment = estep_cuda.colnorm_assignment(skip, NA, B, S)
    assert len(assignment) == n_tb
    for jt, per_split in enumerate(assignment):
        assert len(per_split) == S
        taken = sorted(it for tiles in per_split for it in tiles)
        assert taken == list(np.flatnonzero(live[:, jt]))
        counts = [len(tiles) for tiles in per_split]
        assert max(counts) - min(counts) <= 1
        assert max(counts) <= -(-n_ta // S)


@pytest.mark.parametrize("kind", ["random", "band"])
@pytest.mark.parametrize("NA,B,S", [(1000, 333, 3), (40000, 130, 7), (20000, 2000, 33)])
def test_colnorm_kernel_list_construction_follows_the_rule(kind, NA, B, S):
    """The kernel's ballot-and-prefix construction (two rounds of 256 row
    tiles and more) gives exactly `colnorm_assignment`'s lists, in order."""
    n_ta, n_tb = -(-NA // estep_cuda.TM), -(-B // estep_cuda.TN)
    skip = _mask(kind, n_ta, n_tb, seed=S)
    assert _kernel_lists(skip, n_ta, n_tb, S) == estep_cuda.colnorm_assignment(skip, NA, B, S)


def _ring_bytes(G1, extra, n_list, RK=64, RLD=68, stages=3):
    """`RingLayout(G1, extra).bytes(n_list)` of csrc/estep.cu."""
    kr = min((G1 + 3) // 4 * 4, RK)
    res = G1 <= RK
    stage = kr * RLD + extra + (0 if res else kr * RLD)
    return 4 * ((kr * RLD if res else 0) + stages * stage + n_list)


@pytest.mark.parametrize("G1", [19, 51, 101, 501])
@pytest.mark.parametrize("NA,B", [(1000, 333), (100000, 10000), (2_000_000, 2000), (600_000, 60_000)])
def test_colnorm_splits_fit_shared_memory(G1, NA, B):
    """At any size, the splits keep each block's list within
    `_COLNORM_MAX_LIST` and the block's shared memory within the card's
    limit; the block target is reached where the rows allow it."""
    n_ta, n_tb = -(-NA // estep_cuda.TM), -(-B // estep_cuda.TN)
    S = estep_cuda.colnorm_splits(NA, B)
    n_list = -(-n_ta // S)
    assert n_list <= estep_cuda._COLNORM_MAX_LIST
    assert _ring_bytes(G1, 3 * estep_cuda.TM, n_list) <= SMEM_PER_BLOCK
    assert n_tb * S >= min(estep_cuda._COLNORM_BLOCKS, n_tb * n_ta)


def _inlier_rows(N, C, NT, RPT, per):
    """How often the kernel visits each row: rank r owns [lo, hi), thread t
    holds lo + t + k NT (k < RPT, below hi) in registers and walks
    lo + RPT NT + t, + NT, ... below hi from global memory. Returns the
    visit counts and the number held in registers."""
    seen = np.zeros(N, np.int64)
    on_chip = 0
    for r in range(C):
        lo = min(N, r * per)
        hi = min(N, lo + per)
        t = np.arange(NT)
        n_reg = np.where(hi - lo > t, np.minimum(RPT, (hi - lo - t + NT - 1) // NT), 0)
        for k in range(RPT):
            rows = (lo + t + k * NT)[k < n_reg]
            np.add.at(seen, rows, 1)
            on_chip += rows.size
        g0 = lo + RPT * NT
        if g0 < hi:
            np.add.at(seen, np.arange(g0, hi), 1)
    return seen, on_chip


@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
@pytest.mark.parametrize("N", [1, 2, 31, 33, 255, 256, 257, 2048, 4097, 20480, 32768, 32769, 200_000])
def test_inlier_layout_covers_every_row_once(N, cluster):
    """Every row is visited exactly once per pass, the rows a thread holds
    are 1 to 8 for 256 or 512 threads, and every row is held in registers
    whenever 8 rows a thread of 512 threads hold a rank's run."""
    C, NT, RPT, per = inlier_cuda.inlier_layout(N, cluster)
    assert C == cluster and NT in (256, 512) and 1 <= RPT <= 8 and per == -(-N // C)
    seen, on_chip = _inlier_rows(N, C, NT, RPT, per)
    assert (seen == 1).all()
    runs = [min(N, r * per + per) - min(N, r * per) for r in range(C)]
    assert on_chip == sum(min(run, RPT * NT) for run in runs)
    if per <= 8 * 512:
        assert on_chip == N


def test_inlier_layout_of_the_main_path():
    """The 20k pair's 20,480 NN matches: one cluster of 16 blocks of 256
    threads, 5 rows each, all in registers; other sizes and threads are
    refused before any launch."""
    assert inlier_cuda.inlier_layout(20480) == (16, 256, 5, 1280)
    with pytest.raises(ValueError):
        inlier_cuda.inlier_layout(100, cluster=12)
    with pytest.raises(ValueError):
        inlier_cuda.inlier_layout(100, threads=128)


def test_inlier_launch_refuses_cpu_tensors():
    """`launch` runs only the kernel: CPU tensors are refused, not passed to
    it (`inlier_fit` takes the plain loop for them)."""
    x = torch.zeros((4, 2))
    with pytest.raises(ValueError):
        inlier_cuda.launch(x, x, torch.zeros(4), torch.ones(4), torch.zeros(8))
