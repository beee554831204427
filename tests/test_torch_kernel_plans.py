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
  index arithmetic;
- the BP iteration (`csrc/bp_step.cu`): `bp_cuda.step_plan` replays the
  strips, lanes, halo rows, edge lanes and vector chunks; every (plane,
  pixel) output is stored exactly once, from the right source pixel;
- the stopping sums: the card adds f64 partials of its blocks in a fixed
  order (BP's delta, the Jacobi relative change), the plain versions and
  the JAX package sum in f32; `_fixed_order_sum` replays the card's order.
"""

import numpy as np
import pytest
import torch

from spateo_tpu_torch.ops import bp_cuda, estep_cuda, inlier_cuda, jacobi_cuda

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


# -- BP iteration ---------------------------------------------------------------------

BP_PLAN_SHAPES = [(1, 1), (13, 1), (5, 31), (9, 32), (8, 33), (17, 255), (3, 256), (21, 257), (4, 520), (6, 1002),
                  (11, 1500), (33, 64), (40, 4)]


def _delivery_sources(H, W):
    """Where each delivered message comes from: [4, H, W, 2] source pixels,
    (-1, -1) for the 0.5 at the image edge."""
    yy, xx = np.mgrid[:H, :W]
    src = np.full((4, H, W, 2), -1, np.int64)
    for plane, (dy, dx) in enumerate(((1, 0), (-1, 0), (0, 1), (0, -1))):
        sy, sx = yy + dy, xx + dx
        inside = (0 <= sy) & (sy < H) & (0 <= sx) & (sx < W)
        src[plane][inside] = np.stack([sy, sx], -1)[inside]
    return src


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("lane_pixels,elem_size", [(8, 2), (8, 4), (4, 2), (4, 4)])
@pytest.mark.parametrize("H,W", BP_PLAN_SHAPES)
def test_bp_step_plan_stores_each_output_once_from_its_source(H, W, lane_pixels, elem_size, narrow):
    """Every (plane, pixel) output is stored exactly once, by one block,
    with the outgoing message of the pixel the delivery rule names (0.5 at
    the image edge) and never a value that was not loaded, and no load
    falls outside the image: for one pixel,
    one lane, one strip and its ragged ends, rows of 1,500 (8-byte chunks in
    bf16), odd widths (scalar accesses) and heights that are no multiple of
    a strip, in bf16 (2-byte) and f32 (4-byte) messages. `narrow` takes
    scalar accesses, as for a misaligned pointer."""
    K = 1 if narrow else bp_cuda.access_elems(W, lane_pixels, elem_size)
    src, writes, block, outside = bp_cuda.step_plan(H, W, lane_pixels, K)
    assert outside == 0
    assert (writes == 1).all()
    assert (src != -2).all()
    np.testing.assert_array_equal(src, _delivery_sources(H, W))
    n_blocks = -(-W // (32 * lane_pixels)) * -(-H // (bp_cuda.STRIP_ROWS * bp_cuda.BLOCK_WARPS))
    assert block.min() >= 0 and block.max() < n_blocks


@pytest.mark.parametrize("rows,warps", [(1, 1), (3, 2), (8, 4), (16, 8)])
def test_bp_step_plan_other_strips(rows, warps):
    """The plan holds for other strip heights and warps a block (the
    compile-time choices the A/B probe builds)."""
    for H, W in ((1, 1), (29, 257), (50, 1500)):
        for V in (4, 8):
            src, writes, _, outside = bp_cuda.step_plan(H, W, V, bp_cuda.access_elems(W, V, 2), rows=rows,
                                                        warps=warps)
            assert outside == 0 and (writes == 1).all()
            np.testing.assert_array_equal(src, _delivery_sources(H, W))


@pytest.mark.parametrize("msg_dtype", [torch.float32, torch.bfloat16])
def test_bp_step_plan_gathers_the_plain_iteration(msg_dtype):
    """The plan's sources, gathered from the per-pixel outgoing messages,
    give `bp_step_reference` bit for bit."""
    H, W = 37, 300
    rng = np.random.default_rng(5)
    phi = rng.uniform(0.05, 0.95, (2, H, W)).astype(np.float32)
    phi = torch.from_numpy(phi / phi.sum(0, keepdims=True))
    M = torch.from_numpy(rng.uniform(0.02, 0.98, (4, H, W)).astype(np.float32)).to(msg_dtype)
    o = torch.stack(bp_cuda._outgoing4(phi[0], phi[1], M, 0.6, 0.4))
    V, es = bp_cuda.LANE_PIXELS, torch.empty((), dtype=msg_dtype).element_size()
    src, _, _, _ = bp_cuda.step_plan(H, W, V, bp_cuda.access_elems(W, V, es))
    out = torch.full((4, H, W), 0.5)
    for plane in range(4):
        inside = torch.from_numpy(src[plane, ..., 0] >= 0)
        sy, sx = (torch.from_numpy(src[plane, ..., i][inside.numpy()]) for i in (0, 1))
        out[plane][inside] = o[plane][sy, sx]
    assert torch.equal(out.to(msg_dtype), bp_cuda.bp_step_reference(phi, M, 0.6, 0.4))


@pytest.mark.parametrize("W,V,es,ptrs,want", [
    (2048, 8, 2, ((0, 4), (256, 2), (512, 2)), 8), (2048, 8, 4, ((0, 4), (256, 4)), 4),
    (2048, 4, 2, ((0, 4), (256, 2)), 4), (1500, 8, 2, ((0, 4), (256, 2)), 4), (1500, 8, 4, ((0, 4), (256, 4)), 4),
    (1002, 8, 2, ((0, 4), (256, 2)), 2), (255, 8, 2, ((0, 4), (256, 2)), 1), (1, 4, 4, ((0, 4), (256, 4)), 1),
    (2048, 8, 2, ((0, 4), (258, 2)), 1), (2048, 8, 2, ((8, 4), (256, 2)), 2), (2048, 8, 2, ((0, 4), (260, 2)), 2),
])
def test_bp_access_elems(W, V, es, ptrs, want):
    """The widest access that divides the row and keeps every pointer
    aligned: at most the lane's pixels and 16 bytes of messages (phi: 4
    floats)."""
    assert bp_cuda.access_elems(W, V, es, ptrs) == want


# -- stopping sums ----------------------------------------------------------------------

FIN_NT = 256  # threads of `bp_delta_finalize` and `jacobi_err_finalize`
#: csrc/jacobi.cu's default output tile (T = 14, R = 10, NW = 12): (128 - 2T) x (NW R - 2T)
JACOBI_TILE = (100, 92)


def _fixed_order_sum(partials):
    """The finalize kernels' order: thread t adds partials t, t + 256, ...
    in turn, then a tree halves the 256 sums."""
    s = np.zeros(FIN_NT)
    for t in range(FIN_NT):
        acc = 0.0
        for v in partials[t::FIN_NT]:
            acc += float(v)
        s[t] = acc
    h = FIN_NT // 2
    while h:
        s[:h] = s[:h] + s[h:2 * h]
        h //= 2
    return float(s[0])


def _bp_near_convergence(H, W, n, msg_dtype, seed):
    """The messages before and after iteration n of the plain loop."""
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0.05, 0.95, (2, H, W)).astype(np.float32)
    phi = torch.from_numpy(phi / phi.sum(0, keepdims=True))
    M = torch.full((4, H, W), 0.5, dtype=msg_dtype)
    for _ in range(n):
        M_old, M = M, bp_cuda.bp_step_reference(phi, M, 0.6, 0.4)
    return M, M_old


@pytest.mark.parametrize("msg_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 10, 40])
def test_bp_delta_fixed_order_f64_sum_against_f32(msg_dtype, n):
    """BP's delta as the card sums it (each square in f32, added in f64 per
    block, the blocks in the finalize's order) against the plain f32 sum of
    the CPU and of the JAX package, along the convergence path: within 1e-5
    relative. A `precision` outside that margin of the delta stops both at
    the same check block."""
    H, W = 150, 700
    new, old = _bp_near_convergence(H, W, n, msg_dtype, seed=n)
    want = float(bp_cuda.delta_reference(new, old))
    V, es = bp_cuda.LANE_PIXELS, torch.empty((), dtype=msg_dtype).element_size()
    _, _, block, _ = bp_cuda.step_plan(H, W, V, bp_cuda.access_elems(W, V, es))
    d = new.to(torch.float32) - old.to(torch.float32)
    sq = (d * d).numpy().astype(np.float64)
    partials = np.bincount(block.ravel(), weights=sq.ravel(), minlength=int(block.max()) + 1)
    card = float(np.float32(np.sqrt(2.0 * _fixed_order_sum(partials))))
    assert want > 0
    assert abs(card - want) <= 1e-5 * want
    for precision in (want * (1 - 2e-5), want * (1 + 2e-5)):
        assert (card >= precision) == (want >= precision)


@pytest.mark.parametrize("sweeps", [20, 200])
def test_jacobi_err_fixed_order_f64_sum_against_f32(sweeps):
    """The Jacobi block's relative change as the card sums it (f64 per
    output tile, the tiles in the finalize's order) against
    `rel_change_reference` in f32, for a masked field after `sweeps` sweeps:
    within 1e-5 relative, so a `max_err` outside that margin stops the card
    and the JAX package at the same block."""
    H, W = 300, 410
    rng = np.random.default_rng(sweeps)
    f = torch.from_numpy(rng.uniform(0, 100, (H, W)).astype(np.float32))
    upd = torch.zeros((H, W), dtype=torch.uint8)
    upd[1:-1, 1:-1] = 1
    weight = torch.from_numpy((rng.uniform(size=(H, W)) < 0.8).astype(np.float32))
    old = jacobi_cuda.jacobi_block_reference(f, upd, sweeps)
    new = jacobi_cuda.jacobi_block_reference(old, upd, 100)
    want = float(jacobi_cuda.rel_change_reference(new, old, weight))
    tx, ty = JACOBI_TILE
    gx = -(-W // tx)
    yy, xx = np.mgrid[:H, :W]
    tile = (yy // ty) * gx + xx // tx
    n64, o64, w64 = (t.numpy().astype(np.float64) for t in (new, old, weight))
    d2 = np.bincount(tile.ravel(), weights=((n64 - o64) ** 2 * w64).ravel())
    n2 = np.bincount(tile.ravel(), weights=(n64 ** 2 * w64).ravel())
    card = float(np.float32(np.sqrt(_fixed_order_sum(d2) / max(_fixed_order_sum(n2), 1e-30))))
    assert want > 0
    assert abs(card - want) <= 1e-5 * want
    for max_err in (want * (1 - 2e-5), want * (1 + 2e-5)):
        assert (card > max_err) == (want > max_err)
