"""The Morpho flash E-step on the card: wrapper, plain versions and the two
sweeps.

Counterpart of `spateo_tpu.ops.estep_pallas`. `estep_cuda` takes the
arguments of `estep_pallas` (without `interpret`) and returns the same
reduction dict. Its prologue (the transposed expression factors with the
a-row and ones-row appended, the per-call scalars, the bounding-box skip
mask) and its epilogue (mm scaling, K_NB, Sp, the sigma2 sum, PXB, M1) are
plain PyTorch, as they were XLA around the Pallas calls. Between them run
two sweeps over the [NA, B] pairs:

- `colnorm`: the per-column normalisers and K_NB, through the kernel
  `estep_colnorm` of `csrc/estep.cu` for CUDA tensors, through
  `colnorm_reference` for CPU tensors;
- `rowred`: the per-row reductions, through `estep_rowred` or
  `rowred_reference`.

`tf32_split` and `dot_3xtf32` are the 3xTF32 arithmetic in plain PyTorch:
the split of each f32 operand into TF32 parts that a tensor-core dot of the
E-step would take. On the card that dot missed the E-step's bar
(PERF.md), so both kernels keep an f32 FMA dot; the emulation stays as the
measure of what the split itself costs.

A CUDA tensor launches the kernel or raises; nothing falls back. Each sweep
counts its launches (`colnorm.launches`, `rowred.launches`).
`estep_reference` runs the same prologue and epilogue around the two plain
sweeps on any device: it is what the kernels are held against.

Layouts the sweeps share: xa [NA, 2] and cb [B, 2] coordinates; fat
[G+1, NA] and fbt [G+1, B] expression factors, feature-major; bt [B];
mm [NA]; scal [8] f32 on the device = (sigma2, sigma2_variance,
spatial_outlier, p, eps, 0, 0, 0); skip [n_ta * n_tb] uint8 over 64 x 64
tiles. colnorm returns [5, B] = (c1_raw, c1m, c2, c3, K_NB); rowred returns
[6, NA] = row sums of (P3, P1, P2, P2*d, P3*x_B, P3*y_B) before mm scaling.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

#: Rows and columns of one kernel tile; the skip mask is cut on this grid.
TM, TN = 64, 64
#: Sweep-1 blocks wanted: each column tile's live row tiles are dealt over
#: splits until column tiles x splits reaches this (8 blocks for each of
#: the H100's 132 SMs, four waves of two blocks an SM; PERF.md has the
#: sweep of 264-2,112).
_COLNORM_BLOCKS = 1056
#: Most row tiles one sweep-1 block may list (4 bytes each in shared
#: memory); more splits are taken when a column tile has more.
_COLNORM_MAX_LIST = 8192
#: Sweep-2 blocks wanted: columns are split until row tiles x splits
#: reaches this (8 blocks for each SM), so that 20k rows (313 row tiles)
#: still spread evenly over the card.
_ROWRED_BLOCKS = 1056

#: Tile-skip bound: when every pair of a tile has d > 80*sigma2, every
#: probability in it is < e^-40 (prob_s governs: prob_v decays faster since
#: sigma2_variance >= 1, and `full` <= prob_s because the expression
#: distances are >= 0), so its contribution to every reduction is far below
#: the E-step's parity budget. Read at call time, so a test can patch it.
_SKIP_MULT = 80.0

#: Rows per chunk of the plain sweeps: a chunk's [rows, B] temporaries stay
#: at 2^25 elements (128 MB each in f32), so 100k x 10k fits the card.
_REF_CHUNK_ELEMS = 1 << 25


def _dist(xa: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    a2 = torch.sum(xa * xa, 1)[:, None]
    b2 = torch.sum(cb * cb, 1)[None, :]
    return torch.clamp_min(a2 + b2 - 2.0 * (xa @ cb.T), 0.0)


def _probs(xa, cb, fat, fbt, bt, scal):
    """mm-free (d, prob_v, prob_s, full) for rows xa against all of cb."""
    s2, s2v, p = scal[0], scal[1], scal[3]
    d = _dist(xa, cb)
    prob_v = torch.exp(-d / (2 * s2 / s2v))
    prob_s = torch.exp(-d / (2 * s2))
    e_d = fat.T @ fbt + bt[None, :]
    full = prob_s * torch.exp(-e_d / (2 * p))
    return d, prob_v, prob_s, full


def _row_chunks(NA: int, B: int):
    step = max(1, _REF_CHUNK_ELEMS // max(B, 1))
    return [slice(i, min(i + step, NA)) for i in range(0, NA, step)]


def colnorm_reference(xa, cb, fat, fbt, bt, mm, scal, skip=None) -> torch.Tensor:
    """Sweep 1 in plain PyTorch, dense (no tile is skipped): [5, B]."""
    NA, B = xa.shape[0], cb.shape[0]
    so, eps = scal[2], scal[4]
    c = torch.zeros((4, B), dtype=torch.float32, device=xa.device)
    for rows in _row_chunks(NA, B):
        _, prob_v, prob_s, full = _probs(xa[rows], cb, fat[:, rows], fbt, bt, scal)
        m = mm[rows][:, None]
        c[0] += prob_v.sum(0)
        c[1] += (m * prob_v).sum(0)
        c[2] += (m * prob_s).sum(0)
        c[3] += (m * full).sum(0)
    inlier = 1.0 - so / (so + c[0])
    return torch.cat([c, (inlier * c[3] / (c[3] + eps))[None]])


def rowred_reference(xa, cb, fat, fbt, bt, colstats, scal, skip=None) -> torch.Tensor:
    """Sweep 2 in plain PyTorch, dense (no tile is skipped): [6, NA]."""
    NA, B = xa.shape[0], cb.shape[0]
    so, eps = scal[2], scal[4]
    c1r, c1m, c2, c3 = colstats[0], colstats[1], colstats[2], colstats[3]
    inlier = 1.0 - so / (so + c1r)
    out = torch.empty((6, NA), dtype=torch.float32, device=xa.device)
    for rows in _row_chunks(NA, B):
        d, prob_v, prob_s, full = _probs(xa[rows], cb, fat[:, rows], fbt, bt, scal)
        P1 = prob_v / (so + c1m)
        P2 = inlier * prob_s / (c2 + eps)
        P3 = inlier * full / (c3 + eps)
        out[0, rows] = P3.sum(1)
        out[1, rows] = P1.sum(1)
        out[2, rows] = P2.sum(1)
        out[3, rows] = (P2 * d).sum(1)
        out[4:, rows] = (P3 @ cb).T
    return out


@functools.cache
def _lib():
    from ._build import load

    lib = load("estep")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.estep_colnorm.argtypes = [ptr] * 10 + [i32] * 4 + [f32, ptr]
    lib.estep_colnorm.restype = i32
    lib.estep_rowred.argtypes = [ptr] * 10 + [i32] * 5 + [f32, ptr]
    lib.estep_rowred.restype = i32
    for fn in (lib.estep_tile_rows, lib.estep_tile_cols):
        fn.argtypes, fn.restype = [], i32
    if (lib.estep_tile_rows(), lib.estep_tile_cols()) != (TM, TN):
        raise RuntimeError("csrc/estep.cu was built with other tile sizes than ops/estep_cuda.py cuts its mask with")
    return lib


def _check_cuda(name, tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}; all must be on one CUDA device")
        if t.dtype != torch.float32 and t.dtype != torch.uint8:
            raise TypeError(f"{name}: inputs must be float32 (the skip mask uint8), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return dev


def _check_shapes(xa, cb, fat, fbt, bt, scal, skip):
    NA, B, G1 = xa.shape[0], cb.shape[0], fat.shape[0]
    n_ta, n_tb = -(-NA // TM), -(-B // TN)
    want = dict(xa=(xa, (NA, 2)), cb=(cb, (B, 2)), fat=(fat, (G1, NA)), fbt=(fbt, (G1, B)), bt=(bt, (B,)),
                scal=(scal, (8,)), skip=(skip, (n_ta * n_tb,)))
    for k, (t, w) in want.items():
        if tuple(t.shape) != w:
            raise ValueError(f"estep kernels: {k} has shape {tuple(t.shape)}, expected {w}")
    if skip.dtype != torch.uint8:
        raise TypeError(f"estep kernels: skip must be uint8, got {skip.dtype}")
    return NA, B, G1


def colnorm(xa, cb, fat, fbt, bt, mm, scal, skip) -> torch.Tensor:
    """Sweep 1: [5, B] = (c1_raw, c1m, c2, c3, K_NB). The kernel for CUDA
    tensors, `colnorm_reference` for CPU tensors."""
    if xa.device.type == "cpu":
        return colnorm_reference(xa, cb, fat, fbt, bt, mm, scal, skip)
    dev = _check_cuda("colnorm", [xa, cb, fat, fbt, bt, mm, scal, skip])
    if dev.type != "cuda":
        raise ValueError(f"colnorm: tensors on {dev}; the kernel needs a CUDA device")
    NA, B, G1 = _check_shapes(xa, cb, fat, fbt, bt, scal, skip)
    if mm.shape != (NA,):
        raise ValueError(f"colnorm: mm has shape {tuple(mm.shape)}, expected ({NA},)")
    out = torch.zeros((5, B), dtype=torch.float32, device=dev)
    if NA == 0 or B == 0:
        return out
    splits = colnorm_splits(NA, B)
    partial = torch.empty((splits, 4, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().estep_colnorm(
            xa.data_ptr(), cb.data_ptr(), fat.data_ptr(), fbt.data_ptr(), bt.data_ptr(), mm.data_ptr(),
            scal.data_ptr(), skip.data_ptr(), partial.data_ptr(), out.data_ptr(),
            NA, B, G1, splits, float(_SKIP_MULT), stream,
        )
    if err != 0:
        raise RuntimeError(f"estep_colnorm kernel launch failed: CUDA error {err}")
    colnorm.launches += 1
    return out


colnorm.launches = 0


def colnorm_splits(NA: int, B: int) -> int:
    """Sweep 1's blocks per column tile: enough that column tiles x splits
    reaches `_COLNORM_BLOCKS`, at most one per row tile, and enough that no
    block lists more than `_COLNORM_MAX_LIST` row tiles."""
    n_ta, n_tb = -(-NA // TM), -(-B // TN)
    splits = min(n_ta, max(1, -(-_COLNORM_BLOCKS // n_tb)))
    return max(splits, -(-n_ta // _COLNORM_MAX_LIST))


def colnorm_assignment(skip: torch.Tensor, NA: int, B: int, splits: int):
    """The row tiles each sweep-1 block computes, as the kernel deals them:
    for column tile jt, the row tiles the mask leaves live, in order, the
    k-th to split k % splits. Returns [n_tb][splits] lists of row-tile
    indices. The kernel builds its own list; this is its rule in plain
    Python, for the tests and for the balance `chip_smoke.py` prints."""
    n_ta, n_tb = -(-NA // TM), -(-B // TN)
    live = (skip.reshape(n_ta, n_tb) == 0).cpu()
    out = []
    for jt in range(n_tb):
        rows = torch.nonzero(live[:, jt]).flatten().tolist()
        out.append([rows[s::splits] for s in range(splits)])
    return out


def tf32_split(x: torch.Tensor):
    """The kernel's split of an f32 value into TF32 parts, in plain PyTorch:
    hi = cvt.rna.tf32(x) (round to nearest, ties away from zero, to 10
    mantissa bits), lo = cvt.rna.tf32(x - hi). Both are f32 tensors whose
    low 13 mantissa bits are 0; hi + lo is x to about 2^-22 relative."""

    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    x = x.to(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def dot_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32 with round-to-nearest sums, emulated in f32: the
    products hi.lo and lo.hi first, then hi.hi (every product of two TF32
    values is exact in f32); the term lo.lo is dropped. The tensor cores'
    own f32 accumulation truncates instead, which this does not model."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return (ah @ bl + al @ bh) + ah @ bh


def rowred(xa, cb, fat, fbt, bt, colstats, scal, skip) -> torch.Tensor:
    """Sweep 2: [6, NA] row sums of (P3, P1, P2, P2*d, P3*x_B, P3*y_B). The
    kernel for CUDA tensors, `rowred_reference` for CPU tensors."""
    if xa.device.type == "cpu":
        return rowred_reference(xa, cb, fat, fbt, bt, colstats, scal, skip)
    dev = _check_cuda("rowred", [xa, cb, fat, fbt, bt, colstats, scal, skip])
    if dev.type != "cuda":
        raise ValueError(f"rowred: tensors on {dev}; the kernel needs a CUDA device")
    NA, B, G1 = _check_shapes(xa, cb, fat, fbt, bt, scal, skip)
    if colstats.shape != (5, B):
        raise ValueError(f"rowred: colstats has shape {tuple(colstats.shape)}, expected (5, {B})")
    out = torch.zeros((6, NA), dtype=torch.float32, device=dev)
    if NA == 0 or B == 0:
        return out
    n_ta, n_tb = -(-NA // TM), -(-B // TN)
    splits = min(n_tb, max(1, -(-_ROWRED_BLOCKS // n_ta)))
    per_split = -(-n_tb // splits)
    splits = -(-n_tb // per_split)
    partial = torch.empty((splits, 6, NA), dtype=torch.float32, device=dev) if splits > 1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().estep_rowred(
            xa.data_ptr(), cb.data_ptr(), fat.data_ptr(), fbt.data_ptr(), bt.data_ptr(), colstats.data_ptr(),
            scal.data_ptr(), skip.data_ptr(), 0 if partial is None else partial.data_ptr(), out.data_ptr(),
            NA, B, G1, splits, per_split, float(_SKIP_MULT), stream,
        )
    if err != 0:
        raise RuntimeError(f"estep_rowred kernel launch failed: CUDA error {err}")
    rowred.launches += 1
    return out


rowred.launches = 0


def _tile_min_max(x: torch.Tensor, tile: int):
    n_tiles = -(-x.shape[0] // tile)
    pad = n_tiles * tile - x.shape[0]
    lo = torch.nn.functional.pad(x, (0, pad), value=math.inf).reshape(n_tiles, tile)
    hi = torch.nn.functional.pad(x, (0, pad), value=-math.inf).reshape(n_tiles, tile)
    return lo.amin(1), hi.amax(1)


def tile_skip_mask(xa: torch.Tensor, cb: torch.Tensor, sigma2) -> torch.Tensor:
    """[n_ta * n_tb] uint8 over 64 x 64 tiles, row-major: 1 where the gap
    between the two tiles' bounding boxes alone proves every pair has
    d > _SKIP_MULT * sigma2. Recomputed per call: XAHat moves every EM
    iteration."""

    def gap(amin, amax, bmin, bmax):
        return torch.clamp_min(torch.maximum(amin[:, None] - bmax[None, :], bmin[None, :] - amax[:, None]), 0.0)

    ax_lo, ax_hi = _tile_min_max(xa[:, 0], TM)
    ay_lo, ay_hi = _tile_min_max(xa[:, 1], TM)
    bx_lo, bx_hi = _tile_min_max(cb[:, 0], TN)
    by_lo, by_hi = _tile_min_max(cb[:, 1], TN)
    gx = gap(ax_lo, ax_hi, bx_lo, bx_hi)
    gy = gap(ay_lo, ay_hi, by_lo, by_hi)
    return (gx * gx + gy * gy > _SKIP_MULT * sigma2).to(torch.uint8).reshape(-1)


def _scalar(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(())


def prepare(XAHat, coordsB, a_rows, b_cols, A_feats, B_feats, model_mul_vec, sigma2, gamma, samples_s,
            sigma2_variance, p_param, eps: float = 1e-8, NA_total=None):
    """The prologue: the sweeps' inputs (xa, cb, fat, fbt, bt, mm, scal,
    skip) in the layouts the module docstring gives, on XAHat's device.
    `NA_total` is the whole moving slice's row count when XAHat holds one
    rank's rows (the outlier term's volume counts every row)."""
    NA, D = XAHat.shape
    B = coordsB.shape[0]
    dev = XAHat.device
    f32 = torch.float32
    sigma2, gamma, samples_s = _scalar(sigma2, dev), _scalar(gamma, dev), _scalar(samples_s, dev)
    xa = XAHat.to(f32).contiguous()
    cb = coordsB.to(f32).contiguous()
    fat = torch.cat([A_feats.to(f32).T, a_rows.to(f32)[None, :]]).contiguous()
    fbt = torch.cat([B_feats.to(f32).T, torch.ones((1, B), dtype=f32, device=dev)]).contiguous()
    bt = b_cols.to(f32).contiguous()
    mm = model_mul_vec.to(f32).contiguous()
    outlier_s = samples_s * (NA if NA_total is None else NA_total)
    spatial_outlier = torch.pow(2 * math.pi * sigma2, D / 2.0) * (1 - gamma) / (gamma * outlier_s)
    scal = torch.zeros(8, dtype=f32, device=dev)
    scal[:4] = torch.stack([sigma2, _scalar(sigma2_variance, dev), spatial_outlier, _scalar(p_param, dev)])
    scal[4] = eps
    return xa, cb, fat, fbt, bt, mm, scal, tile_skip_mask(xa, cb, sigma2)


def finish(colstats, rows, mm, coordsA):
    """The epilogue: mm scaling and the small contractions, into the
    reduction dict of `estep_reduced`."""
    K_NB = colstats[4]
    PXB = (rows[4:] * mm[None, :]).T  # [NA, 2]
    return dict(
        K_NA=rows[0] * mm,
        K_NA_spatial=rows[1] * mm,
        K_NA_sigma2=rows[2] * mm,
        K_NB=K_NB,
        Sp=torch.sum(K_NB),
        sigma2_related=torch.sum(rows[3] * mm),
        PXB=PXB,
        M1=coordsA.to(torch.float32).T @ PXB,
    )


def reduce_colstats(colstats: torch.Tensor, scal: torch.Tensor, shard) -> torch.Tensor:
    """Sweep 1's statistics of a whole moving slice from each rank's
    [5, B]: rows 0-3 are sums over the rows, added over the ranks of
    `shard` (`parallel._collectives.RowShard`, rank order); K_NB (row 4) is
    computed again from them with `colnorm_reference`'s formula."""
    (c,) = shard.sum(colstats[:4])
    so, eps = scal[2], scal[4]
    inlier = 1.0 - so / (so + c[0])
    return torch.cat([c, (inlier * c[3] / (c[3] + eps))[None]])


def _estep(sweep1, sweep2, XAHat, coordsA, coordsB, a_rows, b_cols, A_feats, B_feats, model_mul_vec,
           sigma2, gamma, samples_s, sigma2_variance, p_param, eps, shard=None):
    xa, cb, fat, fbt, bt, mm, scal, skip = prepare(XAHat, coordsB, a_rows, b_cols, A_feats, B_feats, model_mul_vec,
                                                   sigma2, gamma, samples_s, sigma2_variance, p_param, eps,
                                                   None if shard is None else shard.n)
    colstats = sweep1(xa, cb, fat, fbt, bt, mm, scal, skip)
    if shard is not None:
        colstats = reduce_colstats(colstats, scal, shard)
    rows = sweep2(xa, cb, fat, fbt, bt, colstats, scal, skip)
    out = finish(colstats, rows, mm, coordsA)
    if shard is not None:
        out["sigma2_related"], out["M1"] = shard.sum(out["sigma2_related"], out["M1"])
    return out


def estep_cuda(XAHat, coordsA, coordsB, a_rows, b_cols, A_feats, B_feats, model_mul_vec,
               sigma2, gamma, samples_s, sigma2_variance, p_param, eps: float = 1e-8, shard=None):
    """Fused E-step returning the same reduction dict as `estep_reduced`:
    the two kernels on a CUDA device, their plain versions on the CPU.
    Scope: D = 2, one 'gauss' layer (p_param its probability parameter).

    With `shard` (`parallel._collectives.RowShard`), XAHat, coordsA, a_rows,
    A_feats and model_mul_vec hold one rank's rows of the moving slice: the
    kernels sweep them, sweep 1's sums are added over the ranks between the
    sweeps (`reduce_colstats`), and so are `sigma2_related` and `M1` after
    them. K_NB and Sp are then the whole slice's on every rank; the per-row
    outputs (K_NA, K_NA_spatial, K_NA_sigma2, PXB) are this rank's."""
    if XAHat.shape[1] != 2:
        raise ValueError(f"estep_cuda: needs 2-D coordinates, got {XAHat.shape[1]}")
    return _estep(colnorm, rowred, XAHat, coordsA, coordsB, a_rows, b_cols, A_feats, B_feats, model_mul_vec,
                  sigma2, gamma, samples_s, sigma2_variance, p_param, eps, shard)


def estep_reference(XAHat, coordsA, coordsB, a_rows, b_cols, A_feats, B_feats, model_mul_vec,
                    sigma2, gamma, samples_s, sigma2_variance, p_param, eps: float = 1e-8, shard=None):
    """`estep_cuda` with the two plain sweeps, on the inputs' device."""
    return _estep(colnorm_reference, rowred_reference, XAHat, coordsA, coordsB, a_rows, b_cols, A_feats, B_feats,
                  model_mul_vec, sigma2, gamma, samples_s, sigma2_variance, p_param, eps, shard)
