"""The fused BP iteration on the card: wrapper, plain version and loop.

Counterpart of `spateo_tpu.ops.bp_pallas`. `bp_step` runs one synchronous
sum-product iteration on a binary 4-neighbour grid MRF, the message update
and the one-pixel delivery in a single pass, through the hand-written kernel
`csrc/bp_step.cu` for a CUDA tensor, or through `bp_step_reference` (the same
arithmetic in plain PyTorch) for a CPU tensor. `bp_kernel` loops it to the
marginals exactly as `bp_kernel_pallas` does.

Layout (the kernel's and the TPU kernel's): phi is [2, H, W] f32; messages
are [4, H, W], f32 or bf16, plane d holding the DELIVERED state-0 message from
direction d of ((-1, 0), (1, 0), (0, -1), (0, 1)), reverse (1, 0, 3, 2).
State 1 is 1 - m0, since messages are normalised per pixel.

With ``delta=True``, `bp_step` also returns the L2 change of the iteration,
``sqrt(2 * sum((out - M)^2))``, as a 0-d f32 tensor on M's device: on the
card the kernel sums each block's squares in f64 and one small kernel adds
the blocks in a fixed order (no atomics); on the CPU `delta_reference`
computes it in f32. `bp_step.launches` counts iteration-kernel launches,
`bp_step.delta_launches` the launches of the kernel that adds the blocks'
sums: one per call with ``delta=True``.

`step_plan` states the kernel's division of the work (strips, lanes, halo
rows, the edge lanes' outer neighbours, vector chunks) in plain Python, so
that the CPU tests can check it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import numpy as np
import torch

_EPS = 1e-30
_REV = (1, 0, 3, 2)
OFFSETS4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
_MSG_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _outgoing4(phi0, phi1, m0, p: float, q: float):
    """Per-pixel message chain: 4 delivered state-0 planes in, 4 outgoing
    state-0 planes out (before delivery), all arithmetic in f32."""
    m0 = m0.to(torch.float32)
    m1 = 1.0 - m0
    prod0 = phi0 * (m0[0] * m0[1] * m0[2] * m0[3])
    prod1 = phi1 * (m1[0] * m1[1] * m1[2] * m1[3])
    outs = []
    for d in range(4):
        r = _REV[d]
        e0 = prod0 / torch.clamp_min(m0[r], _EPS)
        e1 = prod1 / torch.clamp_min(m1[r], _EPS)
        o0 = e0 * p + e1 * q
        o1 = e0 * q + e1 * p
        outs.append(o0 / torch.clamp_min(o0 + o1, _EPS))
    return outs


def bp_step_reference(phi: torch.Tensor, M: torch.Tensor, p: float, q: float) -> torch.Tensor:
    """One fused BP iteration in plain PyTorch, in the kernel's layout:
    [2, H, W] f32 phi and [4, H, W] messages in, [4, H, W] delivered messages
    out in M's dtype, with 0.5 where the source neighbour is outside the
    image."""
    o = _outgoing4(phi[0].to(torch.float32), phi[1].to(torch.float32), M, p, q)
    out = torch.full(M.shape, 0.5, dtype=torch.float32, device=M.device)
    out[0, :-1] = o[0][1:]  # from the pixel below
    out[1, 1:] = o[1][:-1]  # from the pixel above
    out[2, :, :-1] = o[2][:, 1:]  # from the pixel to the right
    out[3, :, 1:] = o[3][:, :-1]  # from the pixel to the left
    return out.to(M.dtype)


def delta_reference(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """sqrt(2 * sum((new - old)^2)) in f32 on the tensors' device: the plain
    version of the kernel's fused sum (the stored planes are half of the
    message vector, hence the 2)."""
    diff = new.to(torch.float32) - old.to(torch.float32)
    return torch.sqrt(2.0 * torch.sum(diff * diff))


#: The kernel's compile-time choice (`csrc/bp_step.cu`; `kernel_config()`
#: reads the built library's): pixels a lane, rows a warp's strip, strips a
#: block.
LANE_PIXELS, STRIP_ROWS, BLOCK_WARPS = 8, 16, 4


def access_elems(W: int, lane_pixels: int, elem_size: int, ptrs=()) -> int:
    """Elements of one vector access of a message plane's row: the largest
    k in (8, 4, 2, 1), at most `lane_pixels` and 16 bytes of messages of
    `elem_size` bytes, that divides W and keeps every access aligned. `ptrs`
    holds (address, element size) of each tensor the kernel accesses by
    vectors; an access of k elements of size s spans min(k s, 16) bytes
    (phi's f32 rows go in chunks of min(k, 4))."""
    for k in (8, 4, 2, 1):
        if k <= lane_pixels and k * elem_size <= 16 and W % k == 0 and all(a % min(k * s, 16) == 0 for a, s in ptrs):
            return k
    raise ValueError(f"access_elems: a pointer of {ptrs} is not aligned to its element size")


def step_plan(H: int, W: int, lane_pixels: int, access: int, rows: int = STRIP_ROWS, warps: int = BLOCK_WARPS):
    """The kernel's work plan for one iteration on an H x W raster, replayed
    with its own index arithmetic and no arithmetic on values.

    Block (bx, by), warp w, lane l: the strip's columns start at
    x0 = bx 32 V, the lane's at x = x0 + l V, the strip's rows run from
    y0 = (by NW + w) R to y1 = min(y0 + R, H), with the halo rows y0 - 1 and
    y1 read too. A pixel is loaded where its row lies in the image and its
    chunk (K message elements, min(K, 4) phi floats) starts inside the row.
    The strip's outer neighbours are 2 R values computed before its rows,
    value i by lane i % 32: column x0 - 1 of row y0 + i for i < R, column
    x0 + 32 V of row y0 + i - R above; row y takes values y - y0 (lane 0's
    left neighbour) and R + y - y0 (lane 31's right one). Returns (src,
    writes, block, outside): src [4, H, W, 2], the pixel (y, x) whose
    outgoing message the kernel stores at each (plane, y, x), (-1, -1) where
    it stores 0.5 and (-2, -2) where the value it stores was never loaded;
    writes [4, H, W], the number of stores there; block [4, H, W], the
    linear index (by * grid_x + bx) of the block that stores it (-1: none);
    outside, the number of loads of a pixel outside the image."""
    V, K, KP = lane_pixels, access, min(access, 4)
    gx, gy = -(-W // (32 * V)), -(-H // (warps * rows))
    src = np.full((4, H, W, 2), -3, np.int64)
    writes = np.zeros((4, H, W), np.int64)
    block = np.full((4, H, W), -1, np.int64)
    lane = np.arange(32)[:, None]
    v = np.arange(V)[None, :]
    half, unloaded = np.array([-1, -1]), np.array([-2, -2])
    outside = 0

    def loaded(ids, ok):
        nonlocal outside
        y, x = ids[..., 0][ok], ids[..., 1][ok]
        outside += int(np.sum((y < 0) | (y >= H) | (x < 0) | (x >= W)))
        return np.where(ok[..., None], ids, unloaded)

    for by in range(gy):
        for bx in range(gx):
            b = by * gx + bx
            x0 = bx * 32 * V
            x = x0 + lane * V
            cols = x + v  # [32, V]
            in_msg, in_phi = x + (v // K) * K < W, x + (v // KP) * KP < W
            def row(y):  # [32, V, 2]: the pixel each lane value holds
                ok = (0 <= y < H) & in_msg & in_phi
                return loaded(np.stack([np.full_like(cols, y), cols], -1), ok)

            def outer(y0, y1):  # [32 ceil(2R / 32), 2]: value i of the strip's outer neighbours
                i = np.arange(-(-2 * rows // 32) * 32)
                on_right = i >= rows
                y, ex = y0 + np.where(on_right, i - rows, i), np.where(on_right, x0 + 32 * V, x0 - 1)
                ok = (i < 2 * rows) & (y < y1) & (ex >= 0) & (ex < W)
                return loaded(np.stack([y, ex], -1), ok)

            def store(plane, y, vals):
                at = in_msg  # a chunk is stored where it starts inside the row
                src[plane, y, cols[at]] = vals[at]
                np.add.at(writes[plane, y], cols[at], 1)
                block[plane, y, cols[at]] = b

            for w in range(warps):
                y0 = (by * warps + w) * rows
                if y0 >= H:
                    continue
                y1 = min(y0 + rows, H)
                up, ev = row(y0 - 1), outer(y0, y1)
                for y in range(y0, y1):
                    cur = row(y)
                    right = np.where((lane == 31)[..., None], ev[rows + y - y0], np.roll(cur[:, :1], -1, axis=0))
                    left = np.where((lane == 0)[..., None], ev[y - y0], np.roll(cur[:, -1:], 1, axis=0))
                    s1 = np.broadcast_to(half, cur.shape) if y == 0 else up
                    s2 = np.concatenate([cur[:, 1:], right], 1)
                    s3 = np.concatenate([left, cur[:, :-1]], 1)
                    s2 = np.where((cols == W - 1)[..., None], half, s2)
                    s3 = np.where((cols == 0)[..., None], half, s3)
                    store(1, y, s1)
                    store(2, y, s2)
                    store(3, y, s3)
                    if y > y0:
                        store(0, y - 1, cur)
                    up = cur
                store(0, y1 - 1, row(y1) if y1 < H else np.broadcast_to(half, up.shape))
    return src, writes, block, outside


@functools.cache
def _lib():
    from ._build import load

    lib = load("bp_step")
    for fn in (lib.bp_step_f32, lib.bp_step_bf16):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    lib.bp_step_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.bp_step_config.restype = ctypes.c_int
    return lib


@functools.cache
def kernel_config() -> dict:
    """The kernel's compiled choice (builds it): pixels a lane `V`, rows a
    strip `R`, warps a block `NW`, threads a block."""
    out = (ctypes.c_int * 4)()
    _lib().bp_step_config(out)
    return dict(zip(("V", "R", "NW", "threads"), out))


def bp_step(phi: torch.Tensor, M: torch.Tensor, p: float, q: float, delta: bool = False):
    """One fused BP iteration: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns the delivered messages or, with
    ``delta=True``, the pair (messages, L2 change as a 0-d f32 tensor)."""
    if phi.device.type == "cpu" and M.device.type == "cpu":
        out = bp_step_reference(phi, M, p, q)
        return (out, delta_reference(out, M)) if delta else out
    if phi.device.type != "cuda" or phi.device != M.device:
        raise ValueError(f"bp_step: phi on {phi.device} and M on {M.device}; both must be on one CUDA device")
    if phi.dtype != torch.float32 or M.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bp_step: phi must be float32 (got {phi.dtype}), M float32 or bfloat16 (got {M.dtype})")
    if phi.dim() != 3 or phi.shape[0] != 2 or M.shape != (4,) + tuple(phi.shape[1:]):
        raise ValueError(f"bp_step: need phi [2, H, W] and M [4, H, W], got {tuple(phi.shape)} and {tuple(M.shape)}")
    if not (phi.is_contiguous() and M.is_contiguous()):
        raise ValueError("bp_step: phi and M must be contiguous")
    H, W = int(phi.shape[1]), int(phi.shape[2])
    out = torch.empty_like(M)
    if H == 0 or W == 0:
        return (out, torch.zeros((), dtype=torch.float32, device=M.device)) if delta else out
    cfg = kernel_config()
    V, es = cfg["V"], M.element_size()
    K = access_elems(W, V, es, ((phi.data_ptr(), 4), (M.data_ptr(), es), (out.data_ptr(), es)))
    partial = d = None
    if delta:
        n_blocks = -(-W // (32 * V)) * -(-H // (cfg["NW"] * cfg["R"]))
        partial = torch.empty(n_blocks, dtype=torch.float64, device=M.device)
        d = torch.empty((), dtype=torch.float32, device=M.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _lib().bp_step_bf16 if M.dtype == torch.bfloat16 else _lib().bp_step_f32
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream()
        err = fn(phi.data_ptr(), M.data_ptr(), out.data_ptr(), H, W, K, float(p), float(q), ptr(partial), ptr(d),
                 stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"bp_step kernel launch failed: CUDA error {err}")
    bp_step.launches += 1
    if not delta:
        return out
    bp_step.delta_launches += 1
    return out, d


bp_step.launches = 0
bp_step.delta_launches = 0


def bp_kernel(
    phi: torch.Tensor,  # [H, W, 2] node potentials (normalised)
    p: float,
    q: float,
    precision: float,
    max_iter: int,
    check_every: int = 1,
    msg_dtype: str = "float32",
    stats: Optional[dict] = None,
    queued: Optional[Callable[[], None]] = None,
) -> torch.Tensor:
    """Loopy-BP marginals P(cell) [H, W] with the fused iteration in the
    loop; the counterpart of `bp_kernel_pallas`, step for step. If `stats`
    is given, it receives ``n_iter``, the iterations run. `queued`, if given,
    is called once the first block of iterations is enqueued, before the
    host waits for the card: the card then has that block queued (the
    longest run of work the Starro stream enqueues without waiting), under
    which the caller's copies on other streams run.

    The L2 delta between successive messages is measured only on the last
    iteration of each block of `check_every`, by `bp_step(..., delta=True)`
    (one device-to-host read of one scalar per block), scaled by sqrt(2)
    because the stored planes are half of the message vector. ``precision
    <= 0`` runs exactly `max_iter` iterations. The marginal is
    b1 / (b0 + b1).

    On the card the delta is summed in f64, on the CPU and in the JAX
    package in f32; the two agree within 1e-5 relative
    (tests/test_torch_kernel_plans.py), so a delta within that margin of
    `precision` can stop the loop one check block apart on the card and in
    JAX."""
    H, W, _ = phi.shape
    phi_pl = torch.movedim(phi, -1, 0).to(torch.float32).contiguous()  # [2, H, W]
    M = torch.full((4, H, W), 0.5, dtype=_MSG_DTYPES[msg_dtype], device=phi.device)

    i = 0
    if precision <= 0:
        for i in range(1, max_iter + 1):
            M = bp_step(phi_pl, M, p, q)
    else:
        check = max(min(int(check_every), int(max_iter)), 1)
        i, delta = 0, float("inf")
        while i < max_iter and delta >= precision:
            # advance up to `check` iterations (bounded by max_iter), then
            # measure the delta of the last one
            n_free = min(check - 1, max(max_iter - i - 1, 0))
            for _ in range(n_free):
                M = bp_step(phi_pl, M, p, q)
            M, delta_t = bp_step(phi_pl, M, p, q, delta=True)
            if queued is not None:
                queued()
                queued = None
            delta = float(delta_t)
            i += n_free + 1
    if queued is not None:
        queued()
    if stats is not None:
        stats["n_iter"] = i
    M = M.to(torch.float32)
    belief0 = phi_pl[0] * M[0] * M[1] * M[2] * M[3]
    belief1 = phi_pl[1] * (1.0 - M[0]) * (1.0 - M[1]) * (1.0 - M[2]) * (1.0 - M[3])
    return belief1 / torch.clamp_min(belief0 + belief1, _EPS)
