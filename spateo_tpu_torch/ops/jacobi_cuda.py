"""Jacobi sweeps on the card: wrapper and plain version.

Counterpart of `spateo_tpu.ops.stencil._jacobi_pallas_block`. `jacobi_block`
runs `n` Jacobi sweeps of the Dirichlet heat equation over an [H, W] f32
field through the hand-written kernel `csrc/jacobi.cu` for a CUDA tensor, or
through `jacobi_block_reference` (the same arithmetic in plain PyTorch) for
a CPU tensor. A sweep sets every pixel with `upd` set, off the outermost
ring, to ``0.25 * (((f[y+1,x] + f[y-1,x]) + f[y,x+1]) + f[y,x-1])``, the JAX
package's XLA step, and keeps every other pixel. `upd` is a uint8 [H, W]
raster. The input field is not modified.

Given a `weight` raster, `jacobi_block` also returns the masked relative
change of the block, ``sqrt(sum((new - f)^2 w) / max(sum(new^2 w), 1e-30))``
as a 0-d f32 tensor on the field's device: on the card the last sweep launch
sums each tile's share in f64 and one small kernel adds the tiles in a fixed
order (no atomics); on the CPU `rel_change_reference` computes it in f32.

`jacobi_block.launches` counts sweep-kernel launches: the kernel runs
`sweeps_per_launch()` sweeps per launch, so one call makes
``ceil(n / sweeps_per_launch())`` of them. `jacobi_block.err_launches`
counts the launches of the kernel that adds the tiles' sums: one per call
with a weight.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def jacobi_block_reference(f: torch.Tensor, upd: torch.Tensor, n: int) -> torch.Tensor:
    """`n` sweeps in plain PyTorch: the XLA step's operand order, then a
    select. The outermost ring never moves, whatever `upd` holds there."""
    out = f.clone()
    if f.shape[0] < 3 or f.shape[1] < 3:
        return out
    moving = upd[1:-1, 1:-1] != 0
    for _ in range(int(n)):
        avg = 0.25 * (((out[2:, 1:-1] + out[:-2, 1:-1]) + out[1:-1, 2:]) + out[1:-1, :-2])
        out[1:-1, 1:-1] = torch.where(moving, avg, out[1:-1, 1:-1])
    return out


def rel_change_reference(new: torch.Tensor, old: torch.Tensor, weight=None) -> torch.Tensor:
    """sqrt(sum((new - old)^2 w) / max(sum(new^2 w), 1e-30)) in f32, on the
    device: the plain version of the kernel's fused sums."""
    d2, n2 = (new - old) ** 2, new**2
    if weight is not None:
        d2, n2 = d2 * weight, n2 * weight
    return torch.sqrt(torch.sum(d2) / torch.clamp_min(torch.sum(n2), 1e-30))


@functools.cache
def _lib():
    from ._build import load

    lib = load("jacobi")
    lib.jacobi_block_f32.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.jacobi_block_f32.restype = ctypes.c_int
    lib.jacobi_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.jacobi_config.restype = ctypes.c_int
    return lib


def kernel_config() -> dict:
    """The kernel's compiled choice (builds it): sweeps per launch `T`, the
    output tile `tile_x` x `tile_y`, the shared memory per block, the rows
    `R` and columns `C` each lane holds in registers, the warps `NW` and
    threads per block."""
    out = (ctypes.c_int * 8)()
    _lib().jacobi_config(out)
    keys = ("T", "tile_x", "tile_y", "smem_bytes", "R", "NW", "C", "threads")
    return dict(zip(keys, out))


def sweeps_per_launch() -> int:
    return kernel_config()["T"]


def jacobi_block(f: torch.Tensor, upd: torch.Tensor, n: int, weight: torch.Tensor | None = None):
    """`n` Jacobi sweeps: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Returns a new field or, given `weight` (f32 [H, W]),
    the pair (field, relative change of the block)."""
    if f.device.type == "cpu" and upd.device.type == "cpu" and (weight is None or weight.device.type == "cpu"):
        out = jacobi_block_reference(f, upd, n)
        return out if weight is None else (out, rel_change_reference(out, f, weight))
    if f.device.type != "cuda" or f.device != upd.device or (weight is not None and weight.device != f.device):
        where = "" if weight is None else f" and weight on {weight.device}"
        raise ValueError(f"jacobi_block: f on {f.device}, upd on {upd.device}{where}; all must be on one CUDA device")
    if f.dtype != torch.float32 or upd.dtype != torch.uint8 or (weight is not None and weight.dtype != torch.float32):
        raise TypeError(f"jacobi_block: f and weight must be float32 (got {f.dtype}) and upd uint8 (got {upd.dtype})")
    if f.dim() != 2 or upd.shape != f.shape or (weight is not None and weight.shape != f.shape):
        raise ValueError(f"jacobi_block: need f, upd and weight of one shape [H, W], got {tuple(f.shape)} and "
                         f"{tuple(upd.shape)}")
    if not (f.is_contiguous() and upd.is_contiguous() and (weight is None or weight.is_contiguous())):
        raise ValueError("jacobi_block: f, upd and weight must be contiguous")
    n = int(n)
    if n < 0:
        raise ValueError(f"jacobi_block: n must be >= 0, got {n}")
    H, W = int(f.shape[0]), int(f.shape[1])
    cfg = kernel_config()
    n_launch = -(-n // cfg["T"])
    if n_launch == 0 or H == 0 or W == 0:
        out = f.clone()
        return out if weight is None else (out, torch.zeros((), dtype=torch.float32, device=f.device))
    bufs = (torch.empty_like(f), torch.empty_like(f) if n_launch > 1 else None)
    partial = err = None
    if weight is not None:
        n_tiles = -(-W // cfg["tile_x"]) * -(-H // cfg["tile_y"])
        partial = torch.empty(2 * n_tiles, dtype=torch.float64, device=f.device)
        err = torch.empty((), dtype=torch.float32, device=f.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream()
        code = _lib().jacobi_block_f32(
            f.data_ptr(), upd.data_ptr(), bufs[0].data_ptr(), ptr(bufs[1]), ptr(weight), ptr(partial), ptr(err),
            H, W, n, stream.cuda_stream,
        )
    if code != 0:
        raise RuntimeError(f"jacobi_block kernel launch failed: CUDA error {code}")
    jacobi_block.launches += n_launch
    out = bufs[(n_launch - 1) % 2]
    if weight is None:
        return out
    jacobi_block.err_launches += 1
    return out, err


jacobi_block.launches = 0
jacobi_block.err_launches = 0
