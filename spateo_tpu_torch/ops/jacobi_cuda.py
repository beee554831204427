"""Jacobi sweeps on the card: wrapper and plain version.

Counterpart of `spateo_tpu.ops.stencil._jacobi_pallas_block`. `jacobi_block`
runs `n` Jacobi sweeps of the Dirichlet heat equation over an [H, W] f32
field through the hand-written kernel `csrc/jacobi.cu` for a CUDA tensor, or
through `jacobi_block_reference` (the same arithmetic in plain PyTorch) for
a CPU tensor. A sweep sets every pixel with `upd` set, off the outermost
ring, to ``0.25 * (((f[y+1,x] + f[y-1,x]) + f[y,x+1]) + f[y,x-1])``, the JAX
package's XLA step, and keeps every other pixel. `upd` is a uint8 [H, W]
raster. The input field is not modified. `jacobi_block.launches` counts
kernel launches: the kernel runs `sweeps_per_launch()` sweeps per launch, so
one call makes ``ceil(n / sweeps_per_launch())`` of them.
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


@functools.cache
def _lib():
    from ._build import load

    lib = load("jacobi")
    lib.jacobi_block_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.jacobi_block_f32.restype = ctypes.c_int
    lib.jacobi_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.jacobi_config.restype = ctypes.c_int
    return lib


def kernel_config() -> dict:
    """The kernel's compiled choice: sweeps per launch `T`, the tile
    `tile_x` x `tile_y` and the shared memory per block (builds it)."""
    out = (ctypes.c_int * 4)()
    _lib().jacobi_config(out)
    return dict(T=out[0], tile_x=out[1], tile_y=out[2], smem_bytes=out[3])


def sweeps_per_launch() -> int:
    return kernel_config()["T"]


def jacobi_block(f: torch.Tensor, upd: torch.Tensor, n: int) -> torch.Tensor:
    """`n` Jacobi sweeps: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Returns a new field."""
    if f.device.type == "cpu" and upd.device.type == "cpu":
        return jacobi_block_reference(f, upd, n)
    if f.device.type != "cuda" or f.device != upd.device:
        raise ValueError(f"jacobi_block: f on {f.device} and upd on {upd.device}; both must be on one CUDA device")
    if f.dtype != torch.float32 or upd.dtype != torch.uint8:
        raise TypeError(f"jacobi_block: f must be float32 (got {f.dtype}) and upd uint8 (got {upd.dtype})")
    if f.dim() != 2 or upd.shape != f.shape:
        raise ValueError(f"jacobi_block: need f and upd of one shape [H, W], got {tuple(f.shape)} and {tuple(upd.shape)}")
    if not (f.is_contiguous() and upd.is_contiguous()):
        raise ValueError("jacobi_block: f and upd must be contiguous")
    n = int(n)
    if n < 0:
        raise ValueError(f"jacobi_block: n must be >= 0, got {n}")
    H, W = int(f.shape[0]), int(f.shape[1])
    n_launch = -(-n // sweeps_per_launch())
    if n_launch == 0 or H == 0 or W == 0:
        return f.clone()
    bufs = (torch.empty_like(f), torch.empty_like(f) if n_launch > 1 else None)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream()
        err = _lib().jacobi_block_f32(
            f.data_ptr(), upd.data_ptr(), bufs[0].data_ptr(), 0 if bufs[1] is None else bufs[1].data_ptr(),
            H, W, n, stream.cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"jacobi_block kernel launch failed: CUDA error {err}")
    jacobi_block.launches += n_launch
    return bufs[(n_launch - 1) % 2]


jacobi_block.launches = 0
