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
"""

from __future__ import annotations

import ctypes
import functools

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


@functools.cache
def _kernel_fn(dtype: torch.dtype):
    from ._build import load

    lib = load("bp_step")
    fn = lib.bp_step_f32 if dtype == torch.float32 else lib.bp_step_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bp_step(phi: torch.Tensor, M: torch.Tensor, p: float, q: float) -> torch.Tensor:
    """One fused BP iteration: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. `bp_step.launches` counts kernel launches."""
    if phi.device.type == "cpu" and M.device.type == "cpu":
        return bp_step_reference(phi, M, p, q)
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
        return out
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream()
        err = _kernel_fn(M.dtype)(phi.data_ptr(), M.data_ptr(), out.data_ptr(), H, W, float(p), float(q), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"bp_step kernel launch failed: CUDA error {err}")
    bp_step.launches += 1
    return out


bp_step.launches = 0


def bp_kernel(
    phi: torch.Tensor,  # [H, W, 2] node potentials (normalised)
    p: float,
    q: float,
    precision: float,
    max_iter: int,
    check_every: int = 1,
    msg_dtype: str = "float32",
) -> torch.Tensor:
    """Loopy-BP marginals P(cell) [H, W] with the fused iteration in the
    loop; the counterpart of `bp_kernel_pallas`, step for step.

    The L2 delta between successive messages is measured only on the last
    iteration of each block of `check_every` (one device-to-host read per
    block), scaled by sqrt(2) because the stored planes are half of the
    message vector. ``precision <= 0`` runs exactly `max_iter` iterations.
    The marginal is b1 / (b0 + b1)."""
    H, W, _ = phi.shape
    phi_pl = torch.movedim(phi, -1, 0).to(torch.float32).contiguous()  # [2, H, W]
    M = torch.full((4, H, W), 0.5, dtype=_MSG_DTYPES[msg_dtype], device=phi.device)

    if precision <= 0:
        for _ in range(max_iter):
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
            M_new = bp_step(phi_pl, M, p, q)
            diff = M_new.to(torch.float32) - M.to(torch.float32)
            delta = float(torch.sqrt(2.0 * torch.sum(diff * diff)))
            i += n_free + 1
            M = M_new
    M = M.to(torch.float32)
    belief0 = phi_pl[0] * M[0] * M[1] * M[2] * M[3]
    belief1 = phi_pl[1] * (1.0 - M[0]) * (1.0 - M[1]) * (1.0 - M[2]) * (1.0 - M[3])
    return belief1 / torch.clamp_min(belief0 + belief1, _EPS)
