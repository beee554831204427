"""Boolean rasters as bits, on any device.

Counterpart of the `jnp.packbits` / `jnp.unpackbits` calls of the JAX
package (Starro's packed mask, the labeling chain's packed upload), which
run outside any Pallas kernel; plain PyTorch here. The layout is numpy's:
eight values a byte, the first in the most significant bit, the last byte
zero-padded, so ``packbits(m)`` equals ``np.packbits(m.ravel())``.
"""

from __future__ import annotations

import torch

_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)


def packbits(mask: torch.Tensor) -> torch.Tensor:
    """The flattened `mask` as uint8 bytes on its device: [ceil(n / 8)]."""
    flat = mask.reshape(-1).to(torch.uint8)
    pad = (-flat.numel()) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=flat.device)
    # the eight shifted bits of a byte never overlap, so their sum is their OR
    return (flat.view(-1, 8) << shifts).sum(dim=1, dtype=torch.uint8)


def unpackbits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """The first `n` values packed in `bits` (uint8), as a flat bool tensor
    on its device."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=bits.device)
    return ((bits.reshape(-1, 1) >> shifts) & 1).reshape(-1)[:n].to(torch.bool)
