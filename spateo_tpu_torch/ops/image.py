"""Raster primitives of the Starro path: density convolution and binary
morphology, in plain PyTorch.

Counterpart of `spateo_tpu.ops.image` (the functions the fused Starro program
calls). Semantics are the JAX package's, bit for bit on integer rasters and
boolean masks:

- `_reflect_pad` is numpy's ``mode="symmetric"`` (the edge pixel repeats), not
  `torch.nn.functional.pad`'s ``"reflect"`` (which skips it);
- erosion treats pixels outside the image as foreground and dilation as
  background, as cv2's default borders do.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def circle(k: int) -> np.ndarray:
    """Binary disk of diameter k."""
    if k < 1 or k % 2 == 0:
        raise ValueError("`k` must be odd and greater than 0.")
    r = (k - 1) // 2
    yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
    return (yy**2 + xx**2 <= r**2).astype(np.uint8)


def _binary_row_runs(kern_np: np.ndarray):
    """Return (dy, lo, hi) run bounds if the kernel is 0/1-valued and every
    nonzero row is one contiguous run of ones, else None."""
    if not np.all((kern_np == 0.0) | (kern_np == 1.0)):
        return None
    rows = []
    for dy in range(kern_np.shape[0]):
        (nz,) = np.nonzero(kern_np[dy])
        if nz.size == 0:
            continue
        lo, hi = int(nz[0]), int(nz[-1]) + 1
        if hi - lo != nz.size:  # gap in the run
            return None
        rows.append((dy, lo, hi))
    return tuple(rows) if rows else None


def _reflect_pad(X: torch.Tensor, r: int) -> torch.Tensor:
    """Symmetric padding of the last two dims by `r` (the edge pixel repeats:
    ``[a b c] -> [b a | a b c | c b]`` for r=2), built from flipped slices."""
    if r == 0:
        return X
    if r > X.shape[-2] or r > X.shape[-1]:
        raise ValueError(f"pad width {r} exceeds the raster shape {tuple(X.shape[-2:])}")
    X = torch.cat([X[..., :r, :].flip(-2), X, X[..., -r:, :].flip(-2)], dim=-2)
    return torch.cat([X[..., :r].flip(-1), X, X[..., -r:].flip(-1)], dim=-1)


def _conv2d_rowsum(X: torch.Tensor, rows: Tuple[Tuple[int, int, int], ...], kh: int, kw: int, padding: str) -> torch.Tensor:
    """Cross-correlation with a binary kernel whose rows are contiguous runs
    of ones: one horizontal prefix sum, then two window reads per kernel row.
    Exact whenever X is integer-valued with row prefix sums below 2^24 (UMI
    count rasters, 0/1 masks)."""
    rh, rw = kh // 2, kw // 2
    Xp = X.to(torch.float32)
    if padding == "SAME":
        Xp = torch.nn.functional.pad(Xp, (rw, rw, rh, rh))
    H = Xp.shape[0] - kh + 1
    W = Xp.shape[1] - kw + 1
    csz = torch.nn.functional.pad(torch.cumsum(Xp, dim=1), (1, 0))
    out = torch.zeros((H, W), dtype=torch.float32, device=X.device)
    for dy, lo, hi in rows:
        out = out + (csz[dy : dy + H, hi : hi + W] - csz[dy : dy + H, lo : lo + W])
    return out


def _shift_bool(m: torch.Tensor, dy: int, dx: int, fill: bool = False) -> torch.Tensor:
    """Shift a bool [H, W] mask by (dy, dx); shifted-in pixels take `fill`."""
    out = torch.roll(m, (dy, dx), (0, 1))
    if dy > 0:
        out[:dy, :] = fill
    elif dy < 0:
        out[dy:, :] = fill
    if dx > 0:
        out[:, :dx] = fill
    elif dx < 0:
        out[:, dx:] = fill
    return out


def _se_row_halfwidths(k: int, square: bool):
    """Per-row half-widths of the structuring element: {dy: max |dx|}."""
    r = (k - 1) // 2
    if square:
        return {dy: r for dy in range(-r, r + 1)}
    hw = {}
    for dy in range(-r, r + 1):
        xs = [dx for dx in range(-r, r + 1) if dx * dx + dy * dy <= r * r]
        if xs:
            hw[dy] = max(xs)
    return hw


def _morph_bool(m: torch.Tensor, k: int, square: bool, erode_: bool) -> torch.Tensor:
    """Binary dilation (OR of shifts, outside = background) or erosion (AND
    of shifts, outside = foreground) by the circle(k)/square(k) element, as
    a per-row decomposition with the horizontal passes shared: the JAX
    package's `_disk_dilate_bool` and `_disk_erode_bool` in one."""
    combine = torch.logical_and if erode_ else torch.logical_or
    hw = _se_row_halfwidths(k, square)
    h_by_w = {0: m}
    acc = m
    for w in range(1, max(hw.values()) + 1):
        acc = combine(combine(acc, _shift_bool(m, 0, w, erode_)), _shift_bool(m, 0, -w, erode_))
        h_by_w[w] = acc
    out = None
    for dy, w in hw.items():
        t = _shift_bool(h_by_w[w], dy, 0, erode_)
        out = t if out is None else combine(out, t)
    return out


def dilate(mask: torch.Tensor, k: int = 3, square: bool = False, iterations: int = 1) -> torch.Tensor:
    """Binary dilation by a circle/square element (cv2.dilate semantics)."""
    out = mask.to(torch.bool)
    if k == 1:
        return out
    for _ in range(iterations):
        out = _morph_bool(out, k, square, erode_=False)
    return out


def erode(mask: torch.Tensor, k: int = 3, square: bool = False, iterations: int = 1) -> torch.Tensor:
    """Binary erosion by a circle/square element (cv2.erode semantics: the
    outside of the image counts as foreground)."""
    out = mask.to(torch.bool)
    if k == 1:
        return out
    for _ in range(iterations):
        out = _morph_bool(out, k, square, erode_=True)
    return out


def mclose_mopen(mask: torch.Tensor, k: int, square: bool = False) -> torch.Tensor:
    """Morphological close then open."""
    if k < 1 or k % 2 == 0:
        raise ValueError("`k` must be odd and greater than 0.")
    m = mask.to(torch.bool)
    closed = erode(dilate(m, k, square), k, square)
    return dilate(erode(closed, k, square), k, square)
