"""Raster primitives of Starro: convolutions, blurs, scaling and binary
morphology, in plain PyTorch.

Counterpart of `spateo_tpu.ops.image`. Functions take and return tensors
(a host array goes to ``device=`` first); `clahe` runs on the host with
OpenCV, as in the JAX package. Semantics are the JAX package's, bit for bit
on integer rasters and boolean masks:

- `_reflect_pad` is numpy's ``mode="symmetric"`` (the edge pixel repeats), not
  `torch.nn.functional.pad`'s ``"reflect"`` (which skips it); `conv2d`'s
  gauss mode pads with the latter (cv2's BORDER_REFLECT_101), its circle and
  square modes with the former, and its per-bin form pads ``mask_b * X``
  symmetrically and multiplies the result by ``mask_b``;
- small kernels (at most 169 taps) are weighted shifted adds in the kernel's
  row-major order, as the JAX package unrolls them; the per-bin form stacks
  every bin on a batch dim and runs the same adds once;
- `gaussian_kernel_1d` takes cv2's fixed kernels for k <= 7;
- erosion treats pixels outside the image as foreground and dilation as
  background, as cv2's default borders do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.bridge import _to_device


def circle(k: int) -> np.ndarray:
    """Binary disk of diameter k."""
    if k < 1 or k % 2 == 0:
        raise ValueError("`k` must be odd and greater than 0.")
    r = (k - 1) // 2
    yy, xx = np.mgrid[-r : r + 1, -r : r + 1]
    return (yy**2 + xx**2 <= r**2).astype(np.uint8)


_CV2_FIXED_GAUSS = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}


def gaussian_kernel_1d(k: int, sigma: Optional[float] = None) -> np.ndarray:
    """1D Gaussian kernel with OpenCV's conventions: for sigma <= 0 and
    k <= 7, cv2.getGaussianKernel's fixed binomial kernels."""
    if (sigma is None or sigma <= 0) and k in _CV2_FIXED_GAUSS:
        return _CV2_FIXED_GAUSS[k].copy()
    if sigma is None or sigma <= 0:
        sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    x = np.arange(k) - (k - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _as_tensor(X, device, dtype=None) -> torch.Tensor:
    """`X` itself if it is a tensor (cast to `dtype`), else a copy on `device`."""
    if isinstance(X, torch.Tensor):
        return X if dtype is None else X.to(dtype)
    return _to_device(np.asarray(X), device, dtype)


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


def _conv2d_kernel(X: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """VALID cross-correlation of [..., H + kh - 1, W + kw - 1] with a
    [kh, kw] kernel, in f32. Up to 169 taps: one weighted shifted add per
    nonzero tap in row-major order (the JAX package's `_conv2d_unrolled`),
    over every leading dim at once; larger kernels: `F.conv2d`."""
    kern = np.asarray(kernel, np.float32)
    kh, kw = kern.shape
    Xp = X.to(torch.float32)
    H, W = Xp.shape[-2] - kh + 1, Xp.shape[-1] - kw + 1
    if kh * kw > 169:
        lead = Xp.shape[:-2]
        rhs = torch.from_numpy(kern).to(Xp.device)[None, None]
        out = F.conv2d(Xp.reshape(-1, 1, *Xp.shape[-2:]), rhs)
        return out.reshape(*lead, H, W)
    out = torch.zeros(Xp.shape[:-2] + (H, W), dtype=torch.float32, device=Xp.device)
    for dy in range(kh):
        for dx in range(kw):
            w = float(kern[dy, dx])
            if w != 0.0:
                out = out + w * Xp[..., dy : dy + H, dx : dx + W]
    return out


def _reflect101_pad(X: torch.Tensor, r: int) -> torch.Tensor:
    """Reflect padding that skips the edge pixel (cv2's BORDER_REFLECT_101,
    numpy's ``mode="reflect"``) of the last two dims."""
    if r == 0:
        return X
    lead = X.shape[:-2]
    out = F.pad(X.reshape(-1, *X.shape[-2:]), (r, r, r, r), mode="reflect")
    return out.reshape(*lead, *out.shape[-2:])


def conv2d(X, k: int, mode: str = "circle", bins=None, device="cuda") -> torch.Tensor:
    """Convolve a raster with a gauss/circle/square/median kernel, optionally
    per density bin: ``sum_b conv(X * mask_b) * mask_b`` for every bin b > 0,
    all bins in one batched pass. Returns an f32 tensor on X's device (a host
    `X` goes to `device` first)."""
    if k < 1 or k % 2 == 0:
        raise ValueError("`k` must be odd and greater than 0.")
    if mode not in ("median", "gauss", "circle", "square"):
        raise ValueError('`mode` must be one of "median", "gauss", "circle", "square"')
    if bins is not None and tuple(X.shape) != tuple(bins.shape):
        raise ValueError("`bins` must have the same shape as `X`")
    X = _as_tensor(X, device, torch.float32)
    if k == 1:
        return X
    if mode == "median":
        if bins is not None:
            raise ValueError("median mode does not support bins")
        return median_blur(X, k)
    if mode == "gauss":
        g = gaussian_kernel_1d(k)
        kernel = np.outer(g, g)
    else:
        kernel = (np.ones((k, k)) if mode == "square" else circle(k)).astype(np.float32)
    r = (k - 1) // 2
    if bins is None:
        pad = _reflect101_pad if mode == "gauss" else _reflect_pad
        return _conv2d_kernel(pad(X, r), kernel)
    bins = _as_tensor(bins, X.device)
    labels = torch.unique(bins)
    labels = labels[labels > 0]
    if labels.numel() == 0:
        return torch.zeros_like(X)
    masks = (bins[None] == labels.reshape(-1, 1, 1)).to(torch.float32)  # [L, H, W]
    out = _conv2d_kernel(_reflect_pad(masks * X[None], r), kernel)
    return torch.sum(out * masks, dim=0)


def median_blur(X, k: int, device="cuda") -> torch.Tensor:
    """Median filter over a symmetric-padded k x k window (cv2.medianBlur's
    replacement in the JAX package)."""
    X = _as_tensor(X, device, torch.float32)
    r = (k - 1) // 2
    patches = F.unfold(_reflect_pad(X, r)[None, None], k)[0]  # [k*k, H*W]
    return torch.median(patches, dim=0).values.reshape(X.shape)


def gaussian_blur(X, k: int, device="cuda") -> torch.Tensor:
    return conv2d(X, k, mode="gauss", device=device)


def scale_to_01(X, device="cuda") -> torch.Tensor:
    X = _as_tensor(X, device, torch.float32)
    mn, mx = torch.min(X), torch.max(X)
    return (X - mn) / torch.clamp_min(mx - mn, 1e-30)


def scale_to_255(X, device="cuda") -> torch.Tensor:
    return scale_to_01(X, device) * 255.0


def clahe(X: np.ndarray, clip_limit: float = 1.0, tile_grid: Tuple[int, int] = (100, 100)) -> np.ndarray:
    """Contrast-limited adaptive histogram equalization, on the host (cv2)."""
    import cv2

    return cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=tile_grid).apply(np.asarray(X))


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


def mclose_mopen(mask, k: int, square: bool = False, device="cuda") -> torch.Tensor:
    """Morphological close then open (a host mask goes to `device` first)."""
    if k < 1 or k % 2 == 0:
        raise ValueError("`k` must be odd and greater than 0.")
    m = _as_tensor(mask, device).to(torch.bool)
    closed = erode(dilate(m, k, square), k, square)
    return dilate(erode(closed, k, square), k, square)
