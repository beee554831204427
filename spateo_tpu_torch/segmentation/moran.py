"""Moran's I pixel scoring on the device.

Counterpart of `spateo_tpu.segmentation.moran`: the per-pixel local Moran's
I, its z-score and two-sided p-value (the normal survival function through
`torch.special.ndtr`), in one pass of reductions and one convolution.

`binary_morani_result` turns the scores and p-values into a cell mask: the
Otsu cut of the p-value histogram, or a Sobel edge map of the p-values (the
JAX package's 3 x 3 taps on the reflect-padded map) flooded by
`ops.labels`'s watershed from markers at p > 0.95 and p < 1e-5; both on
`device`, the 8-bit scalings on the host as in the JAX package.

The pixel count n is an int64 here. The JAX package takes it as int32 and
forms ``(n - 1) * (n - 2)`` and ``(n - 1) ** 2`` in int32, which wrap above
46,341 pixels; below that the two agree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..configuration import SKM
from ..core.anndata import AnnData
from ..ops.image import _as_tensor, _conv2d_kernel, _reflect_pad, circle, gaussian_kernel_1d, mclose_mopen
from ..ops.threshold import threshold_otsu


def _moran_kernel_weights(k: int) -> np.ndarray:
    g = gaussian_kernel_1d(k)
    kernel = np.outer(g, g) * circle(k)
    kernel[(k - 1) // 2, (k - 1) // 2] = 0
    return kernel


def _moran_stats(X: torch.Tensor, kernel: np.ndarray, mask: torch.Tensor):
    """(z, c, I, p-value) tensors on X's device."""
    n = torch.sum(mask)
    x_bar = torch.sum(torch.where(mask, X, 0.0)) / n
    z = X - x_bar
    zm = torch.where(mask, z, 0.0)
    m2 = torch.sum(zm**2) / n
    k = kernel.shape[0]
    c = _conv2d_kernel(_reflect_pad(z, (k - 1) // 2), kernel)
    i = z / m2 * c
    kern = torch.as_tensor(np.asarray(kernel, np.float32), device=X.device)
    ksum = torch.sum(kern)
    ei = -ksum / (n - 1)
    wi2 = torch.sum(kern**2)
    m4 = torch.sum(zm**4) / n
    b2 = m4 / (m2**2)
    vari = wi2 * (n - b2) / (n - 1) + ksum * ksum * (2 * b2 - n) / ((n - 1) * (n - 2)) - ksum**2 / (n - 1) ** 2
    zscore = (i - ei) / torch.sqrt(vari)
    pvalue = 2.0 * torch.special.ndtr(-torch.abs(zscore))
    return z, c, i, pvalue


def _mask_tensor(X: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return torch.ones(X.shape, dtype=torch.bool, device=X.device)
    return _as_tensor(mask, X.device).to(torch.bool)


def moranI(
    X: np.ndarray, kernel: np.ndarray, mask: Optional[np.ndarray] = None, device="cuda"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-pixel Moran's I: (z, the kernel-weighted neighbour sum, I, the
    two-sided p-value), host arrays."""
    Xd = _as_tensor(X, device, torch.float32)
    return tuple(t.cpu().numpy() for t in _moran_stats(Xd, kernel, _mask_tensor(Xd, mask)))


def _run_moran(X: torch.Tensor, k: int = 7, p_threshold: float = 0.05, mask=None) -> torch.Tensor:
    """`run_moran` on a tensor, a tensor on X's device."""
    X = X.to(torch.float32)
    _, c, _, pvalue = _moran_stats(X, _moran_kernel_weights(k), _mask_tensor(X, mask))
    return torch.where(pvalue >= p_threshold, 0.0, c)


def run_moran(X: np.ndarray, k: int = 7, p_threshold: float = 0.05, mask: Optional[np.ndarray] = None,
              device="cuda") -> np.ndarray:
    """Moran's I score map: the local neighbour sum, zeroed where the
    p-value is `p_threshold` or more."""
    return _run_moran(_as_tensor(X, device), k, p_threshold, mask).cpu().numpy()


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def run_moran_and_mask_pixels(
    adata: AnnData,
    layer: str,
    k: int = 7,
    p_threshold: float = 0.05,
    mk: int = 3,
    mask: Optional[np.ndarray] = None,
    mask_layer: Optional[str] = None,
    device="cuda",
):
    """Moran's I scoring, then an Otsu cut of the significant positive
    scores, then close and open."""
    X = _as_tensor(SKM.select_layer_data(adata, layer, make_dense=True), device, torch.float32)
    _, c, _, pvalue = _moran_stats(X, _moran_kernel_weights(k), _mask_tensor(X, mask))
    sig = pvalue < p_threshold
    c_sig = torch.where(sig, c, 0.0)
    pos = c_sig[c_sig > 0]
    cutoff = threshold_otsu(pos) if pos.numel() else 0.0
    m = sig & (c >= cutoff)
    if mask is not None:
        m = m & _mask_tensor(X, mask)
    out = mask_layer or SKM.gen_new_layer_key(layer, SKM.MASK_SUFFIX)
    SKM.set_layer_data(adata, out, mclose_mopen(m, mk).cpu().numpy())


def binary_morani_result(
    c: np.ndarray,
    p: np.ndarray,
    pvalue_cutoff: Optional[float] = None,
    method: str = "edge-watershed",
    c_cutoff: Optional[float] = None,
    tissue_mask: Optional[np.ndarray] = None,
    device="cuda",
) -> np.ndarray:
    """Cell mask from per-pixel Moran's I scores `c` and p-values `p`
    (parity: reference moran.py:129). Two significance modes: Otsu on the
    p-value histogram, or Sobel-edge watershed into fore/background; the
    final mask also requires the (0-255 scaled) Moran score to clear an Otsu
    threshold."""
    from ..ops.labels import _watershed_kernel

    c = np.asarray(c, float)
    p = np.asarray(p, float)
    if pvalue_cutoff is None:
        if method == "otsu":
            p8 = (p * 255).astype(np.uint8)
            p2 = p8[tissue_mask > 0] if isinstance(tissue_mask, np.ndarray) else p8.ravel()
            pvalue_cutoff = threshold_otsu(p2.astype(np.float32), device=device)
            p_cell_mask = p8 <= pvalue_cutoff
        elif method == "edge-watershed":
            kx = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32) / 8
            pp = _reflect_pad(_as_tensor(p, device, torch.float32), 1)
            gx = _conv2d_kernel(pp, kx)
            gy = _conv2d_kernel(pp, kx.T)
            edges = torch.sqrt(gx**2 + gy**2)
            markers = np.zeros_like(p, np.int32)
            markers[p > 0.95] = 2  # background
            markers[p < 1e-5] = 1  # foreground
            ws = _watershed_kernel(edges, _as_tensor(markers, device), torch.ones_like(edges, dtype=torch.bool))
            p_cell_mask = (ws == 1).cpu().numpy()
        else:
            raise ValueError(f"unknown method {method}; use 'otsu' or 'edge-watershed'")
    else:
        p_cell_mask = p <= pvalue_cutoff

    if c_cutoff is None:
        c8 = ((c - c.min()) / max(c.max() - c.min(), 1e-12) * 255).astype(np.uint8)
        sel = p_cell_mask & (tissue_mask > 0) if isinstance(tissue_mask, np.ndarray) else p_cell_mask
        vals = c8[sel]
        c_cutoff = threshold_otsu(vals.astype(np.float32), device=device) if vals.size else 0.0
        c = c8
    mask = p_cell_mask & (c >= c_cutoff)
    if isinstance(tissue_mask, np.ndarray):
        mask &= tissue_mask > 0
    return mask.astype(bool)
