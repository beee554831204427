"""Segmentation utilities: thresholding with morphology, safe erosion, cell
areas and shapes.

Counterpart of `spateo_tpu.segmentation.utils`. The raster work runs on
``device=`` (default ``"cuda"``) and the public functions return host arrays.
`safe_erode`'s loop, one `lax.while_loop` in the JAX package, is a Python
loop here: each step labels the mask's components (`ops.labels._cc_kernel`,
one host read a pass), adds their areas with one scatter, and reads the
number of components above `min_area` once; `safe_erode.host_reads` counts
those reads. The boolean result equals the JAX package's bit for bit,
including its scatter's treatment of the last pixel's root (dropped, and
read back clamped to the last index).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..configuration import SKM
from ..core.anndata import AnnData
from ..core.bridge import _to_device
from ..logging import logger_manager as lm
from ..ops.image import (
    _as_tensor,
    circle,
    clahe,
    conv2d,
    dilate,
    erode,
    mclose_mopen,
    scale_to_01,
    scale_to_255,
)
from ..ops.labels import _cc_kernel, find_boundaries, label_overlap
from ..ops.threshold import knee_threshold

__all__ = [
    "circle",
    "clahe",
    "conv2d",
    "knee_threshold",
    "scale_to_01",
    "scale_to_255",
    "mclose_mopen",
    "apply_threshold",
    "safe_erode",
    "label_overlap",
    "cal_cell_area",
    "filter_cell_labels_by_area",
    "get_cell_shape",
]


def _apply_threshold(X: torch.Tensor, k: int, threshold: Optional[float] = None) -> torch.Tensor:
    """`apply_threshold` on a tensor; a bool tensor on X's device."""
    threshold = threshold if threshold is not None else knee_threshold(X)
    return mclose_mopen(X >= threshold, k)


def apply_threshold(X, k: int, threshold: Optional[Union[float, np.ndarray]] = None, device="cuda") -> np.ndarray:
    """Threshold an array (at its knee by default), then close and open
    with a circle of size k."""
    return _apply_threshold(_as_tensor(X, device), k, threshold).cpu().numpy()


def safe_erode(
    X: np.ndarray,
    k: int,
    square: bool = False,
    min_area: int = 1,
    n_iter: int = -1,
    float_k: Optional[int] = None,
    float_threshold: Optional[float] = None,
    max_iter: int = 1000,
    device="cuda",
) -> np.ndarray:
    """Erode iteratively, keeping each connected region whose area would drop
    to `min_area` or below, until at most one region is larger than
    `min_area`, `n_iter` steps (if > 0) or `max_iter` steps."""
    X = X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
    if X.dtype == np.dtype(bool):
        X = X.astype(np.uint8)
    is_float = np.issubdtype(X.dtype, np.floating)
    if is_float and (float_k is None or float_threshold is None):
        raise ValueError("`float_k` and `float_threshold` must be provided for floating point arrays.")
    mask, saved = _safe_erode_kernel(
        _to_device(X, device, torch.float32), bool(is_float), int(k), bool(square), int(min_area), int(n_iter),
        int(float_k or 0), float(float_threshold if float_threshold is not None else 0.0), int(max_iter),
    )
    return (mask | saved).cpu().numpy()


safe_erode.host_reads = 0


def _safe_erode_kernel(
    X0: torch.Tensor,
    is_float: bool,
    k: int,
    square: bool,
    min_area: int,
    n_iter: int,
    float_k: int,
    float_threshold: float,
    max_iter: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The erosion loop on X0's device; returns (mask, saved) bool tensors."""
    H, W = X0.shape
    HW = H * W
    taps = np.argwhere(np.ones((k, k)) if square else circle(k))

    def threshold_mask(Xc):
        if is_float:
            m = Xc >= float_threshold
            m = erode(dilate(m, float_k), float_k)  # close
            return dilate(erode(m, float_k), float_k)  # open
        return Xc > 0

    def erode_step(Xc):
        if is_float:  # grey erosion: the min over the element, +inf outside
            r = k // 2
            padded = F.pad(Xc, (r, r, r, r), value=float("inf"))
            out = torch.full_like(Xc, float("inf"))
            for dy, dx in taps:
                out = torch.minimum(out, padded[dy : dy + H, dx : dx + W])
            return out
        return erode(Xc > 0, k, square).to(Xc.dtype)

    Xc = X0
    saved = torch.zeros((H, W), dtype=torch.bool, device=X0.device)
    i = 0
    while i < max_iter:
        m = threshold_mask(Xc)
        passes = _cc_kernel.passes
        roots = _cc_kernel(m, 8).reshape(-1).long()
        # roots are 1-based flat indices: the JAX scatter into H*W slots drops
        # root H*W, and its gather reads that root back from slot H*W - 1
        area = torch.zeros(HW + 1, dtype=torch.int32, device=X0.device)
        area = area.index_add(0, roots, m.reshape(-1).to(torch.int32))[:HW]
        area_pp = area[torch.clamp_max(roots, HW - 1)].reshape(H, W)
        saved = saved | (m & (area_pp > 0) & (area_pp <= min_area))
        n_big = int(torch.sum(area > min_area))
        safe_erode.host_reads += 1 + _cc_kernel.passes - passes
        Xc = erode_step(Xc)
        i += 1
        if n_big <= 1 or (n_iter > 0 and i >= n_iter):
            break
    mask = (Xc >= float_threshold) if is_float else (Xc > 0)
    return mask, saved


def cal_cell_area(cell_labels: np.ndarray) -> dict:
    """Pixel count per positive label."""
    t = np.bincount(np.asarray(cell_labels).ravel())
    return {i: int(t[i]) for i in range(len(t)) if i > 0 and t[i] > 0}


def filter_cell_labels_by_area(adata: AnnData, layer: str, area_cutoff: int = 7):
    """Zero out labels whose area is below `area_cutoff`."""
    X = SKM.select_layer_data(adata, layer, make_dense=True)
    cells = [i for i in np.unique(X) if i > 0]
    lm.main_info(f"Cell number before filtering is {len(cells)}")
    areas = np.bincount(np.asarray(X).astype(int).ravel())
    small = np.where(areas < area_cutoff)[0]
    X = np.where(np.isin(X, small[small > 0]), 0, X)
    SKM.set_layer_data(adata, layer, X)
    cells = [i for i in np.unique(X) if i > 0]
    lm.main_info(f"Cell number after filtering is {len(cells)}")


def get_cell_shape(adata: AnnData, layer: str, thickness: int = 1, out_layer: Optional[str] = None, device="cuda"):
    """Render cell boundaries (value 255) with the given thickness."""
    labels = np.asarray(SKM.select_layer_data(adata, layer, make_dense=True))
    bound = np.zeros_like(labels, dtype=np.uint8)
    work = labels.copy()
    for _ in range(thickness):
        work = np.where(bound == 0, work, 0)
        bound += find_boundaries(work, mode="inner", device=device).astype(np.uint8)
    bound = bound * 255
    out_layer = out_layer or SKM.gen_new_layer_key(layer, SKM.BOUNDARY_SUFFIX)
    SKM.set_layer_data(adata, out_layer, bound)
