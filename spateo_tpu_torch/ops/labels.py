"""Label rasters on the device: connected components, distance transform,
peaks, watershed, expansion.

Counterpart of `spateo_tpu.ops.labels`, in plain PyTorch (the JAX package
runs these as XLA programs, with no TPU kernel). Every relaxation is a
``while changed`` loop over whole-raster passes, as there; here each pass
ends with one read of `changed` by the host. Integer outputs equal the JAX
package's exactly: the neighbour order `N8`, the strict ``>`` tie-break of
the watershed and the float32 arithmetic of the chamfer weights are kept.
Public functions take numpy arrays and ``device=`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.bridge import _to_device as _to
from .bits import unpackbits

N4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
N8 = N4 + ((-1, -1), (-1, 1), (1, -1), (1, 1))


def _shift(arr: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[y, x] = arr[y - dy, x - dx], `fill` where that is off the raster."""
    H, W = arr.shape[:2]
    out = torch.full_like(arr, fill)
    if abs(dy) >= H or abs(dx) >= W:
        return out
    ys, yd = slice(max(-dy, 0), H - max(dy, 0)), slice(max(dy, 0), H - max(-dy, 0))
    xs, xd = slice(max(-dx, 0), W - max(dx, 0)), slice(max(dx, 0), W - max(-dx, 0))
    out[yd, xd] = arr[ys, xs]
    return out


def _cc_kernel(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Connected-component roots: each masked pixel ends with the minimum flat
    index of its component (+1); background is 0. Min-label propagation with
    pointer jumping, one host read per pass (counted in `_cc_kernel.passes`)."""
    H, W = mask.shape
    idx = (torch.arange(H * W, dtype=torch.int32, device=mask.device) + 1).reshape(H, W)
    INF = H * W + 2
    labels = torch.where(mask, idx, INF)
    offsets = N8 if connectivity == 8 else N4
    while True:
        neigh = labels
        for dy, dx in offsets:
            neigh = torch.minimum(neigh, _shift(labels, dy, dx, INF))
        new = torch.where(mask, torch.minimum(labels, neigh), INF)
        # pointer jumping: label <- label at the pixel the label points to
        flat = new.reshape(-1)
        jumped = torch.where(new < INF, flat[torch.clamp(new - 1, 0, H * W - 1).long()].reshape(H, W), INF)
        jumped = torch.where(mask, torch.minimum(new, jumped), INF)
        changed = bool(torch.any(jumped != labels))
        _cc_kernel.passes += 1
        labels = jumped
        if not changed:
            break
    return torch.where(mask, labels, 0)


_cc_kernel.passes = 0


def connected_components(mask, connectivity: int = 8, device="cuda") -> Tuple[np.ndarray, int]:
    """Label connected components of a boolean mask.

    Returns (labels [same shape, consecutive ints from 1], n_components)."""
    mask = np.asarray(mask).astype(bool)
    roots = _cc_kernel(_to(mask, device), connectivity).cpu().numpy()
    uniq, relabeled = np.unique(roots, return_inverse=True)
    labels = relabeled.reshape(mask.shape)
    if uniq[0] != 0:  # no background present
        return labels + 1, len(uniq)
    return labels, len(uniq) - 1


def _chamfer_kernel(mask: torch.Tensor) -> torch.Tensor:
    """Distance to the nearest background pixel (chamfer 3-4 metric / 3,
    matching cv2.DIST_L2 with a 3x3 mask), float32."""
    BIG = 1e9
    d = torch.where(mask, BIG, 0.0).to(torch.float32)
    a, b = 0.955, 1.3693  # cv2's optimal 3x3 chamfer weights for L2
    while True:
        best = d
        for dy, dx in N4:
            best = torch.minimum(best, _shift(d, dy, dx, BIG) + a)
        for dy, dx in N8[4:]:
            best = torch.minimum(best, _shift(d, dy, dx, BIG) + b)
        new = torch.where(mask, torch.minimum(d, best), 0.0)
        changed = bool(torch.any(new != d))
        d = new
        if not changed:
            return d


def distance_transform(mask, device="cuda") -> np.ndarray:
    """Distance transform of a boolean mask (chamfer; ~cv2 DIST_L2, 3x3)."""
    return _chamfer_kernel(_to(np.asarray(mask).astype(bool), device)).cpu().numpy()


def _local_max_kernel(X: torch.Tensor, min_distance: int) -> torch.Tensor:
    """Strict local maxima within a (2*min_distance+1)^2 window (-inf padded)."""
    k = 2 * min_distance + 1
    X = X.to(torch.float32)
    win_max = F.max_pool2d(X[None, None], k, stride=1, padding=k // 2)[0, 0]
    return (X >= win_max) & (X > 0)


def peak_local_max(X, min_distance: int = 1, mask: Optional[np.ndarray] = None, device="cuda") -> np.ndarray:
    """Coordinates-free peak finder: labeled peak raster (each peak plateau
    gets a unique positive id), the Watershed marker generator."""
    peaks = _local_max_kernel(_to(np.asarray(X), device, torch.float32), int(min_distance)).cpu().numpy()
    if mask is not None:
        peaks &= np.asarray(mask).astype(bool)
    labels, _ = connected_components(peaks, connectivity=8, device=device)
    return labels


def _watershed_kernel(
    elevation: torch.Tensor,
    markers: torch.Tensor,
    mask: torch.Tensor,
    n_levels: int = 64,
    inner_iter: int = 512,
) -> torch.Tensor:
    """Marker-controlled watershed by descending-level priority flood: within
    each level, masked unlabeled pixels adopt the label of their
    highest-elevation labeled neighbour (first in `N8` order on a tie) until
    a fixed point or `inner_iter` passes."""
    e = elevation.to(torch.float32)
    emin, emax = torch.min(e), torch.max(e)
    e = (e - emin) / torch.clamp_min(emax - emin, 1e-30)
    labels = torch.where(mask, markers, 0).to(torch.int32)
    NEG = -1e9

    def adopt(labels, active):
        best_e = torch.full_like(e, NEG)
        best_l = torch.zeros_like(labels)
        for dy, dx in N8:
            nl = _shift(labels, dy, dx, 0)
            ne = torch.where(nl > 0, _shift(e, dy, dx, NEG), NEG)
            take = ne > best_e
            best_e = torch.where(take, ne, best_e)
            best_l = torch.where(take, nl, best_l)
        adoptable = active & (labels == 0) & (best_l > 0)
        return torch.where(adoptable, best_l, labels)

    one, n = np.float32(1.0), np.float32(n_levels)
    for i in range(n_levels):
        # the level threshold in float32, as JAX computes it from the traced i
        thresh = float(one - (np.float32(i) + one) / n)
        active = mask & (e >= thresh)
        for _ in range(inner_iter):
            new = adopt(labels, active)
            changed = bool(torch.any(new != labels))
            labels = new
            if not changed:
                break
    return labels


def _label_cells_fused_kernel(
    mask_bits: torch.Tensor,  # the packed bits of the boolean mask (uint8)
    shape_rows: int,
    shape_cols: int,
    min_distance: int,
    max_labels: int,
    n_levels: int = 64,
):
    """The whole labeling chain on the device: unpack the mask -> chamfer
    distance transform -> local-max peak markers -> connected components of
    the peak plateaus -> distance-based watershed -> per-cell centroids from
    the peak plateaus. Returns (labels [H, W] int32, cnt, sy, sx
    [max_labels + 1] float32)."""
    H, W = shape_rows, shape_cols
    HW = H * W
    dev = mask_bits.device
    mask = unpackbits(mask_bits, HW).reshape(H, W)
    d = _chamfer_kernel(mask)
    peaks = _local_max_kernel(d, min_distance) & mask
    roots = _cc_kernel(peaks, 8)  # root = min flat index of plateau (+1)
    # the first max_labels peak pixels in flat order, padded with HW
    pos = torch.nonzero(peaks.reshape(-1)).reshape(-1)[:max_labels]
    pos = torch.cat([pos, torch.full((max_labels - pos.numel(),), HW, dtype=pos.dtype, device=dev)])
    valid = pos < HW
    rootvals = torch.where(valid, roots.reshape(-1)[torch.clamp_max(pos, HW - 1)], 2**30)
    # compact plateau ids: rank of each root's first occurrence in sorted
    # order, consistent per component, bounded by max_labels
    ids = torch.searchsorted(torch.sort(rootvals).values, rootvals).to(torch.int32)
    # the padded positions point one past the raster and are dropped
    markers = torch.zeros(HW + 1, dtype=torch.int32, device=dev)
    markers[pos] = ids + 1
    markers = markers[:HW].reshape(H, W)
    labels = _watershed_kernel(d, markers, mask, n_levels)
    # per-cell centroid from the peak plateau pixels; the sums are of
    # integers below 2^24, so exact in any order
    yyf = torch.div(pos, W, rounding_mode="floor").to(torch.float32)
    xxf = (pos % W).to(torch.float32)
    bins = torch.where(valid, ids.long() + 1, 0)
    vf = valid.to(torch.float32)
    zeros = torch.zeros(max_labels + 1, dtype=torch.float32, device=dev)
    cnt = zeros.index_add(0, bins, vf)
    sy = zeros.index_add(0, bins, yyf * vf)
    sx = zeros.index_add(0, bins, xxf * vf)
    return labels, cnt, sy, sx


def label_cells_from_mask(
    mask: np.ndarray,
    min_distance: int = 3,
    max_labels: Optional[int] = None,
    n_levels: int = 64,
    shape: Optional[Tuple[int, int]] = None,
    device="cuda",
):
    """Fused labeling: boolean mask -> watershed labels (a device tensor) +
    per-cell centroids (host [L, 2]).

    The mask goes to `device` bit-packed (an eighth of its bytes) and is
    unpacked there. With `shape` = (H, W), `mask` is already packed: the
    bytes of ``np.packbits(m.ravel())`` (`ops.bits.packbits` of a tensor),
    a host array or a tensor, e.g. left on the card by the Starro stream.

    Returns (labels, centroids): `labels` is the int32 label raster left on
    `device` for downstream chaining (pull it with ``.cpu().numpy()`` when the
    pixel assignment is needed); `centroids` are the peak-plateau means."""
    if shape is None:
        mask = np.asarray(mask).astype(bool)
        (H, W), bits = mask.shape, np.packbits(mask.reshape(-1))
    else:
        (H, W), bits = (int(shape[0]), int(shape[1])), mask
    if max_labels is None:
        # ceil of the densest packing of min_distance-separated peaks
        max_labels = max(int(H * W / max(min_distance, 1) ** 2), 1024)
    labels, cnt, sy, sx = _label_cells_fused_kernel(_to(bits, device), H, W, int(min_distance), int(max_labels),
                                                    n_levels)
    cnt, sy, sx = cnt.cpu().numpy(), sy.cpu().numpy(), sx.cpu().numpy()
    nz = cnt[1:] > 0
    cents = np.stack([sy[1:][nz] / cnt[1:][nz], sx[1:][nz] / cnt[1:][nz]], axis=1).astype(np.float32)
    return labels, cents


def watershed(elevation, markers, mask, n_levels: int = 64, device="cuda") -> np.ndarray:
    """Flood `mask` from `markers`, descending `elevation` (skimage
    `watershed(-elevation, markers, mask=mask)` semantics)."""
    return _watershed_kernel(
        _to(np.asarray(elevation), device, torch.float32),
        _to(np.asarray(markers), device, torch.int32),
        _to(np.asarray(mask).astype(bool), device),
        n_levels,
    ).cpu().numpy()


def _expand_labels_kernel(
    labels: torch.Tensor, mask: torch.Tensor, areas: torch.Tensor, max_area: int, distance: int, num_labels: int
) -> torch.Tensor:
    """Area-capped label expansion: each step, an unlabeled masked pixel
    adopts a neighbouring label iff its 4-neighbourhood contains exactly one
    unique positive label whose area (at the start of the step) is below
    `max_area`."""
    BIGL = 2**30
    for _ in range(distance):
        mx = torch.zeros_like(labels)
        mn = torch.full_like(labels, BIGL)
        for dy, dx in N4:
            nl = _shift(labels, dy, dx, 0)
            mx = torch.maximum(mx, nl)
            mn = torch.minimum(mn, torch.where(nl > 0, nl, BIGL))
        unique_one = (mx > 0) & (mn == mx)
        cand = unique_one & (labels == 0) & mask
        label_area = areas[torch.clamp(mx, 0, num_labels - 1).long()]
        adopt = cand & (label_area < max_area)
        labels = torch.where(adopt, mx, labels)
        added = torch.zeros_like(areas).index_add(0, torch.where(adopt, mx, 0).reshape(-1).long(),
                                                  adopt.reshape(-1).to(areas.dtype))
        added[0] = 0
        areas = areas + added
    return labels


def expand_labels_capped(
    labels: np.ndarray,
    distance: int,
    max_area: int,
    mask: Optional[np.ndarray] = None,
    device="cuda",
) -> np.ndarray:
    """Expand labels up to `distance` px, capping each label at `max_area`."""
    labels = np.asarray(labels).astype(np.int32)
    masked = labels[mask] if mask is not None else labels
    if (masked > 0).all() or (masked == 0).all():
        return labels
    num_labels = int(labels.max()) + 1
    areas = np.bincount(labels.ravel(), minlength=num_labels).astype(np.int32)
    mask_arr = np.ones(labels.shape, bool) if mask is None else np.asarray(mask).astype(bool)
    out = _expand_labels_kernel(_to(labels, device), _to(mask_arr, device), _to(areas, device), int(max_area),
                                int(distance), num_labels)
    return out.cpu().numpy()


def label_overlap(X: np.ndarray, Y: np.ndarray):
    """Sparse overlap-count matrix between two label arrays: one 2-D
    bincount on the host."""
    from scipy import sparse

    X = np.asarray(X).ravel()
    Y = np.asarray(Y).ravel()
    if X.shape != Y.shape:
        from ..errors import SegmentationError

        raise SegmentationError(f"Both arrays must have the same shape, but one is {X.shape} and the other is {Y.shape}.")
    nx, ny = int(X.max()) + 1, int(Y.max()) + 1
    flat = X.astype(np.int64) * ny + Y.astype(np.int64)
    counts = np.bincount(flat, minlength=nx * ny).reshape(nx, ny)
    return sparse.csr_matrix(counts.astype(np.uint64))


def find_boundaries(labels: np.ndarray, mode: str = "inner", device="cuda") -> np.ndarray:
    """Inner boundaries of labeled regions (skimage.segmentation.find_boundaries
    equivalent): pixels whose 4-neighbourhood contains a different label."""
    L = _to(np.asarray(labels), device)
    diff = torch.zeros(L.shape, dtype=torch.bool, device=L.device)
    for dy, dx in N4:
        diff = diff | (_shift(L, dy, dx, -1) != L)
    return (diff & (L > 0)).cpu().numpy()
