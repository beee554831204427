"""Labeling nuclei and cells after masking.

Counterpart of `spateo_tpu.segmentation.label`, built on the port's
`ops.labels` (connected components, distance transform, peaks, watershed,
capped expansion) on ``device=``. Labels equal the JAX package's exactly;
the layers written are host arrays.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configuration import SKM
from ..core.anndata import AnnData
from ..core.bridge import _to_device
from ..errors import SegmentationError
from ..logging import logger_manager as lm
from ..ops.image import conv2d
from ..ops.labels import (
    _watershed_kernel,
    connected_components,
    distance_transform,
    expand_labels_capped,
    label_cells_from_mask,
    peak_local_max,
)
from ..ops.threshold import threshold_otsu
from . import utils


def _replace_labels(labels: np.ndarray, mapping: Dict[int, int]) -> np.ndarray:
    """Apply a label -> label mapping through a lookup table."""
    labels = np.asarray(labels)
    replacement = np.arange(labels.max() + 1)
    for from_label, to_label in mapping.items():
        replacement[from_label] = to_label
    return replacement[labels]


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def replace_labels(adata: AnnData, layer: str, mapping: Dict[int, int], out_layer: Optional[str] = None):
    """Replace labels according to a mapping."""
    labels = SKM.select_layer_data(adata, layer)
    SKM.set_layer_data(adata, out_layer or layer, _replace_labels(labels, mapping))


def _watershed(X: np.ndarray, mask: np.ndarray, markers: np.ndarray, k: int, device="cuda") -> np.ndarray:
    """Gaussian-blur X and flood `mask` from `markers`, descending the blur
    (skimage ``watershed(-blur, markers, mask)``)."""
    blur = conv2d(X, k, mode="gauss", device=device)
    if markers.dtype == np.dtype(bool):
        markers = connected_components(markers, device=device)[0]
    return _watershed_kernel(
        blur, _to_device(markers, blur.device, torch.int32), _to_device(np.asarray(mask, bool), blur.device)
    ).cpu().numpy()


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def find_peaks_with_erosion(
    adata: AnnData,
    layer: str = SKM.STAIN_LAYER_KEY,
    k: int = 3,
    square: bool = False,
    min_area: int = 80,
    n_iter: int = -1,
    float_k: int = 5,
    float_threshold: Optional[float] = None,
    out_layer: Optional[str] = None,
    device="cuda",
):
    """Watershed markers by iterative safe erosion."""
    _layer1 = SKM.gen_new_layer_key(layer, SKM.SCORES_SUFFIX)
    _layer2 = SKM.gen_new_layer_key(layer, SKM.MASK_SUFFIX)
    if _layer1 not in adata.layers and _layer2 not in adata.layers and layer not in adata.layers:
        raise SegmentationError(
            f'Neither "{_layer1}", "{_layer2}", nor "{layer}" are present in AnnData. '
            "Please run either `st.cs.mask_nuclei_from_stain` or `st.cs.score_and_mask_pixels` first."
        )
    _layer = _layer1 if _layer1 in adata.layers else (_layer2 if _layer2 in adata.layers else layer)
    X = np.asarray(SKM.select_layer_data(adata, _layer, make_dense=True))
    if np.issubdtype(X.dtype, np.floating) and not float_threshold:
        float_threshold = threshold_otsu(X, device=device)
    markers = utils.safe_erode(X, k, square, min_area, n_iter, float_k, float_threshold, device=device)
    SKM.set_layer_data(adata, out_layer or SKM.gen_new_layer_key(layer, SKM.MARKERS_SUFFIX), markers)


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def watershed_fused(
    adata: AnnData,
    layer: str = SKM.STAIN_LAYER_KEY,
    min_distance: int = 3,
    mask_layer: Optional[str] = None,
    out_layer: Optional[str] = None,
    centroids_key: str = "cell_centroids",
    device="cuda",
):
    """The whole labeling chain (distance transform, peak markers, their
    components, distance watershed, per-cell centroids) on the device
    (`ops.labels.label_cells_from_mask`). Writes ``{layer}_labels`` and the
    [L, 2] centroids to ``adata.uns[centroids_key]``, and returns them."""
    mask_layer = mask_layer or SKM.gen_new_layer_key(layer, SKM.MASK_SUFFIX)
    mask = np.asarray(SKM.select_layer_data(adata, mask_layer)).astype(bool)
    labels, cents = label_cells_from_mask(mask, min_distance=min_distance, device=device)
    SKM.set_layer_data(adata, out_layer or SKM.gen_new_layer_key(layer, SKM.LABELS_SUFFIX), labels.cpu().numpy())
    adata.uns[centroids_key] = cents
    return cents


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def watershed(
    adata: AnnData,
    layer: str = SKM.STAIN_LAYER_KEY,
    k: int = 3,
    mask_layer: Optional[str] = None,
    markers_layer: Optional[str] = None,
    out_layer: Optional[str] = None,
    device="cuda",
):
    """Assign individual nuclei or cells with the watershed algorithm."""
    X = np.asarray(SKM.select_layer_data(adata, layer, make_dense=True))
    mask = np.asarray(SKM.select_layer_data(adata, mask_layer or SKM.gen_new_layer_key(layer, SKM.MASK_SUFFIX)))
    markers_layer = markers_layer or SKM.gen_new_layer_key(layer, SKM.MARKERS_SUFFIX)
    markers = np.asarray(SKM.select_layer_data(adata, markers_layer))
    labels = _watershed(X, mask.astype(bool) | (markers > 0), markers, k, device)
    areas = np.bincount(labels.ravel())
    if (areas[1:] > 10000).any():
        lm.main_warning(
            "Some labels have area greater than 10000. If you are segmenting based on RNA, consider "
            "using `st.cs.label_connected_components` instead."
        )
    SKM.set_layer_data(adata, out_layer or SKM.gen_new_layer_key(layer, SKM.LABELS_SUFFIX), labels)


def _expand_labels(labels: np.ndarray, distance: int, max_area: int, mask: Optional[np.ndarray] = None,
                   device="cuda") -> np.ndarray:
    """Area-capped expansion."""
    return expand_labels_capped(labels, distance, max_area, mask, device=device)


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def expand_labels(
    adata: AnnData,
    layer: str,
    distance: int = 5,
    max_area: int = 400,
    mask_layer: Optional[str] = None,
    out_layer: Optional[str] = None,
    device="cuda",
):
    """Expand labels up to `distance` pixels, each up to `max_area`."""
    label_layer = SKM.gen_new_layer_key(layer, SKM.LABELS_SUFFIX)
    if label_layer not in adata.layers:
        label_layer = layer
    labels = np.asarray(SKM.select_layer_data(adata, label_layer))
    mask = np.asarray(SKM.select_layer_data(adata, mask_layer)).astype(bool) if mask_layer else None
    expanded = _expand_labels(labels, distance, max_area, mask=mask, device=device)
    SKM.set_layer_data(adata, out_layer or SKM.gen_new_layer_key(label_layer, SKM.EXPANDED_SUFFIX), expanded)


def _label_connected_components(
    X: np.ndarray,
    area_threshold: int = 500,
    k: int = 3,
    min_area: int = 100,
    n_iter: int = -1,
    distance: int = 8,
    max_area: int = 400,
    seed_labels: Optional[np.ndarray] = None,
    device="cuda",
) -> np.ndarray:
    """Label connected components, splitting those above `area_threshold`
    by safe erosion and re-expansion."""
    X = np.asarray(X).astype(bool)
    comps, n = connected_components(X, device=device)
    areas = np.bincount(comps.ravel(), minlength=n + 1)
    seeded = np.zeros(n + 1, dtype=bool)
    if seed_labels is not None:
        overlaps = utils.label_overlap(comps, (np.asarray(seed_labels) > 0).astype(int))
        seeded[: overlaps.shape[0]] = np.asarray(overlaps[:, 1:].sum(axis=1)).ravel() > 0
        seeded[0] = False

    small = (areas <= area_threshold) & ~seeded
    small[0] = False
    to_erode_ids = np.where((areas > area_threshold) & ~seeded)[0]
    to_erode_ids = to_erode_ids[to_erode_ids != 0]  # label 0 is background

    saved = np.zeros(X.shape, dtype=int)
    saved_i = (int(seed_labels.max()) + 1) if seed_labels is not None else 1
    small_ids = np.where(small)[0]
    if small_ids.size:
        remap = np.zeros(n + 1, dtype=int)
        remap[small_ids] = np.arange(len(small_ids)) + saved_i
        saved = remap[comps]
        saved_i += len(small_ids)

    to_erode = np.isin(comps, to_erode_ids)
    if to_erode.any():
        eroded = utils.safe_erode(to_erode, k=k, min_area=min_area, n_iter=n_iter, device=device)
        labels, _ = connected_components(eroded, device=device)
        labels = np.where(labels > 0, labels + saved_i - 1, 0)
    elif seed_labels is None:
        return saved
    else:
        labels = np.zeros_like(saved)
    if seed_labels is not None:
        labels = labels + np.asarray(seed_labels)
    expanded = _expand_labels(labels, distance=distance, max_area=max_area, mask=X > 0, device=device)
    return saved + expanded


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def label_connected_components(
    adata: AnnData,
    layer: str,
    seed_layer: Optional[str] = None,
    area_threshold: int = 500,
    k: int = 3,
    min_area: int = 100,
    n_iter: int = -1,
    distance: int = 8,
    max_area: int = 400,
    out_layer: Optional[str] = None,
    device="cuda",
):
    """Label connected components, splitting the large ones."""
    mask_layer = SKM.gen_new_layer_key(layer, SKM.MASK_SUFFIX)
    if mask_layer not in adata.layers:
        mask_layer = layer
    mask = np.asarray(SKM.select_layer_data(adata, mask_layer))
    seed_labels = np.asarray(SKM.select_layer_data(adata, seed_layer)) if seed_layer else None
    labels = _label_connected_components(
        mask, area_threshold, k, min_area, n_iter, distance, max_area, seed_labels, device
    )
    SKM.set_layer_data(adata, out_layer or SKM.gen_new_layer_key(layer, SKM.LABELS_SUFFIX), labels)


def _find_peaks(X: np.ndarray, min_distance: int = 1, device="cuda", **kwargs) -> np.ndarray:
    """Label local maxima (each peak plateau a unique id)."""
    return peak_local_max(X, min_distance=min_distance, device=device)


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def find_peaks(
    adata: AnnData,
    layer: str,
    k: int,
    min_distance: int,
    mask_layer: Optional[str] = None,
    out_layer: Optional[str] = None,
    device="cuda",
):
    """Blur, then find peaks."""
    X = np.asarray(SKM.select_layer_data(adata, layer, make_dense=True))
    if X.dtype == np.dtype(bool):
        raise SegmentationError(
            f"Layer {layer} contains a boolean array. Please use `st.cs.find_peaks_from_mask` instead."
        )
    peaks = _find_peaks(conv2d(X, k, mode="gauss", device=device).cpu().numpy(), min_distance, device)
    if mask_layer:
        peaks = peaks * np.asarray(SKM.select_layer_data(adata, mask_layer))
    SKM.set_layer_data(adata, out_layer or SKM.gen_new_layer_key(layer, SKM.MARKERS_SUFFIX), peaks)


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def find_peaks_from_mask(
    adata: AnnData,
    layer: str,
    min_distance: int,
    distances_layer: Optional[str] = None,
    markers_layer: Optional[str] = None,
    device="cuda",
):
    """Peaks of a boolean mask's distance transform, as watershed markers."""
    mask_layer = SKM.gen_new_layer_key(layer, SKM.MASK_SUFFIX)
    if mask_layer not in adata.layers:
        mask_layer = layer
    mask = np.asarray(SKM.select_layer_data(adata, mask_layer))
    if mask.dtype != np.dtype(bool):
        raise SegmentationError(f"Only boolean masks are supported for this function, but got {mask.dtype} instead.")
    distances = distance_transform(mask, device=device)
    peaks = _find_peaks(distances, min_distance, device)
    SKM.set_layer_data(adata, distances_layer or SKM.gen_new_layer_key(layer, SKM.DISTANCES_SUFFIX), distances)
    SKM.set_layer_data(adata, markers_layer or SKM.gen_new_layer_key(layer, SKM.MARKERS_SUFFIX), peaks)


def _augment_labels(source_labels: np.ndarray, target_labels: np.ndarray) -> np.ndarray:
    """Keep target labels that overlap the source; copy over source labels
    with no target overlap, from one overlap matrix."""
    source_labels = np.asarray(source_labels)
    target_labels = np.asarray(target_labels)
    overlap = utils.label_overlap(target_labels, source_labels).toarray()
    t_keep = np.where(overlap[:, 1:].sum(axis=1) > 0)[0]
    t_keep = t_keep[t_keep > 0]
    s_copy = np.where(overlap.T[:, 1:].sum(axis=1) == 0)[0]
    s_copy = s_copy[s_copy > 0]

    label = 1
    t_map = np.zeros(int(target_labels.max()) + 1, dtype=int)
    for _label in t_keep:
        t_map[_label] = label
        label += 1
    augmented = t_map[target_labels]
    s_map = np.zeros(int(source_labels.max()) + 1, dtype=int)
    for _label in s_copy:
        s_map[_label] = label
        label += 1
    source_mapped = s_map[source_labels]
    return np.where((augmented == 0) & (source_mapped > 0), source_mapped, augmented)


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def augment_labels(adata: AnnData, source_layer: str, target_layer: str, out_layer: Optional[str] = None):
    """Augment one label layer with another."""
    source_labels = np.asarray(SKM.select_layer_data(adata, source_layer))
    target_labels = np.asarray(SKM.select_layer_data(adata, target_layer))
    augmented = _augment_labels(source_labels, target_labels)
    SKM.set_layer_data(adata, out_layer or SKM.gen_new_layer_key(target_layer, SKM.AUGMENTED_SUFFIX), augmented)
