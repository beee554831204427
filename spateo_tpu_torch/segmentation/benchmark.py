"""Segmentation benchmarking: occupancy and labeling statistics of a
predicted label layer against a true one.

Counterpart of `spateo_tpu.segmentation.benchmark`, host numpy. The JAX
package takes the pair confusion matrix, the confusion matrix and
homogeneity, completeness and V-measure from scikit-learn; here they are
computed from the contingency table with scikit-learn's formulas (no
scikit-learn on the GPU machine).
"""

from __future__ import annotations

from math import log
from typing import Optional, Tuple

import numpy as np
import pandas as pd
from scipy import sparse

from ..configuration import SKM
from ..core.anndata import AnnData
from ..errors import SegmentationError
from ..logging import logger_manager as lm
from ..ops.labels import label_overlap


def _contingency(y_true: np.ndarray, y_pred: np.ndarray) -> sparse.csr_matrix:
    """[classes, clusters] counts, both sides in sorted label order."""
    classes, ci = np.unique(np.asarray(y_true), return_inverse=True)
    clusters, ki = np.unique(np.asarray(y_pred), return_inverse=True)
    return sparse.coo_matrix(
        (np.ones(ci.shape[0], dtype=np.int64), (ci.ravel(), ki.ravel())), shape=(classes.shape[0], clusters.shape[0])
    ).tocsr()


def _pair_confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    n = np.int64(np.asarray(y_true).shape[0])
    c = _contingency(y_true, y_pred)
    n_c = np.ravel(c.sum(axis=1))
    n_k = np.ravel(c.sum(axis=0))
    sum_squares = (c.data**2).sum()
    C = np.empty((2, 2), dtype=np.int64)
    C[1, 1] = sum_squares - n
    C[0, 1] = c.dot(n_k).sum() - sum_squares
    C[1, 0] = c.transpose().dot(n_c).sum() - sum_squares
    C[0, 0] = n**2 - C[0, 1] - C[1, 0] - sum_squares
    return C


def _entropy(labels: np.ndarray) -> float:
    if len(labels) == 0:
        return 1.0
    pi = np.bincount(np.unique(labels, return_inverse=True)[1].ravel()).astype(np.float64)
    pi = pi[pi > 0]
    if pi.size == 1:
        return 0.0
    pi_sum = np.sum(pi)
    return float(-np.sum((pi / pi_sum) * (np.log(pi) - log(pi_sum))))


def _mutual_info(c: sparse.csr_matrix) -> float:
    nzx, nzy, nz_val = sparse.find(c)
    total = c.sum()
    pi = np.ravel(c.sum(axis=1))
    pj = np.ravel(c.sum(axis=0))
    if pi.size == 1 or pj.size == 1:
        return 0.0
    nm = nz_val / total
    outer = pi.take(nzx).astype(np.int64, copy=False) * pj.take(nzy).astype(np.int64, copy=False)
    log_outer = -np.log(outer) + log(pi.sum()) + log(pj.sum())
    mi = nm * (np.log(nz_val) - log(total)) + nm * log_outer
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def adjusted_rand_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Overflow-safe ARI."""
    (tn, fp), (fn, tp) = _pair_confusion_matrix(y_true, y_pred)
    tn, tp, fp, fn = int(tn), int(tp), int(fp), int(fn)
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def iou(labels1: np.ndarray, labels2: np.ndarray) -> sparse.csr_matrix:
    """Pairwise label IoU matrix over the overlaps' sparsity pattern."""
    labels1 = np.asarray(labels1)
    labels2 = np.asarray(labels2)
    areas1 = np.bincount(labels1.ravel())
    areas2 = np.bincount(labels2.ravel())
    overlaps = label_overlap(labels1, labels2).astype(float).tocoo()
    union = areas1[overlaps.row] + areas2[overlaps.col] - overlaps.data
    return sparse.csr_matrix((overlaps.data / union, (overlaps.row, overlaps.col)), shape=overlaps.shape)


def average_precision(iou: sparse.csr_matrix, tau: float = 0.5) -> float:
    """AP at IoU threshold `tau`."""
    tp = (iou > tau).sum()
    fp = iou.shape[1] - tp - 1
    fn = iou.shape[0] - tp - 1
    return tp / (tp + fn + fp)


def classification_stats(y_true: np.ndarray, y_pred: np.ndarray) -> Tuple[float, ...]:
    """Binary occupancy confusion statistics: (TN rate, FP rate, FN rate,
    recall, precision, accuracy, F1)."""
    t = np.asarray(y_true).ravel() > 0
    p = np.asarray(y_pred).ravel() > 0
    pos, neg = t.sum(), (~t).sum()
    tn, fp, fn, tp = (np.int64(np.sum(a & b)) for a, b in ((~t, ~p), (~t, p), (t, ~p), (t, p)))
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    accuracy = (tp + tn) / (tp + tn + fp + fn)
    f1 = 2 * precision * recall / (precision + recall)
    return (tn / neg, fp / neg, fn / pos, recall, precision, accuracy, f1)


def labeling_stats(y_true: np.ndarray, y_pred: np.ndarray) -> Tuple[float, float, float, float]:
    """ARI, homogeneity, completeness and V-measure."""
    ars = adjusted_rand_score(y_true, y_pred)
    if len(y_true) == 0:
        return ars, 1.0, 1.0, 1.0
    entropy_c, entropy_k = _entropy(y_true), _entropy(y_pred)
    mi = _mutual_info(_contingency(y_true, y_pred))
    homogeneity = mi / entropy_c if entropy_c else 1.0
    completeness = mi / entropy_k if entropy_k else 1.0
    v = 0.0 if homogeneity + completeness == 0.0 else 2 * homogeneity * completeness / (homogeneity + completeness)
    return ars, homogeneity, completeness, v


def _generate_random_labels(shape: Tuple[int, int], areas, seed: Optional[int] = None) -> np.ndarray:
    """Labels of the given areas scattered at random pixels."""
    n = int(np.prod(shape))
    if sum(areas) > n:
        raise SegmentationError("Sum of `areas` exceeds the total area")
    rng = np.random.default_rng(seed)
    labels = np.zeros(n, dtype=int)
    indices = np.arange(n)
    rng.shuffle(indices)
    for i, area in enumerate(areas):
        labels[indices[:area]] = i + 1
        indices = indices[area:]
    return labels.reshape(shape)


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def compare(
    adata: AnnData,
    true_layer: str,
    pred_layer: str,
    data_layer: str = SKM.X_LAYER,
    umi_pixels_only: bool = True,
    random_background: bool = True,
    ap_taus: Tuple[float, ...] = tuple(np.arange(0.5, 1, 0.05)),
    seed: Optional[int] = None,
) -> pd.DataFrame:
    """Segmentation statistics of `pred_layer` against `true_layer` (and of
    random labels of the same areas, with `random_background`)."""

    def _stats(y_true, y_pred):
        tn, fp, fn, tp, precision, accuracy, f1 = classification_stats(y_true, y_pred)
        both_labeled = (y_true > 0) & (y_pred > 0)
        ars, homogeneity, completeness, v = labeling_stats(y_true[both_labeled], y_pred[both_labeled])
        return [tn, fp, fn, tp, precision, accuracy, f1, ars, homogeneity, completeness, v]

    def _ap(y_true, y_pred, taus):
        _iou = iou(y_true, y_pred)
        return [average_precision(_iou, tau) for tau in taus]

    y_true = np.asarray(SKM.select_layer_data(adata, true_layer))
    y_pred = np.asarray(SKM.select_layer_data(adata, pred_layer))
    if umi_pixels_only:
        umi_mask = np.asarray(SKM.select_layer_data(adata, data_layer, make_dense=True)) > 0
        y_true = y_true[umi_mask]
        y_pred = y_pred[umi_mask]

    lm.main_info("Computing statistics.")
    data = {pred_layer: _stats(y_true, y_pred) + _ap(y_true, y_pred, ap_taus)}
    if random_background:
        bincount = np.bincount(y_pred.ravel())
        y_random = _generate_random_labels(y_pred.shape, bincount[1:], seed)
        data["background"] = _stats(y_true, y_random) + _ap(y_true, y_random, ap_taus)
    return pd.DataFrame(
        data,
        index=[
            "True negative",
            "False positive",
            "False negative",
            "True positive",
            "Precision",
            "Accuracy",
            "F1 score",
            "Adjusted rand score",
            "Homogeneity",
            "Completeness",
            "V measure",
        ]
        + [f"Average precision ({tau:.2f})" for tau in ap_taus],
    )
