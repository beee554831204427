"""Segmentation evaluation metrics (counterpart of
`spateo_tpu.segmentation.simulation_evaluation.evaluation`; reference
simulation_evaluation/evaluation.py:6-47).

The JAX package asks scikit-learn for the adjusted mutual information and
the F1 score; the GPU machine has none, so both are scikit-learn 1.9's
computations, ported step for step in numpy on the host
(`adjusted_mutual_info_score` with its expected mutual information and the
arithmetic mean of the entropies; `f1_score` for binary labels).
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import gammaln

_EPS = np.finfo("float64").eps
#: (i, j, n_ij) terms of the expected mutual information evaluated at once.
_EMI_BLOCK = 1 << 22


def _contingency(labels_true: np.ndarray, labels_pred: np.ndarray):
    """Rows (classes), columns (clusters) and the nonzero counts of the
    contingency table in row-major order, as scikit-learn's CSR holds them."""
    _, ci = np.unique(labels_true, return_inverse=True)
    _, ki = np.unique(labels_pred, return_inverse=True)
    n_k = int(ki.max()) + 1
    codes, nz_val = np.unique(ci.astype(np.int64) * n_k + ki, return_counts=True)
    nzx, nzy = np.divmod(codes, n_k)
    a = np.bincount(ci).astype(np.int64)
    b = np.bincount(ki).astype(np.int64)
    return nzx, nzy, nz_val.astype(np.int64), a, b


def _mutual_info(nzx, nzy, nz_val, a, b) -> float:
    """scikit-learn's `mutual_info_score` from the contingency table."""
    if a.size == 1 or b.size == 1:
        return 0.0
    contingency_sum = nz_val.sum()
    log_contingency_nm = np.log(nz_val)
    contingency_nm = nz_val / contingency_sum
    outer = a.take(nzx).astype(np.int64) * b.take(nzy).astype(np.int64)
    log_outer = -np.log(outer) + math.log(a.sum()) + math.log(b.sum())
    mi = contingency_nm * (log_contingency_nm - math.log(contingency_sum)) + contingency_nm * log_outer
    mi = np.where(np.abs(mi) < _EPS, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def _expected_mutual_information(a: np.ndarray, b: np.ndarray, n_samples: int) -> float:
    """scikit-learn's `expected_mutual_information` (a Cython triple loop
    over classes i, clusters j and n_ij): the same terms, evaluated in
    blocks, summed one after another in the loop's order."""
    if a.size == 1 or b.size == 1:
        return 0.0
    nijs = np.arange(0, max(np.max(a), np.max(b)) + 1, dtype="float")
    nijs[0] = 1
    term1 = nijs / n_samples
    log_a, log_b = np.log(a), np.log(b)
    log_Nnij = np.log(n_samples) + np.log(nijs)
    gln_a, gln_b = gammaln(a + 1), gammaln(b + 1)
    gln_Na, gln_Nb = gammaln(n_samples - a + 1), gammaln(n_samples - b + 1)
    gln_Nnij = gammaln(nijs + 1) + gammaln(n_samples + 1)

    starts = np.maximum(1, a[:, None] - n_samples + b[None, :]).ravel()
    lengths = np.maximum(np.minimum(a[:, None], b[None, :]) + 1 - starts.reshape(len(a), len(b)), 0).ravel()
    ends = np.cumsum(lengths)
    total = int(ends[-1])
    emi, pair, done = 0.0, 0, 0
    while done < total:
        stop = int(np.searchsorted(ends, done + _EMI_BLOCK, side="right"))
        stop = max(stop, pair + 1)
        pairs = np.arange(pair, stop)
        rep = np.repeat(pairs, lengths[pairs])
        first = np.repeat(ends[pairs] - lengths[pairs], lengths[pairs])
        nij = starts[rep] + (np.arange(done, done + len(rep)) - first)
        i, j = np.divmod(rep, len(b))
        ai, bj = a[i], b[j]
        term2 = log_Nnij[nij] - log_a[i] - log_b[j]
        gln = (gln_a[i] + gln_b[j] + gln_Na[i] + gln_Nb[j] - gln_Nnij[nij] - gammaln(ai - nij + 1)
               - gammaln(bj - nij + 1) - gammaln(n_samples - ai - bj + nij + 1))
        terms = term1[nij] * term2 * np.exp(gln)
        emi = float(np.cumsum(np.concatenate([[emi], terms]))[-1])
        done += len(rep)
        pair = stop
    return emi


def _entropy(counts: np.ndarray) -> float:
    pi = counts.astype(np.float64)
    if pi.size == 1:
        return 0.0
    pi_sum = np.sum(pi)
    return float(-np.sum((pi / pi_sum) * (np.log(pi) - math.log(pi_sum))))


def adjusted_mutual_info_score(labels_true, labels_pred) -> float:
    """scikit-learn 1.9's `adjusted_mutual_info_score(labels_true,
    labels_pred)` (``average_method="arithmetic"``): (MI - E[MI]) /
    (mean(H_true, H_pred) - E[MI]), each of the two kept at least eps away
    from 0 with its sign; 1.0 when neither labeling is split, 0.0 when only
    one is."""
    labels_true, labels_pred = np.asarray(labels_true).ravel(), np.asarray(labels_pred).ravel()
    if labels_true.shape != labels_pred.shape:
        raise ValueError("labels_true and labels_pred must have the same length")
    n_samples = labels_true.shape[0]
    n_classes, n_clusters = len(np.unique(labels_true)), len(np.unique(labels_pred))
    if n_classes == n_clusters == 1 or n_classes == n_clusters == 0:
        return 1.0
    if n_classes == 1 or n_clusters == 1:
        return 0.0
    nzx, nzy, nz_val, a, b = _contingency(labels_true, labels_pred)
    mi = _mutual_info(nzx, nzy, nz_val, a, b)
    emi = _expected_mutual_information(a, b, n_samples)
    h_true, h_pred = _entropy(a), _entropy(b)
    denominator = np.mean([h_true, h_pred]) - emi
    denominator = min(denominator, -_EPS) if denominator < 0 else max(denominator, _EPS)
    numerator = mi - emi
    numerator = min(numerator, -_EPS) if numerator < 0 else max(numerator, _EPS)
    return float(numerator / denominator)


def f1_score(y_true, y_pred) -> float:
    """scikit-learn 1.9's `f1_score(y_true, y_pred)` for binary labels
    (``pos_label=1``): 2 tp / (true positives + predicted positives), and
    0.0 where both are 0. More than two labels, or two without 1, raise."""
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    present = np.union1d(y_true, y_pred)
    if len(present) > 2:
        raise ValueError("Target is multiclass but average='binary'. Please choose another average setting.")
    if len(present) == 2 and 1 not in present:
        raise ValueError(f"pos_label=1 is not a valid label. It should be one of {list(present)}")
    t, p = y_true == 1, y_pred == 1
    tp = float(np.count_nonzero(t & p))
    denom = float(np.count_nonzero(t)) + float(np.count_nonzero(p))
    return 0.0 if denom == 0 else 2 * tp / denom


def cal_ami(a1: np.ndarray, a2: np.ndarray) -> float:
    """Adjusted mutual information between label images (parity:
    evaluation.py:6)."""
    l1, l2 = (np.asarray(a).astype(np.int32).ravel() for a in (a1, a2))
    return float(adjusted_mutual_info_score(l1, l2))


def cal_f1score(a1: np.ndarray, a2: np.ndarray, binary: bool = True) -> float:
    """F1 score, binarized by default (parity: evaluation.py:13)."""
    l1 = np.asarray(a1).astype(np.int32).copy()
    l2 = np.asarray(a2).astype(np.int32).copy()
    if binary:
        l1[l1 > 0] = 1
        l2[l2 > 0] = 1
    return float(f1_score(l1.ravel(), l2.ravel()))


def cal_precision(a1: np.ndarray, a2: np.ndarray, tau: float = 0.5) -> float:
    """Object-level precision at IoU >= tau (parity: evaluation.py:23):
    the per-(pred, gt) overlap matrix in one pass."""
    pred = np.asarray(a1).astype(np.int64).ravel()
    gt = np.asarray(a2).astype(np.int64).ravel()
    n_pred, n_gt = pred.max() + 1, gt.max() + 1
    overlap = np.zeros((n_pred, n_gt), np.int64)
    np.add.at(overlap, (pred, gt), 1)
    pred_sizes = overlap.sum(1)
    gt_sizes = overlap.sum(0)
    inter = overlap[1:, 1:]
    union = pred_sizes[1:, None] + gt_sizes[None, 1:] - inter
    iou = inter / np.maximum(union, 1)
    hit = iou >= tau
    tp = int((hit.any(axis=1) & (pred_sizes[1:] > 0)).sum())
    pred_ids = int((pred_sizes[1:] > 0).sum())
    gt_ids = int((gt_sizes[1:] > 0).sum())
    matched_gt = int((hit.any(axis=0) & (gt_sizes[1:] > 0)).sum())
    fp = pred_ids - tp
    fn = gt_ids - matched_gt
    return tp / max(tp + fp + fn, 1)
