"""Label containers and label matching (capability parity: reference
spateo/tools/labels.py:18-420).

Counterpart of `spateo_tpu.tools.labels`: host code, copied.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple, Union

import numpy as np
import scipy.optimize
import scipy.sparse

from ..logging import logger_manager as lm


def row_normalize(graph: scipy.sparse.csr_matrix, copy: bool = False, verbose: bool = True) -> scipy.sparse.csr_matrix:
    """Row-normalize a CSR matrix (parity: labels.py:18) — vectorized over
    rows instead of a per-row pointer loop."""
    if copy:
        graph = graph.copy()
    row_sums = np.asarray(graph.sum(axis=1)).ravel()
    scale = np.where(row_sums != 0, 1.0 / np.where(row_sums == 0, 1, row_sums), 0.0)
    D = scipy.sparse.diags(scale)
    out = D @ graph
    graph.data[:] = out.tocsr().data
    return graph


class Label:
    """Categorizations of a point set (parity: reference labels.py:71)."""

    def __init__(self, labels_dense: Union[np.ndarray, list], str_map: Optional[dict] = None, verbose: bool = False):
        if isinstance(labels_dense, list):
            labels_dense = np.asarray(labels_dense, dtype=np.int32)
        if not isinstance(labels_dense, np.ndarray):
            raise TypeError(f"Labels provided are of type {type(labels_dense)}; should be list or 1-d ndarray.")
        if labels_dense.ndim != 1:
            raise ValueError(f"Label array has {labels_dense.ndim} dimensions, should be 1-dimensional.")
        if not np.issubdtype(labels_dense.dtype, np.integer):
            raise TypeError(f"Label array data type is {labels_dense.dtype}, should be integer.")
        if np.amin(labels_dense) < 0:
            raise ValueError("All labels must be 0 or positive integers.")
        self.dense = labels_dense
        self.str_map = str_map
        self.num_samples = len(labels_dense)
        self.bins = np.bincount(self.dense)
        self.ids = np.nonzero(self.bins)[0]
        self.counts = self.bins[self.ids]
        self.max_id = int(np.amax(self.ids))
        self.num_labels = len(self.ids)
        self.onehot = None
        self.normalized_onehot = None

    def __repr__(self) -> str:
        return f"{self.num_labels} labels, {self.num_samples} samples, ids: {self.ids}, counts: {self.counts}"

    def __str__(self) -> str:
        return self.__repr__()

    def get_onehot(self) -> scipy.sparse.csr_matrix:
        if self.onehot is None:
            self.onehot = self.generate_onehot()
        return self.onehot

    def get_normalized_onehot(self) -> scipy.sparse.csr_matrix:
        if self.normalized_onehot is None:
            self.normalized_onehot = self.generate_normalized_onehot()
        return self.normalized_onehot

    def generate_normalized_onehot(self) -> scipy.sparse.csr_matrix:
        return row_normalize(self.get_onehot().astype(np.float64), copy=True)

    def generate_onehot(self) -> scipy.sparse.csr_matrix:
        """One-hot [num_labels, num_samples] sparse indicator."""
        rows = np.searchsorted(self.ids, self.dense)
        cols = np.arange(self.num_samples)
        data = np.ones(self.num_samples, dtype=np.int32)
        return scipy.sparse.csr_matrix((data, (rows, cols)), shape=(self.num_labels, self.num_samples))


def _rand_binary_array(array_length: int, num_onbits: int) -> np.ndarray:
    array = np.zeros(array_length, dtype=np.int32)
    array[:num_onbits] = 1
    np.random.shuffle(array)
    return array


def expand_labels(label: Label, max_label_id: int, sort_labels: bool = False) -> Label:
    """Spread label ids evenly across [0, max_label_id] (parity: labels.py:216)."""
    ids = np.sort(copy.copy(label.ids)) if sort_labels else copy.copy(label.ids)
    ids_zeroed = ids - np.amin(label.ids)
    num_extra = max_label_id - np.amax(ids_zeroed)
    if label.num_labels <= 1:
        return Label(label.dense.copy())
    multiple, remainder = np.divmod(num_extra, label.num_labels - 1)
    inserted = np.arange(label.num_labels) * multiple
    extra = _rand_binary_array(label.num_labels - 1, remainder)
    expanded_ids = ids_zeroed + inserted
    expanded_ids[1:] += np.cumsum(extra)
    expanded_dense = (expanded_ids @ label.get_onehot()).astype(np.int32)
    return Label(expanded_dense)


def match_labels(labels_1: Label, labels_2: Label, extra_labels_assignment: str = "random", verbose: bool = False) -> Label:
    """Relabel the second set to best match the first by Hungarian assignment
    on the overlap matrix (parity: labels.py:258)."""
    max_id = max(labels_1.max_id, labels_2.max_id)
    num_extra_labels = labels_2.num_labels - labels_1.num_labels
    cost = (labels_1.get_onehot() @ labels_2.get_onehot().T).toarray()
    m1, m2 = scipy.optimize.linear_sum_assignment(cost, maximize=True)

    available = list(range(max_id + 1))
    relabeled = -1 * np.ones(labels_2.num_labels, dtype=np.int32)
    for i1, i2 in zip(m1, m2):
        relabeled[i2] = labels_1.ids[i1]
        available.remove(labels_1.ids[i1])
    if num_extra_labels > 0:
        unmatched = np.nonzero(relabeled == -1)[0]
        if extra_labels_assignment == "random":
            relabeled[unmatched] = np.random.choice(available, size=len(unmatched), replace=False)
        else:  # greedy: place extras in the widest gaps of used ids
            used = sorted(relabeled[relabeled >= 0])
            for u in unmatched:
                intervals = np.diff(used)
                gap = int(np.argmax(intervals)) if len(intervals) else 0
                new_id = (used[gap] + used[gap + 1]) // 2 if len(used) > 1 else labels_1.max_id + 1
                if new_id in used:
                    new_id = available[0]
                relabeled[u] = new_id
                used = sorted(used + [new_id])
    dense = (relabeled @ labels_2.get_onehot()).astype(np.int32)
    return Label(dense)


def match_label_series(
    label_list: List[Label],
    least_labels_first: bool = True,
    extra_labels_assignment: str = "greedy",
) -> Tuple[List[Label], int]:
    """Chain-match a series of label sets (parity: labels.py:355)."""
    num_labels = [label.num_labels for label in label_list]
    order = np.argsort(num_labels) if least_labels_first else np.argsort(num_labels)[::-1]
    max_id = max(label.max_id for label in label_list)
    matched: List[Optional[Label]] = [None] * len(label_list)
    ref = None
    for i in order:
        if ref is None:
            ref = expand_labels(label_list[i], max_id)
            matched[i] = ref
        else:
            matched[i] = match_labels(ref, label_list[i], extra_labels_assignment=extra_labels_assignment)
            ref = matched[i]
    return matched, max_id


def interlabel_connections(label: Label, weights_matrix) -> np.ndarray:
    """Sum of spatial weights between each pair of labels (normalized one-hot
    quadratic form)."""
    onehot = label.get_normalized_onehot()
    return np.asarray((onehot @ weights_matrix @ onehot.T).todense() if scipy.sparse.issparse(weights_matrix) else onehot @ weights_matrix @ onehot.T)


def create_label_class(adata, cat_key):
    """Wrap categorical .obs column(s) into Label objects for downstream
    consensus/matching (parity: reference labels.py:438)."""
    import pandas as pd

    def one(key):
        vals = pd.Series(np.asarray(adata.obs[key])).astype(str)
        cats = {c: i for i, c in enumerate(pd.unique(vals))}
        dense = np.asarray([cats[v] for v in vals], dtype=np.int32)
        return Label(dense, str_map={i: c for c, i in cats.items()})

    if isinstance(cat_key, str):
        return one(cat_key)
    return [one(k) for k in cat_key]
