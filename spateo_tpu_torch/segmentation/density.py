"""Density binning: spatially constrained hierarchical clustering of the UMI
density.

Counterpart of `spateo_tpu.segmentation.density`. The Gaussian blur and the
per-bin dilations run on ``device=``. The Ward tree runs on the host over
the binned raster, as in the JAX package, but is the port's own
(`_ward_tree`, `_hc_cut`, numpy and `heapq`; no scikit-learn): it follows
`sklearn.cluster.ward_tree` under a connectivity graph step for step, with
the same heap key (inertia, i, j), the same numbering of new clusters and
the same float64 arithmetic, so ties in flat regions break the same way and
the bins are the same.
"""

from __future__ import annotations

import heapq
from typing import Optional, Union

import numpy as np
import torch
from scipy import sparse
from scipy.sparse import spmatrix

from ..configuration import SKM
from ..core.anndata import AnnData
from ..logging import logger_manager as lm
from ..ops.image import conv2d, dilate, mclose_mopen


def _grid_neighbors(shape):
    """4-neighbour lists of a raster grid, each in ascending order."""
    n_rows, n_cols = shape
    A = []
    for ind in range(n_rows * n_cols):
        r, c = divmod(ind, n_cols)
        row = []
        if r > 0:
            row.append(ind - n_cols)
        if c > 0:
            row.append(ind - 1)
        if c < n_cols - 1:
            row.append(ind + 1)
        if r < n_rows - 1:
            row.append(ind + n_cols)
        A.append(row)
    return A


def _ward_tree(X: np.ndarray, shape):
    """Ward linkage of the single-feature samples `X` [n] under the
    4-neighbour grid of `shape`: (children [n - 1, 2], n_leaves, parents,
    distances), as `sklearn.cluster.ward_tree(X[:, None], connectivity=...,
    return_distance=True)` gives them."""
    x = np.asarray(X, np.float64).ravel()
    n = x.shape[0]
    n_nodes = 2 * n - 1
    A = _grid_neighbors(shape)
    # the initial pairs, each node with its lower neighbours
    coord_row = np.array([ind for ind, row in enumerate(A) for c in row if c < ind], dtype=np.intp)
    coord_col = np.array([c for ind, row in enumerate(A) for c in row if c < ind], dtype=np.intp)
    m1 = [1.0] * n + [0.0] * (n - 1)
    m2 = x.tolist() + [0.0] * (n - 1)
    d = x[coord_row] - x[coord_col]
    inertia = list(zip((d * d * 0.5).tolist(), coord_row.tolist(), coord_col.tolist()))
    heapq.heapify(inertia)

    parent = list(range(n_nodes))
    used = [True] * n_nodes
    children = []
    distances = np.empty(n_nodes - n)
    for k in range(n, n_nodes):
        while True:
            inert, i, j = heapq.heappop(inertia)
            if used[i] and used[j]:
                break
        parent[i] = parent[j] = k
        children.append((i, j))
        used[i] = used[j] = False
        distances[k - n] = inert
        m1[k] = m1[i] + m1[j]
        m2[k] = m2[i] + m2[j]
        # the heads of the merged nodes' neighbours, in the order met
        heads, seen = [], {k}
        for node in A[i] + A[j]:
            while parent[node] != node:
                node = parent[node]
            if node not in seen:
                seen.add(node)
                heads.append(node)
        for col in heads:
            A[col].append(k)
        A.append(heads)
        mk, sk = m1[k], m2[k]
        for col in heads:
            dc = sk / mk - m2[col] / m1[col]
            heapq.heappush(inertia, (dc * dc * ((mk * m1[col]) / (mk + m1[col])), k, col))
    children = np.array([c[::-1] for c in children])
    return children, n, np.asarray(parent, dtype=np.intp), np.sqrt(2.0 * distances)


def _descendants(node: int, children: np.ndarray, n_leaves: int):
    if node < n_leaves:
        return [node]
    out, stack = [], [node]
    while stack:
        i = stack.pop()
        if i < n_leaves:
            out.append(i)
        else:
            stack.extend(children[i - n_leaves])
    return out


def _hc_cut(n_clusters: int, children: np.ndarray, n_leaves: int) -> np.ndarray:
    """Cut the tree into `n_clusters`, numbered as sklearn's `_hc_cut`
    numbers them (the order of its heap of negated node ids)."""
    if n_clusters > n_leaves:
        raise ValueError(
            f"Cannot extract more clusters than samples: {n_clusters} clusters were given for a tree with "
            f"{n_leaves} leaves."
        )
    nodes = [-(int(max(children[-1])) + 1)]
    for _ in range(n_clusters - 1):
        these = children[-nodes[0] - n_leaves]
        heapq.heappush(nodes, -int(these[0]))
        heapq.heappushpop(nodes, -int(these[1]))
    label = np.zeros(n_leaves, dtype=np.intp)
    for i, node in enumerate(nodes):
        label[_descendants(-node, children, n_leaves)] = i
    return label


def _schc(X: np.ndarray, distance_threshold: Optional[float] = None) -> np.ndarray:
    """Ward-linkage clustering constrained to the 4-neighbour grid; the
    threshold defaults to the knee of the distance against cluster-count
    curve."""
    children, n_leaves, _, distances = _ward_tree(X, X.shape)
    if not distance_threshold:
        x = np.sort(np.unique(distances))[-1000:]
        y = np.array([(distances >= val).sum() + 1 for val in x])
        # knee of a convex decreasing curve (kneedle): max of the inverted difference
        xn = (x - x.min()) / max(x.max() - x.min(), 1e-30)
        yn = (y - y.min()) / max(y.max() - y.min(), 1e-30)
        distance_threshold = float(x[int(np.argmax((1 - yn) - xn))])
    n_clusters = int((distances >= distance_threshold).sum() + 1)
    return _hc_cut(n_clusters, children, n_leaves).reshape(X.shape)


def _segment_densities(
    X: Union[spmatrix, np.ndarray], k: int, dk: int, distance_threshold: Optional[float] = None, device="cuda"
) -> np.ndarray:
    """Blur, cluster, then dilate each bin in ascending mean density."""
    if sparse.issparse(X):
        X = X.toarray()
    X = np.asarray(X, dtype=float)
    if X.size > 5e5:
        lm.main_warning(f"Array has {X.size} elements. Consider condensing the array by increasing the binsize.")
    Xd = conv2d(X / X.max(), k, mode="gauss", device=device)
    X = Xd.cpu().numpy()
    bins = _schc(X, distance_threshold=distance_threshold) + 1

    bins_d = torch.as_tensor(bins, device=Xd.device)
    dilated = torch.zeros_like(bins_d)
    for label in sorted(np.unique(bins), key=lambda label: X[bins == label].mean()):
        d = dilate(bins_d == int(label), dk)
        dilated[mclose_mopen(d, dk)] = int(label)
    return dilated.cpu().numpy()


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def segment_densities(
    adata: AnnData,
    layer: str,
    binsize: int,
    k: int,
    dk: int,
    distance_threshold: Optional[float] = None,
    background: Optional[Union[bool, tuple]] = None,
    out_layer: Optional[str] = None,
    device="cuda",
):
    """Segment the raster into regions by UMI density.

    Args:
        adata: Input AnnData (AGG type).
        layer: Layer containing UMI counts.
        binsize: Size of bins to use (counts are sum-pooled before clustering;
            results are upscaled back).
        k: Gaussian blur kernel size.
        dk: Dilation kernel size.
        distance_threshold: Ward linkage distance threshold (dynamic knee if None).
        background: If a (x, y) tuple, the bin at that pixel is marked as
            background. If True, the bin with the most pixels on the raster
            border is considered background. If False/None, no background.
        out_layer: Output layer; defaults to `{layer}_bins`.
        device: Where the blur and the dilations run.
    """
    X = SKM.select_layer_data(adata, layer, make_dense=(binsize == 1))
    if binsize > 1:
        from ..io.utils import bin_matrix

        X = bin_matrix(X, binsize)
        if sparse.issparse(X):
            X = X.toarray()
    bins = _segment_densities(X, k, dk, distance_threshold, device)
    if binsize > 1:
        bins = np.kron(bins, np.ones((binsize, binsize), dtype=int))
        bins = bins[: adata.n_obs, : adata.n_vars]
    if background is not None and background is not False:
        if isinstance(background, (tuple, list)):
            bg_label = bins[int(background[0]), int(background[1])]
        else:
            border = np.concatenate([bins[0], bins[-1], bins[:, 0], bins[:, -1]])
            bg_label = np.bincount(border).argmax()
        bins[bins == bg_label] = 0
        bins[bins > bg_label] -= 1
    SKM.set_layer_data(adata, out_layer or SKM.gen_new_layer_key(layer, SKM.BINS_SUFFIX), bins)


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def merge_densities(
    adata: AnnData,
    layer: str,
    mapping: Optional[dict] = None,
    out_layer: Optional[str] = None,
):
    """Merge density bins by a label mapping."""
    bins_layer = SKM.gen_new_layer_key(layer, SKM.BINS_SUFFIX)
    if bins_layer not in adata.layers:
        bins_layer = layer
    bins = np.asarray(SKM.select_layer_data(adata, bins_layer)).copy()
    if mapping:
        for from_label, to_label in mapping.items():
            bins[bins == from_label] = to_label
    SKM.set_layer_data(adata, out_layer or bins_layer, bins)
