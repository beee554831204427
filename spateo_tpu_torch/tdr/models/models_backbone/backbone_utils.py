"""Backbone utilities: arclength mapping, gene mapping
(capability parity: reference spateo/tdr/models/models_backbone/backbone_utils.py).

A copy of `spateo_tpu.tdr.models.models_backbone.backbone_utils`."""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from ....core.anndata import AnnData
from ....logging import logger_manager as lm
from ..mesh_core import PointCloud


def map_points_to_backbone(
    adata: AnnData,
    backbone_model: PointCloud,
    spatial_key: str = "spatial",
    nodes_key: str = "nodes",
    key_added: str = "nodes",
    inplace: bool = False,
    **kwargs,
):
    """Assign each cell to its nearest backbone node."""
    from scipy.spatial import cKDTree

    coords = np.asarray(adata.obsm[spatial_key], dtype=float)
    nodes = np.asarray(backbone_model.points, dtype=float)[:, : coords.shape[1]]
    tree = cKDTree(nodes)
    _, idx = tree.query(coords, k=1)
    adata.obs[key_added] = idx
    return None if inplace else adata


def map_gene_to_backbone(
    model: PointCloud,
    tree: PointCloud,
    key: Union[str, list],
    nodes_key: str = "nodes",
    inplace: bool = False,
):
    """Average per-cell gene values onto backbone nodes."""
    from scipy.spatial import cKDTree

    tree_out = tree if inplace else tree.copy()
    keys = [key] if isinstance(key, str) else list(key)
    nodes = np.asarray(tree.points, dtype=float)
    pts = np.asarray(model.points, dtype=float)[:, : nodes.shape[1]]
    kd = cKDTree(nodes)
    _, idx = kd.query(pts, k=1)
    for k in keys:
        vals = np.asarray(model[k], dtype=float)
        sums = np.bincount(idx, weights=vals, minlength=len(nodes))
        counts = np.bincount(idx, minlength=len(nodes))
        tree_out[k] = sums / np.maximum(counts, 1)
    if not inplace:
        return tree_out


def update_backbone(
    backbone: PointCloud,
    nodes_key: str = "nodes",
    key_added: str = "updated_nodes",
    select_nodes: Optional[Union[list, np.ndarray]] = None,
    interactive: bool = True,
    model_size: Union[float, list] = 8.0,
    colormap: str = "Spectral",
):
    """Subset/renumber backbone nodes (non-interactive variant of the
    reference's picker)."""
    backbone = backbone.copy()
    if select_nodes is not None:
        sel = np.asarray(select_nodes, dtype=int)
        backbone.points = backbone.points[sel]
        for k in list(backbone.point_data):
            backbone.point_data[k] = np.asarray(backbone.point_data[k])[sel]
        if hasattr(backbone, "edges"):
            keep = np.isin(backbone.edges, sel).all(axis=1)
            remap = {int(v): i for i, v in enumerate(sel)}
            backbone.edges = np.vectorize(remap.get)(backbone.edges[keep])
    backbone[key_added] = np.arange(backbone.n_points)
    return backbone


def sort_nodes_of_curve(nodes: np.ndarray, started_node: np.ndarray) -> np.ndarray:
    """Order curve nodes by nearest-neighbor chaining from a start node
    (parity: reference backbone_utils.py sort_nodes_of_curve)."""
    nodes = np.asarray(nodes, float)
    start = int(np.argmin(((nodes - np.asarray(started_node, float)) ** 2).sum(1)))
    remaining = list(range(len(nodes)))
    order = [start]
    remaining.remove(start)
    while remaining:
        last = nodes[order[-1]]
        d = ((nodes[remaining] - last) ** 2).sum(1)
        nxt = remaining[int(np.argmin(d))]
        order.append(nxt)
        remaining.remove(nxt)
    return nodes[order]
