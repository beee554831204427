"""Backbone construction entry points (capability parity: reference
spateo/tdr/models/models_backbone/backbone.py:17,157). The counterpart of
`spateo_tpu.tdr.models.models_backbone.backbone`: `construct_backbone` takes
`device=` (default ``"cuda"``) for its method, and `backbone_scc` for the
kNN graphs of `tools.cluster.find_clusters.scc`."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from ....core.anndata import AnnData
from ....logging import logger_manager as lm
from ..mesh_core import Mesh, PointCloud
from .backbone_methods import ElPiGraph_tree, PrinCurve, SimplePPT_tree


def construct_backbone(
    model: Union[PointCloud, Mesh, np.ndarray],
    spatial_key: Optional[str] = None,
    nodes_key: str = "nodes",
    rd_method: str = "ElPiGraph",
    num_nodes: int = 50,
    color: str = "gainsboro",
    device="cuda",
    **kwargs,
) -> Tuple[Mesh, np.ndarray, Optional[str]]:
    """Organ principal-curve/tree backbone (parity: backbone.py:17).

    Returns (backbone_model as a polyline Mesh-like object with .points/.edges,
    backbone_length, plot_cmap placeholder)."""
    if isinstance(model, np.ndarray):
        X = model
    else:
        X = model.points
    X = np.asarray(X, dtype=float)
    if rd_method == "ElPiGraph":
        nodes, edges = ElPiGraph_tree(X, NumNodes=num_nodes, device=device, **kwargs)
    elif rd_method == "SimplePPT":
        nodes, edges = SimplePPT_tree(X, NumNodes=num_nodes, device=device, **kwargs)
    elif rd_method == "PrinCurve":
        nodes, edges = PrinCurve(X, NumNodes=num_nodes, device=device, **kwargs)
    else:
        raise ValueError(f"rd_method must be one of 'ElPiGraph', 'SimplePPT', 'PrinCurve', got {rd_method}")

    backbone = PointCloud(nodes)
    backbone.edges = edges
    backbone[nodes_key] = np.arange(len(nodes))
    length = float(np.sum(np.linalg.norm(nodes[edges[:, 0]] - nodes[edges[:, 1]], axis=1)))
    return backbone, length, None


def backbone_scc(
    adata: AnnData,
    backbone: PointCloud,
    genes: Optional[list] = None,
    adata_nodes_key: str = "backbone_nodes",
    backbone_nodes_key: str = "nodes",
    key_added: str = "backbone_scc",
    spatial_key: str = "spatial",
    e_neigh: int = 10,
    s_neigh: int = 6,
    cluster_method: str = "leiden",
    resolution: Optional[float] = None,
    inplace: bool = True,
    device="cuda",
) -> Optional[AnnData]:
    """Cluster cells along the backbone with spatial constraints
    (parity: backbone.py:157): each cell mapped to its backbone node, then
    `tools.cluster.scc` (its kNN graphs on `device`, Louvain/Leiden on the
    host)."""
    from ....tools.cluster.find_clusters import scc
    from .backbone_utils import map_points_to_backbone

    adata = adata if inplace else adata.copy()
    map_points_to_backbone(adata, backbone, nodes_key=backbone_nodes_key, key_added=adata_nodes_key, spatial_key=spatial_key)
    scc(
        adata,
        spatial_key=spatial_key,
        key_added=key_added,
        e_neigh=e_neigh,
        s_neigh=s_neigh,
        resolution=resolution,
        cluster_method=cluster_method,
        device=device,
    )
    return None if inplace else adata
