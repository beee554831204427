"""Backbone construction entry points (capability parity: reference
spateo/tdr/models/models_backbone/backbone.py:17,157). The counterpart of
`spateo_tpu.tdr.models.models_backbone.backbone`: `construct_backbone` takes
`device=` (default ``"cuda"``) for its method; `backbone_scc` needs
`tools.cluster.find_clusters.scc` (leiden/louvain), which the port does not
have yet (ROADMAP Queue 1 item 11), and raises."""

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
) -> Optional[AnnData]:
    """Cluster cells along the backbone with spatial constraints
    (parity: backbone.py:157). Not ported: the clustering
    (`tools.cluster.find_clusters.scc`) is ROADMAP Queue 1 item 11."""
    raise NotImplementedError(
        "backbone_scc needs tools.cluster.find_clusters.scc (leiden/louvain), which the port does not have yet "
        "(ROADMAP Queue 1 item 11)"
    )
