"""Graph community detection (capability parity: reference
spateo/tools/cluster/leiden.py:61,126).

Host code, the JAX package's copied: igraph/leidenalg are not dependencies;
partitions run on networkx's Louvain implementation (networkx comes with
torch's wheel; a missing networkx raises). `calculate_leiden_partition` additionally applies a
refinement pass (each community re-checked for connectivity and split),
approximating the Leiden guarantee.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse


def distance_knn_graph(dist: np.ndarray, num_neighbors: int):
    """KNN graph from a distance matrix (parity: leiden.py:13)."""
    import networkx as nx

    n = dist.shape[0]
    G = nx.Graph()
    G.add_nodes_from(range(n))
    idx = np.argsort(dist, axis=1)[:, 1 : num_neighbors + 1]
    for i in range(n):
        for j in idx[i]:
            G.add_edge(i, int(j), weight=float(1.0 / (dist[i, j] + 1e-12)))
    return G


def embedding_knn_graph(X: np.ndarray, num_neighbors: int):
    """KNN graph from an embedding (parity: leiden.py:40)."""
    from scipy.spatial.distance import cdist

    return distance_knn_graph(cdist(X, X), num_neighbors)


def _adj_to_nx(adj):
    import networkx as nx

    adj = scipy.sparse.csr_matrix(adj)
    G = nx.from_scipy_sparse_array(adj)
    return G


def _partition_to_labels(communities, n: int) -> np.ndarray:
    labels = np.zeros(n, dtype=int)
    for c, nodes in enumerate(sorted(communities, key=lambda s: -len(s))):
        for v in nodes:
            labels[v] = c
    return labels


def _resolve_graph(adj, input_mat, graph, num_neighbors: int, graph_type: str):
    """Reference input contract (leiden.py:61-120): a precomputed adjacency
    wins; otherwise `input_mat` is interpreted per `graph_type` as a distance
    matrix or an embedding and converted to a kNN graph; neither is an error."""
    if graph is not None:
        return graph
    if adj is None and input_mat is None:
        raise ValueError("Either `adj` or `input_mat` must be specified")
    if adj is not None:
        return _adj_to_nx(adj)
    if graph_type == "distance":
        return distance_knn_graph(np.asarray(input_mat), num_neighbors)
    if graph_type == "embedding":
        return embedding_knn_graph(np.asarray(input_mat), num_neighbors)
    raise ValueError(f"Unknown graph_type {graph_type!r}: use 'distance' or 'embedding'")


def calculate_louvain_partition(
    adj=None,
    input_mat: Optional[np.ndarray] = None,
    num_neighbors: int = 10,
    graph_type: str = "distance",
    resolution: Optional[float] = None,
    n_iterations: int = -1,
    graph=None,
    seed: int = 42,
) -> np.ndarray:
    """Louvain communities (parity: leiden.py:126-190 — same adj/input_mat
    contract; the reference's fixed seed 42 is the default here too).
    `n_iterations` caps the level passes (-1 = run to convergence, the
    reference louvain package's semantics)."""
    from networkx.algorithms.community import louvain_communities

    G = _resolve_graph(adj, input_mat, graph, num_neighbors, graph_type)
    kwargs = {} if n_iterations in (-1, None) else {"max_level": int(n_iterations)}
    comms = louvain_communities(G, resolution=resolution or 1.0, seed=seed, **kwargs)
    return _partition_to_labels(comms, G.number_of_nodes())


def calculate_leiden_partition(
    adj=None,
    input_mat: Optional[np.ndarray] = None,
    num_neighbors: int = 10,
    graph_type: str = "distance",
    resolution: Optional[float] = None,
    n_iterations: int = -1,
    graph=None,
    seed: int = 888,
) -> np.ndarray:
    """Leiden-style partition: Louvain + connectivity refinement
    (parity surface: leiden.py:61-124 — same adj/input_mat contract; the
    reference's fixed seed 888 is the default here too)."""
    import networkx as nx
    from networkx.algorithms.community import louvain_communities

    G = _resolve_graph(adj, input_mat, graph, num_neighbors, graph_type)
    kwargs = {} if n_iterations in (-1, None) else {"max_level": int(n_iterations)}
    comms = louvain_communities(G, resolution=resolution or 1.0, seed=seed, **kwargs)
    # refinement: split communities that are internally disconnected (the
    # Leiden guarantee the plain Louvain pass lacks)
    refined = []
    for c in comms:
        sub = G.subgraph(c)
        for comp in nx.connected_components(sub):
            refined.append(comp)
    return _partition_to_labels(refined, G.number_of_nodes())


def adj_to_igraph(adj):
    """Adjacency matrix -> graph object (parity: reference
    cluster/leiden.py adj_to_igraph; igraph is not available in this build,
    so the equivalent networkx graph is returned — the partitioners here
    consume it directly)."""
    import networkx as nx
    from scipy.sparse import issparse

    if issparse(adj):
        return nx.from_scipy_sparse_array(adj)
    return nx.from_numpy_array(np.asarray(adj))
