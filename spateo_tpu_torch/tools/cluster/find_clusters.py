"""Spatial clustering (capability parity: reference
spateo/tools/cluster/find_clusters.py: scc:194, smooth:255, mclust_py:301,
spagcn_pyg:28, CAST:369; counterpart of
`spateo_tpu.tools.cluster.find_clusters`).

`scc` partitions the union of the kNN graphs of `utils.spatial_adj` (on the
device) with networkx's Louvain on the host; `smooth` is the JAX package's
host vote. `mclust_py` runs `ops.gmm.GaussianMixture` (scikit-learn's, in
float64 on the device) and `kmeans_clustering` `ops.kmeans.KMeans`.
`spagcn_pyg` builds the [n, n] distances, the 60-step bisection of the
length scale `l` and the adjacency on the device in float64, then hands a
float32 adjacency to the GCN + DEC head (`spagcn_utils.simple_GC_DEC`); the
[n, n] matrices never leave the device. `CAST` is `external.cast.cast_mark`
(CAST-Mark, trained on the device).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...configuration import SKM
from ...core.anndata import AnnData
from ...core.bridge import _to_device
from ...logging import logger_manager as lm
from .leiden import calculate_leiden_partition, calculate_louvain_partition
from .utils import spatial_adj

#: Bisection steps of SpaGCN's length scale, as in the JAX package.
SPAGCN_L_STEPS = 60


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def scc(
    adata: AnnData,
    spatial_key: str = "spatial",
    key_added: Optional[str] = "scc",
    pca_key: str = "pca",
    e_neigh: int = 30,
    s_neigh: int = 6,
    resolution: Optional[float] = None,
    cluster_method: str = "louvain",
    device="cuda",
) -> Optional[AnnData]:
    """Spatially-constrained clustering: union of expression-KNN and
    spatial-KNN graphs (built on `device`) partitioned by Louvain/Leiden on
    the host (parity: find_clusters.py:194)."""
    adj = spatial_adj(adata=adata, spatial_key=spatial_key, pca_key=pca_key, e_neigh=e_neigh, s_neigh=s_neigh,
                      device=device)
    if cluster_method == "louvain":
        clusters = calculate_louvain_partition(adj=adj, resolution=resolution)
    else:
        clusters = calculate_leiden_partition(adj=adj, resolution=resolution)
    adata.obs[key_added] = clusters.astype(str)
    return adata


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def smooth(adata: AnnData, radius: int = 50, key: str = "label") -> list:
    """Majority-vote label smoothing over spatial neighbors (parity:
    find_clusters.py:255), the JAX package's host code."""
    from scipy.spatial import cKDTree
    import pandas as pd

    old_type = np.asarray(adata.obs[key].values)
    codes, uniques = pd.factorize(old_type)
    position = np.asarray(adata.obsm["spatial"], dtype=float)
    tree = cKDTree(position)
    _, idx = tree.query(position, k=radius + 1)
    neigh_codes = codes[idx[:, 1:]]
    n_classes = len(uniques)
    counts = np.zeros((len(codes), n_classes), dtype=np.int32)
    for c in range(n_classes):
        counts[:, c] = (neigh_codes == c).sum(axis=1)
    new_codes = counts.argmax(axis=1)
    new_type = [str(uniques[c]) for c in new_codes]
    adata.obs[key + "_smooth"] = new_type
    return new_type


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def mclust_py(adata: AnnData, n_components=None, use_rep: str = "X_pca", modelNames: str = "EEE",
              random_seed: int = 42, device="cuda"):
    """GMM clustering ("mclust"-style; parity: find_clusters.py:301) by
    `ops.gmm.GaussianMixture` on `device`. `modelNames` maps to a covariance
    type as in the JAX package ("EEE" -> spherical, "VVV" -> full, "EEV" ->
    tied, "VVI" -> diag, anything else -> full)."""
    if n_components is None:
        lm.main_info("You need to input the `n_components` when methods is `GMM`")
        return
    from ...ops.gmm import GaussianMixture

    data = np.asarray(adata.obsm[use_rep])
    covariance_type = {"EEE": "spherical", "VVV": "full", "EEV": "tied", "VVI": "diag"}.get(modelNames, "full")
    np.random.seed(random_seed)
    gmm = GaussianMixture(n_components=n_components, covariance_type=covariance_type, random_state=random_seed,
                          device=device)
    labels = gmm.fit(data).predict(data)
    adata.obs["mclust"] = labels.astype(int).astype(str)
    adata.obs["gmm_cluster"] = adata.obs["mclust"]
    return adata


def spagcn_adjacency(coords: np.ndarray, p: float = 0.5, device="cuda"):
    """SpaGCN's row-normalised adjacency exp(-D^2 / (2 l^2)) on `device`:
    the [n, n] distances in float64, and l by `SPAGCN_L_STEPS` bisection
    steps from [1e-3, max D + 1e-6] so that the mean of exp(-D^2 / (2 l^2))
    is ~p, each step's comparison made on the device. Returns (the float32
    adjacency on `device`, l as a 0-d float64 tensor)."""
    c = _to_device(np.asarray(coords, dtype=np.float64), device)
    D2 = torch.cdist(c, c, compute_mode="donot_use_mm_for_euclid_dist") ** 2
    lo = torch.tensor(1e-3, dtype=torch.float64, device=c.device)
    hi = torch.sqrt(D2.max()) + 1e-6
    for _ in range(SPAGCN_L_STEPS):
        mid = (lo + hi) / 2
        below = torch.exp(-D2 / (2 * mid**2)).mean() < p
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    l = (lo + hi) / 2
    A = torch.exp(-D2 / (2 * l**2))
    del D2
    A /= A.sum(1, keepdim=True)
    return A.to(torch.float32), l


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def spagcn_pyg(
    adata: AnnData,
    n_clusters: int,
    p: float = 0.5,
    s: int = 1,
    b: int = 49,
    refine_shape: Optional[str] = None,
    his_img_path: Optional[str] = None,
    total_umi: Optional[str] = None,
    x_pixel: str = None,
    y_pixel: str = None,
    x_array: str = None,
    y_array: str = None,
    seed: int = 100,
    copy: bool = False,
    device="cuda",
) -> Optional[AnnData]:
    """SpaGCN spatial-domain detection (parity: find_clusters.py:28): the
    SpaGCN adjacency (`spagcn_adjacency`, on `device`), the PCA embedding
    (randomized PCA on `device`), then the GCN + DEC self-training head
    (`spagcn_utils.simple_GC_DEC`)."""
    coords = np.asarray(adata.obsm["spatial"], dtype=float)
    A, _ = spagcn_adjacency(coords, p=p, device=device)

    from scipy.sparse import issparse

    X = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X, dtype=float)
    from ..dimensionality_reduction import randomized_pca_centered

    emb, _, _ = randomized_pca_centered(X, min(50, X.shape[1] - 1), device=device)
    from .spagcn_utils import simple_GC_DEC

    model = simple_GC_DEC(emb.shape[1], emb.shape[1], alpha=0.2, device=device)
    model.fit(emb, A, n_clusters=n_clusters, seed=seed)
    _, labels = model.predict()
    out = adata.copy() if copy else adata
    out.obs["spagcn_pred"] = labels.astype(str)
    if refine_shape is not None:
        smooth(out, radius=6, key="spagcn_pred")
        out.obs["spagcn_pred_refined"] = out.obs["spagcn_pred_smooth"]
    return out if copy else None


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE)
def CAST(
    adata: AnnData,
    sample_key: Optional[str] = None,
    basis: str = "spatial",
    layer: Optional[str] = "norm_1e4",
    device="cuda",
    **kwargs,
):
    """CAST graph-contrastive embedding wrapper (parity: find_clusters.py:369):
    `external.cast.cast_mark` on `device`, into .obsm['X_cast']."""
    from ...external.cast import cast_mark

    return cast_mark(adata, sample_key=sample_key, basis=basis, layer=layer, device=device, **kwargs)


def kmeans_clustering(
    adata: AnnData,
    n_clusters: int = 10,
    use_rep: str = "X_cast",
    random_state: int = 42,
    cluster_key: str = "kmeans_clusters",
    key_added: Optional[str] = None,
    copy: bool = False,
    device="cuda",
):
    """K-means over a representation (parity: reference
    find_clusters.py:438; the CAST embedding 'X_cast' by default, X_pca
    when it is absent) by `ops.kmeans.KMeans(n_init=10)` on `device`.
    `key_added` aliases `cluster_key`."""
    from ...ops.kmeans import KMeans

    key_added = key_added or cluster_key
    if use_rep not in adata.obsm and use_rep == "X_cast" and "X_pca" in adata.obsm:
        use_rep = "X_pca"
    adata_work = adata.copy() if copy else adata
    X = np.asarray(adata_work.obsm[use_rep]) if use_rep in adata_work.obsm else (
        adata_work.X.toarray() if hasattr(adata_work.X, "toarray") else np.asarray(adata_work.X)
    )
    labels = KMeans(n_clusters=n_clusters, random_state=random_state, n_init=10, device=device).fit(X).labels_
    adata_work.obs[key_added] = labels.astype(str)
    return adata_work if copy else None


def spagcn_vanilla(
    adata: AnnData,
    spatial_key: str = "spatial",
    key_added: str = "spagcn_pred",
    n_pca_components: Optional[int] = None,
    e_neigh: int = 10,
    resolution: float = 0.4,
    n_clusters: Optional[int] = None,
    refine_shape: str = "hexagon",
    p: float = 0.5,
    seed: int = 100,
    numIterMaxSpa: int = 2000,
    copy: bool = False,
    device="cuda",
):
    """SpaGCN without torch_geometric (parity surface: reference
    cluster_spagcn.py:18 spagcn_vanilla): `spagcn_pyg` with its dense
    adjacency."""
    out = spagcn_pyg(
        adata,
        n_clusters=n_clusters if n_clusters is not None else 7,
        p=p,
        refine_shape=refine_shape,
        seed=seed,
        copy=copy,
        device=device,
    )
    target = out if copy else adata
    if key_added != "spagcn_pred" and "spagcn_pred" in target.obs.columns:
        target.obs[key_added] = target.obs["spagcn_pred"]
    return out
