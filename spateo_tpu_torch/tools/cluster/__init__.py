"""Clustering tools (parity: reference spateo/tools/cluster/__init__.py;
counterpart of `spateo_tpu.tools.cluster`)."""

from . import cluster_spagcn, find_clusters, leiden, spagcn_utils
from ._stagate import pySTAGATE
from .find_clusters import CAST, kmeans_clustering, mclust_py, scc, smooth, spagcn_pyg, spagcn_vanilla
from .leiden import calculate_leiden_partition, calculate_louvain_partition
from .utils import (
    compute_pca_components,
    ecp_silhouette,
    integrate,
    pca_spateo,
    pearson_residuals,
    spatial_adj,
)
