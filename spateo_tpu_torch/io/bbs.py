"""Concave-hull (alpha-shape) utilities.

Capability parity with reference spateo/io/bbs.py:26 (`alpha_shape`) and :131
(`get_concave_hull`), shapely-free: the hull is computed from the Delaunay
triangulation with a vectorized circumradius filter, and boundary polygons are
returned as vertex arrays (ordered rings) instead of shapely geometries.
A copy of `spateo_tpu.io.bbs` (host numpy and scipy).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial import Delaunay

from ..configuration import SKM
from ..logging import logger_manager as lm


def _order_boundary_edges(edges: np.ndarray) -> List[np.ndarray]:
    """Chain boundary edges (pairs of vertex ids) into ordered rings."""
    from collections import defaultdict

    adj = defaultdict(list)
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    unused = {tuple(sorted(e)) for e in edges}
    rings = []
    while unused:
        start = next(iter(unused))
        ring = [start[0], start[1]]
        unused.discard(start)
        while True:
            cur = ring[-1]
            nxt = None
            for cand in adj[cur]:
                key = tuple(sorted((cur, cand)))
                if key in unused:
                    nxt = cand
                    unused.discard(key)
                    break
            if nxt is None:
                break
            ring.append(nxt)
            if nxt == ring[0]:
                break
        rings.append(np.array(ring))
    return rings


def alpha_shape(
    x: np.ndarray,
    y: np.ndarray,
    alpha: float = 1,
    buffer: float = 1,
    vectorize: bool = True,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Concave hull of a 2D point set.

    Triangles whose circumradius exceeds 1/alpha are discarded; the boundary
    of the remaining triangulation is returned.

    Returns:
        (rings, edge_points): list of (K_i, 2) polygon vertex arrays (outer
        ring(s) of the hull), and an (E, 2, 2) array of boundary edge segments.
    """
    coords = np.array([np.asarray(x).ravel(), np.asarray(y).ravel()]).T
    if coords.shape[0] < 4:
        order = np.argsort(np.arctan2(*(coords - coords.mean(0)).T[::-1]))
        ring = coords[order]
        return [ring], np.stack([ring, np.roll(ring, -1, axis=0)], axis=1)

    tri = Delaunay(coords)
    simplices = tri.simplices
    pa, pb, pc = coords[simplices[:, 0]], coords[simplices[:, 1]], coords[simplices[:, 2]]
    a = np.linalg.norm(pa - pb, axis=1)
    b = np.linalg.norm(pb - pc, axis=1)
    c = np.linalg.norm(pc - pa, axis=1)
    s = (a + b + c) / 2.0
    area = np.sqrt(np.maximum(s * (s - a) * (s - b) * (s - c), 1e-30))
    circum_r = a * b * c / (4.0 * area)
    keep = circum_r < 1.0 / alpha
    kept = simplices[keep]
    if kept.size == 0:
        lm.main_warning("alpha too large — no triangles kept; falling back to convex hull.")
        from scipy.spatial import ConvexHull

        hull = ConvexHull(coords)
        ring = coords[hull.vertices]
        return [ring], np.stack([ring, np.roll(ring, -1, axis=0)], axis=1)

    # boundary edges appear exactly once across kept triangles
    edges = np.concatenate([kept[:, [0, 1]], kept[:, [1, 2]], kept[:, [2, 0]]])
    edges_sorted = np.sort(edges, axis=1)
    uniq, counts = np.unique(edges_sorted, axis=0, return_counts=True)
    boundary = uniq[counts == 1]
    rings = [coords[r] for r in _order_boundary_edges(boundary)]
    edge_points = coords[boundary]
    return rings, edge_points


def get_concave_hull(
    path,
    binsize: int = 20,
    min_agg_umi: Optional[int] = None,
    alpha: float = 1.0,
    buffer: Optional[float] = None,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Concave hull of all buckets with more than `min_agg_umi` UMIs.

    Reference contract (spateo/io/bbs.py:131-180): `path` is a BGI GEM file,
    aggregated at `binsize` via `read_bgi_agg`; occupied bins above
    `min_agg_umi` (default binsize - 1) are mapped back to true chip
    coordinates through bin centroids; `buffer` defaults to the binsize.
    An AnnData may be passed directly in place of `path` (AGG rasters use
    their occupied pixels, UMI objects their `.obsm['spatial']`).
    """
    if isinstance(path, (str, bytes)) or hasattr(path, "__fspath__"):
        from .bgi import read_bgi_agg
        from .utils import centroids

        adata = read_bgi_agg(path, binsize=binsize)
        if min_agg_umi is None:
            min_agg_umi = binsize - 1
        i, j = (adata.X > min_agg_umi).nonzero()
        x_min, y_min = int(adata.obs_names[0]), int(adata.var_names[0])
        if binsize != 1:
            x = centroids(np.asarray(i), coord_min=x_min, binsize=binsize).astype(float)
            y = centroids(np.asarray(j), coord_min=y_min, binsize=binsize).astype(float)
        else:
            x, y = np.asarray(i, float) + x_min, np.asarray(j, float) + y_min
        if buffer is None:
            buffer = binsize
        return alpha_shape(x, y, alpha=alpha, buffer=buffer)

    adata = path
    if SKM.get_adata_type(adata) == SKM.ADATA_AGG_TYPE:
        thr = 0 if min_agg_umi is None else min_agg_umi
        nz = (adata.X > thr).nonzero()
        x, y = np.asarray(nz[0], dtype=float), np.asarray(nz[1], dtype=float)
    else:
        spatial = np.asarray(adata.obsm["spatial"], dtype=float)
        x, y = spatial[:, 0], spatial[:, 1]
    return alpha_shape(x, y, alpha=alpha, buffer=buffer or 1)
