"""Principal curve/tree algorithms on `device` (counterpart of
`spateo_tpu.tdr.models.models_backbone.backbone_methods`; reference
spateo/tdr/models/models_backbone/backbone_methods.py:146 (ElPiGraph), :220
(SimplePPT), :284 (NLPCA PrinCurve)).

- **SimplePPT**: the k-means start is `ops/kmeans.py::MiniBatchKMeans`
  (scikit-learn's, step for step); each of the 3 rounds takes the minimum
  spanning tree of the nodes on the host, then `_ppt_em` on `device` in
  float32 (soft assignment, one [K, K] solve an iteration, no host read).
- **ElPiGraph**: each growth step builds the JAX package's candidate list
  (bisect each edge in edge order, then a leaf at each allowed node in node
  order) and fits every candidate in one masked loop on `device` in float64
  (`_optimize_elastic_batch`): the assignment in the difference form, so
  that `argmin` picks numpy's first index on ties, the per-node counts and
  sums, one batched solve, each candidate's own stop, and the energies. The
  host reads the energies, nodes and assignment sums once a step and keeps
  the first candidate of strictly lowest energy, as the serial loop does
  (`ElPiGraph_tree.host_reads`, `.steps`, `.fits` count them). The elastic
  matrices and the topology stay on the host.
- **NLPCA**: the sigmoid bottleneck autoencoder as an `nn.Module`, with the
  JAX package's `default_rng(0)` draws; full-batch torch Adam on the summed
  loss, no host read inside the loop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ....core.bridge import _to_device
from ....logging import logger_manager as lm
from ....ops.kmeans import MiniBatchKMeans

#: Elements of the [candidates, rows, nodes] float64 distance block that
#: ElPiGraph's assignment computes at once (256 MB).
ELPI_ELEMS = 1 << 25


def _mst_edges(nodes: np.ndarray) -> np.ndarray:
    """Minimum spanning tree edges over node euclidean distances."""
    from scipy.sparse.csgraph import minimum_spanning_tree
    from scipy.spatial.distance import cdist

    D = cdist(nodes, nodes)
    T = minimum_spanning_tree(D).toarray()
    rows, cols = np.nonzero(T)
    return np.stack([rows, cols], axis=1)


def _ppt_em(X: torch.Tensor, nodes0: torch.Tensor, L: torch.Tensor, sigma: float, lam: float, n_iter: int = 50):
    """SimplePPT iterations: soft assignment + Laplacian-regularized update."""
    xsq = torch.sum(X**2, 1)[:, None]
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    nodes = nodes0
    for _ in range(n_iter):
        d2 = xsq + torch.sum(nodes**2, 1)[None, :] - 2 * (X @ nodes.T)
        R = torch.softmax(-d2 / sigma, dim=1)  # [N, K]
        w = R.sum(0)  # [K]
        lhs = torch.diag(w) + lam * L
        rhs = R.T @ X
        nodes = torch.linalg.solve_ex(lhs + 1e-8 * eye, rhs)[0]
    return nodes


def SimplePPT_tree(
    X: np.ndarray,
    NumNodes: int = 50,
    sigma: float = 0.1,
    lam: float = 1.0,
    n_iter: int = 50,
    seed: int = 0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Principal tree (SimplePPT; parity surface: backbone.py:220).

    Returns (nodes [K, D], edges [E, 2])."""
    X = np.asarray(X, dtype=np.float32)
    K = min(NumNodes, len(X))
    km = MiniBatchKMeans(n_clusters=K, random_state=seed, n_init=3, device=device).fit(X)
    nodes = km.cluster_centers_.astype(np.float32)
    span = float(np.linalg.norm(X.max(0) - X.min(0))) + 1e-9
    sigma_abs = (sigma * span) ** 2
    Xd = _to_device(X, device)
    for _ in range(3):  # alternate tree topology and node optimization
        edges = _mst_edges(nodes)
        n = len(nodes)
        L = np.zeros((n, n), np.float32)
        for a, b in edges:
            L[a, a] += 1
            L[b, b] += 1
            L[a, b] -= 1
            L[b, a] -= 1
        nodes = _ppt_em(Xd, _to_device(nodes, device), _to_device(L, device), sigma_abs, lam, n_iter).cpu().numpy()
    edges = _mst_edges(nodes)
    return nodes, edges


# ---------------------------------------------------------------------------
# ElPiGraph: elastic principal graphs (Albergante et al. 2020)
# ---------------------------------------------------------------------------
def _elastic_matrix(k: int, edges: np.ndarray, Lambda: float, Mu: float) -> Tuple[np.ndarray, np.ndarray]:
    """Quadratic-form matrices of the elastic energy: the edge term
    Lambda * sum ||phi_u - phi_v||^2 and the star harmonicity term
    Mu * sum_stars ||phi_c - mean(neighbors)||^2."""
    A_E = np.zeros((k, k))
    deg = np.zeros(k, int)
    nbrs: list = [[] for _ in range(k)]
    for a, b in edges:
        A_E[a, a] += Lambda
        A_E[b, b] += Lambda
        A_E[a, b] -= Lambda
        A_E[b, a] -= Lambda
        deg[a] += 1
        deg[b] += 1
        nbrs[a].append(b)
        nbrs[b].append(a)
    A_R = np.zeros((k, k))
    for c in range(k):
        if deg[c] >= 2:
            vec = np.zeros(k)
            vec[c] = 1.0
            for l in nbrs[c]:
                vec[l] -= 1.0 / deg[c]
            A_R += Mu * np.outer(vec, vec)
    return A_E, A_R


def _assign(X: torch.Tensor, nodes: torch.Tensor, need_min: bool = False):
    """Each point's nearest node in each of B candidates (nodes [B, k, D]),
    numpy's difference form and first index on ties, in row chunks. Returns
    the assignment [B, N], the node counts [B, k] and coordinate sums
    [B, k, D] (rows added in order, as `np.add.at`), and with `need_min`
    the squared distance to the nearest node [B, N]."""
    B, k, D = nodes.shape
    rows = max(1, ELPI_ELEMS // (B * k))
    offs = (torch.arange(B, device=X.device) * k)[:, None]
    counts = torch.zeros(B * k, dtype=torch.int64, device=X.device)
    sums = torch.zeros((B * k, D), dtype=X.dtype, device=X.device)
    parts, mins = [], []
    for Xc in X.split(rows):
        d2 = (Xc[None, :, None, 0] - nodes[:, None, :, 0]) ** 2
        for d in range(1, D):
            d2 = d2 + (Xc[None, :, None, d] - nodes[:, None, :, d]) ** 2
        dmin, part = d2.min(2)
        flat = (part + offs).reshape(-1)
        counts += torch.bincount(flat, minlength=B * k)
        sums.index_add_(0, flat, Xc[None].expand(B, -1, -1).reshape(-1, D))
        parts.append(part)
        if need_min:
            mins.append(dmin)
    out = (torch.cat(parts, 1), counts.view(B, k).to(X.dtype), sums.view(B, k, D))
    return out + (torch.cat(mins, 1),) if need_min else out


def _optimize_elastic_batch(
    X: torch.Tensor,
    nodes: np.ndarray,
    edges: np.ndarray,
    Lambda: float,
    Mu: float,
    alpha: float = 0.0,
    n_iter: int = 10,
    tol: float = 1e-5,
    final_energy: str = "Penalized",
):
    """`_optimize_elastic` of the JAX package for B candidates of one
    topology size at once: nodes [B, k, D], edges [B, E, 2] (host arrays),
    X [N, D] on the device. Every candidate runs its own EM with its own
    stop (assignment unchanged and shift < tol), masked, for at most
    `n_iter` iterations, with no host read. Returns device tensors: the
    nodes [B, k, D], the energies [B], and the counts [B, k] and sums
    [B, k, D] of the final assignment, and the solves' LAPACK infos."""
    nodes_h = np.asarray(nodes, float)
    edges = np.asarray(edges, int)
    B, k, D = nodes_h.shape
    N = X.shape[0]
    A_E, A_R = zip(*(_elastic_matrix(k, e, Lambda, Mu) for e in edges))
    dev = X.device
    A_E, A_R = _to_device(np.stack(A_E), dev), _to_device(np.stack(A_R), dev)
    reg = 1e-9 * torch.eye(k, dtype=X.dtype, device=dev)
    nodes = _to_device(nodes_h, dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    part = None
    info = torch.zeros(B, dtype=torch.int32, device=dev)
    for it in range(n_iter):
        part_new, counts, sums = _assign(X, nodes)
        A = torch.diag_embed(counts / N) + A_E + A_R
        new_nodes, inf = torch.linalg.solve_ex(A + reg, sums / N)
        info = torch.where(active, inf, info)
        shift = (new_nodes - nodes).abs().amax((1, 2))
        nodes = torch.where(active[:, None, None], new_nodes, nodes)
        if part is not None:
            stop = active & (part_new == part).all(1) & (shift < tol)
            part = torch.where(active[:, None], part_new, part)
            active = active & ~stop
        else:
            part = part_new
    _, counts, sums, dmin = _assign(X, nodes, need_min=True)
    u_approx = dmin.mean(1)
    e_t = _to_device(edges, dev)
    bidx = torch.arange(B, device=dev)[:, None]
    diffs = nodes[bidx, e_t[:, :, 0]] - nodes[bidx, e_t[:, :, 1]]
    u_e = Lambda * (diffs**2).sum((1, 2))
    adj = np.zeros((B, k, k))
    for b in range(B):
        np.add.at(adj[b], (edges[b, :, 0], edges[b, :, 1]), 1.0)
        np.add.at(adj[b], (edges[b, :, 1], edges[b, :, 0]), 1.0)
    deg = adj.sum(2)
    adj_t, deg_t = _to_device(adj, dev), _to_device(deg, dev)
    star = ((nodes - (adj_t @ nodes) / deg_t.clamp_min(1)[:, :, None]) ** 2).sum(2)
    u_r = Mu * torch.where(deg_t >= 2, star, 0.0).sum(1)
    energy = u_approx + u_e + u_r
    if final_energy.lower() == "penalized" and alpha > 0:
        # branching penalty: excess degree beyond 2 at each star
        excess = _to_device(np.maximum(deg - 2, 0).sum(1), dev)
        energy = energy + alpha * excess * (u_e / max(edges.shape[1], 1))
    return nodes, energy, counts, sums, info


def _fit_and_read(X, nodes, edges, *args, **kwargs):
    """`_optimize_elastic_batch` and one host read of all it returns."""
    out = _optimize_elastic_batch(X, nodes, edges, *args, **kwargs)
    B, k, D = out[0].shape
    flat = torch.cat([out[0].reshape(B, -1), out[1][:, None], out[2], out[3].reshape(B, -1),
                      out[4][:, None].to(out[0].dtype)], 1).cpu().numpy()
    ElPiGraph_tree.host_reads += 1
    ElPiGraph_tree.fits += B
    if (flat[:, -1] != 0).any():
        raise np.linalg.LinAlgError("Singular matrix in an ElPiGraph node update")
    o = 0
    parts = []
    for n in (k * D, 1, k, k * D):
        parts.append(flat[:, o : o + n])
        o += n
    return parts[0].reshape(B, k, D), parts[1][:, 0], parts[2], parts[3].reshape(B, k, D)


def ElPiGraph_tree(
    X: np.ndarray,
    NumNodes: int = 50,
    topology: str = "tree",
    Lambda: float = 0.01,
    Mu: float = 0.1,
    alpha: float = 0.0,
    FinalEnergy: str = "Penalized",
    n_iter: int = 10,
    device="cuda",
    **kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """Elastic principal graph (native re-derivation of Albergante et al.
    2020; parity: reference backbone_methods.py:146 `ElPiGraph_method`,
    which calls elpigraph-python). The graph grows by graph-grammar
    operations — 'bisect edge' everywhere and 'add node to node' (a new
    leaf) — each candidate scored by the optimized elastic energy
    U = mean squared point-to-node distance + Lambda * edge lengths
    + Mu * star harmonicity, and the best operation is kept, until NumNodes.

    topology='tree' allows branching; 'curve' grows only at path endpoints;
    'circle' starts from a closed triangle and only bisects edges.
    Returns (nodes [K, D], edges [E, 2])."""
    X = np.asarray(X, float)
    topology = str(topology).lower()
    mean = X.mean(0)
    _, _, Vt = np.linalg.svd(X - mean, full_matrices=False)
    pc1 = Vt[0] * X.std(0).max()
    if topology == "circle":
        pc2 = Vt[1] * X.std(0).max() if len(Vt) > 1 else np.roll(pc1, 1)
        nodes = np.stack([mean + pc1, mean - 0.5 * pc1 + 0.8 * pc2, mean - 0.5 * pc1 - 0.8 * pc2])
        edges = np.array([[0, 1], [1, 2], [2, 0]])
    else:
        nodes = np.stack([mean - pc1, mean + pc1])
        edges = np.array([[0, 1]])
    Xd = _to_device(X, device)
    fit = lambda nb, eb, it: _fit_and_read(Xd, nb, eb, Lambda, Mu, alpha, it, final_energy=FinalEnergy)
    out, _, counts, sums = fit(nodes[None], edges[None], n_iter)
    nodes, counts, sums = out[0], counts[0], sums[0]

    while len(nodes) < min(NumNodes, len(X)):
        k = len(nodes)
        deg = np.bincount(edges.ravel(), minlength=k)
        cand_nodes, cand_edges = [], []
        # bisect edge: u - w - v
        for ei, (a, b) in enumerate(edges):
            cand_nodes.append(np.vstack([nodes, (nodes[a] + nodes[b]) / 2]))
            cand_edges.append(np.vstack([np.delete(edges, ei, axis=0), [[a, k], [k, b]]]))
        # add node to node (new leaf), from the assignment of the current nodes
        if topology != "circle":
            grow_at = range(k) if topology == "tree" else [i for i in range(k) if deg[i] == 1]
            for v in grow_at:
                if counts[v] >= 2:
                    offset = sums[v] / counts[v] - nodes[v]
                else:
                    nb = [b for a, b in edges if a == v] + [a for a, b in edges if b == v]
                    offset = nodes[v] - nodes[nb].mean(0) if nb else np.zeros(X.shape[1])
                cand_nodes.append(np.vstack([nodes, nodes[v] + offset]))
                cand_edges.append(np.vstack([edges, [[v, k]]]))
        out, energy, counts_b, sums_b = fit(np.stack(cand_nodes), np.stack(cand_edges), max(3, n_iter // 2))
        ElPiGraph_tree.steps += 1
        best = 0
        for i in range(1, len(energy)):  # the serial loop's strict `<`
            if energy[i] < energy[best]:
                best = i
        nodes, edges, counts, sums = out[best], cand_edges[best], counts_b[best], sums_b[best]
    out, _, _, _ = fit(nodes[None], edges[None], 2 * n_iter)
    return np.asarray(out[0]), np.asarray(edges)


ElPiGraph_tree.host_reads = 0
ElPiGraph_tree.steps = 0
ElPiGraph_tree.fits = 0


class NLPCA(nn.Module):
    """Neural-network nonlinear PCA principal-curve solver (parity:
    reference backbone_methods.py:40 — a sigmoid autoencoder with a
    1-unit bottleneck trained on the summed reconstruction error), on
    `device`.

    Attributes after `fit`: the weights `w1`, `b1`, ... `b4` (and `params`,
    their host copies by name) and `fit_points` after `project` (the
    reconstructed curve points)."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self.fit_points = None
        self._num_dim = None
        self._nodes = None

    def init_params(self, num_dim: int, nodes: int):
        """The JAX package's initial weights: `default_rng(0)` normal draws
        in the order w1, w2, w3, w4; zero biases."""
        self._num_dim, self._nodes = num_dim, nodes
        rng = np.random.default_rng(0)

        def init(shape, scale):
            return nn.Parameter(_to_device(rng.normal(0, scale, shape).astype(np.float32), self.device))

        def zeros(n):
            return nn.Parameter(torch.zeros(n, dtype=torch.float32, device=self.device))

        self.w1, self.b1 = init((num_dim, nodes), 1.0 / np.sqrt(num_dim)), zeros(nodes)
        self.w2, self.b2 = init((nodes, 1), 1.0 / np.sqrt(nodes)), zeros(1)
        self.w3, self.b3 = init((1, nodes), 1.0), zeros(nodes)
        self.w4, self.b4 = init((nodes, num_dim), 1.0 / np.sqrt(nodes)), zeros(num_dim)
        return self

    @property
    def params(self) -> Optional[dict]:
        if self._num_dim is None:
            return None
        return {k: v.detach().cpu().numpy() for k, v in self.named_parameters()}

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = torch.sigmoid(x @ self.w1 + self.b1)
        bottleneck = torch.sigmoid(h @ self.w2 + self.b2)  # [N, 1]
        h2 = torch.sigmoid(bottleneck @ self.w3 + self.b3)
        out = h2 @ self.w4 + self.b4
        return out, bottleneck

    def fit(self, data: np.ndarray, epochs: int = 500, nodes: int = 25, lr: float = 0.01, verbose: int = 0):
        X = _to_device(np.asarray(data, np.float32), self.device)
        self.init_params(X.shape[1], nodes)
        opt = torch.optim.Adam(self.parameters(), lr=lr)
        for _ in range(epochs):
            opt.zero_grad(set_to_none=True)
            out, _ = self(X)
            # summed (not mean) orthogonal distance, as the reference's
            # orth_dist (backbone_methods.py:31)
            torch.sum((X - out) ** 2).backward()
            opt.step()
        if verbose:
            with torch.no_grad():
                lm.main_info(f"NLPCA final loss: {float(torch.sum((X - self(X)[0]) ** 2)):.4f}")
        return self

    def project(self, data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Project points onto the fitted curve; returns (projection index
        [N, 1], data sorted by projection index [N, D+1])."""
        data = np.asarray(data, np.float32)
        with torch.no_grad():
            out, bottleneck = self(_to_device(data, self.device))
        pts = out.cpu().numpy()
        proj = bottleneck.cpu().numpy()
        self.fit_points = pts
        all_data = np.concatenate([pts, proj], axis=1)
        all_sorted = all_data[all_data[:, data.shape[1]].argsort()]
        return proj, all_sorted


def PrinCurve(
    X: np.ndarray, NumNodes: int = 50, epochs: int = 500, lr: float = 0.01, scale_factor: float = 1, device="cuda",
    **kwargs
) -> Tuple[np.ndarray, np.ndarray]:
    """Principal curve via the NLPCA autoencoder (parity: reference
    backbone_methods.py:284 `PrinCurve_method`): min-shift the data, fit the
    bottleneck autoencoder, project, sort by the 1-d bottleneck coordinate
    and subsample the reconstructed curve to NumNodes chain nodes."""
    raw_X = np.asarray(X, float)
    dims = raw_X.shape[1]
    new_X = raw_X.copy() / scale_factor
    trans = []
    for i in range(dims):
        sub = new_X[:, i].min()
        new_X[:, i] = new_X[:, i] - sub
        trans.append(sub)
    solver = NLPCA(device=device)
    solver.fit(new_X, epochs=epochs, nodes=NumNodes, lr=lr)
    _, curve_pts = solver.project(new_X)
    curve_pts = np.unique(curve_pts, axis=0)
    curve_pts = curve_pts[curve_pts[:, -1].argsort(), :]
    for i in range(dims):
        curve_pts[:, i] = curve_pts[:, i] + trans[i]
    nodes = curve_pts[:, :dims] * scale_factor
    if len(nodes) > NumNodes:
        idx = np.linspace(0, len(nodes) - 1, NumNodes).astype(int)
        nodes = nodes[idx]
    n_nodes = nodes.shape[0]
    edges = np.stack([np.arange(n_nodes - 1), np.arange(1, n_nodes)], axis=1)
    return nodes, edges


def SimplePPT_method(X, NumNodes: int = 50, **kwargs):
    """Reference-named alias (backbone_methods.py SimplePPT_method)."""
    return SimplePPT_tree(X, NumNodes=NumNodes, **kwargs)


def ElPiGraph_method(X, NumNodes: int = 50, **kwargs):
    """Reference-named alias (backbone_methods.py ElPiGraph_method)."""
    return ElPiGraph_tree(X, NumNodes=NumNodes, **kwargs)


def PrinCurve_method(X, NumNodes: int = 50, **kwargs):
    """Reference-named alias (backbone_methods.py PrinCurve_method)."""
    return PrinCurve(X, NumNodes=NumNodes, **kwargs)


def orth_dist(y_true, y_pred) -> float:
    """Summed squared distance between tensors — the NLPCA training loss
    (parity: reference backbone_methods.py:31 orth_dist)."""
    return float(((np.asarray(y_true, float) - np.asarray(y_pred, float)) ** 2).sum())
