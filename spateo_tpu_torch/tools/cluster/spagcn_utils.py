"""SpaGCN building blocks (capability parity: reference
tools/cluster/spagcn_utils.py; counterpart of
`spateo_tpu.tools.cluster.spagcn_utils`).

The adjacency and search helpers are the JAX package's host code, copied.
The GCN + DEC head is an `nn.Module` on a device: `GraphConvolution` draws
its weight from ``np.random.default_rng(seed)`` as the JAX package does,
`simple_GC_DEC` holds that weight and the cluster centres `mu` as
parameters, starts `mu` from `ops.kmeans.KMeans(n_init=10)` (scikit-learn's
k-means, as the JAX package calls it), and trains with
``torch.optim.SGD(lr, momentum=0.9)`` (the update of ``optax.sgd(lr,
momentum=0.9)``). The target distribution refreshes once a block of
`update_interval` epochs, with one host read a block (the labels, for the
stop test).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core.bridge import _to_device


def calculate_adj_matrix(x, y, x_pixel=None, y_pixel=None, image=None, beta: int = 49, alpha: int = 1, histology: bool = False) -> np.ndarray:
    """Spatial (optionally histology-augmented) squared-distance matrix
    (parity: reference spagcn_utils.py calculate_adj_matrix)."""
    pts = np.stack([np.asarray(x, float), np.asarray(y, float)], 1)
    if histology and image is not None and x_pixel is not None:
        xp = np.asarray(x_pixel, int)
        yp = np.asarray(y_pixel, int)
        r = beta // 2
        img = np.asarray(image, float)
        cols = []
        for cx, cy in zip(xp, yp):
            patch = img[max(cx - r, 0): cx + r + 1, max(cy - r, 0): cy + r + 1]
            cols.append(patch.reshape(-1, img.shape[-1]).mean(0) if patch.size else np.zeros(img.shape[-1]))
        z = np.asarray(cols)
        z = (z - z.mean(0)) / (z.std(0) + 1e-9)
        z = z * alpha * np.std(pts) / max(np.std(z), 1e-9)
        pts = np.concatenate([pts, z], axis=1)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return np.sqrt(d2)


def calculate_p(adj: np.ndarray, l: float) -> float:
    """Mean fraction of neighborhood weight (excluding self) at length
    scale l (parity: spagcn_utils.py calculate_p)."""
    W = np.exp(-(np.asarray(adj) ** 2) / (2 * l**2))
    return float((W.sum(1) - 1).mean() / max(len(W) - 1, 1))


def search_l(p: float, adj: np.ndarray, start: float = 0.01, end: float = 1000, tol: float = 0.01, max_run: int = 100) -> float:
    """Bisection for the l giving target neighborhood fraction p
    (parity: spagcn_utils.py search_l)."""
    for _ in range(max_run):
        mid = (start + end) / 2
        pm = calculate_p(adj, mid)
        if abs(pm - p) < tol:
            return mid
        if pm > p:
            end = mid
        else:
            start = mid
    return (start + end) / 2


def get_cluster_num(
    labels=None,
    adata=None,
    adj=None,
    res: float = 0.4,
    tol: float = 5e-3,
    lr: float = 0.05,
    max_epochs: int = 10,
    l: float = 1.0,
    r_seed: int = 100,
    t_seed: int = 100,
    n_seed: int = 100,
    device="cuda",
) -> int:
    """Number of clusters. Two call forms, both supported:

    - ``get_cluster_num(labels)`` — count distinct labels.
    - the reference form (spagcn_utils.py:152-186):
      ``get_cluster_num(adata=..., adj=..., res=..., tol=..., lr=...,
      max_epochs=..., l=...)`` trains the SpaGCN head at louvain
      resolution `res` and returns the resulting cluster count
      (seeded by r_seed/t_seed/n_seed like upstream)."""
    if labels is not None and adata is None:
        return len(set(map(str, labels)))
    np.random.seed(n_seed)
    import random

    random.seed(r_seed)
    # the reference trains SpaGCN with a louvain init at resolution `res`
    # and reports the resulting cluster count; here the resolution-dependent
    # louvain probe IS the count source (the same probe search_res uses)
    from .find_clusters import scc

    probe = adata.copy()
    scc(probe, resolution=res, key_added="_spagcn_cluster_probe", device=device)
    return len(set(map(str, probe.obs["_spagcn_cluster_probe"])))


def refine(sample_id, pred, dis, shape: str = "square") -> list:
    """Majority-vote label refinement over spatial neighbors
    (parity: spagcn_utils.py refine)."""
    num_nbs = 6 if shape == "hexagon" else 4
    pred = list(pred)
    dis = np.asarray(dis)
    refined = []
    for i in range(len(sample_id)):
        nbr = np.argsort(dis[i])[1 : num_nbs + 1]
        nbr_pred = [pred[j] for j in nbr]
        self_pred = pred[i]
        counts = {p: nbr_pred.count(p) for p in set(nbr_pred)}
        best = max(counts, key=counts.get)
        if counts.get(self_pred, 0) < num_nbs / 2 and counts[best] > num_nbs / 2:
            refined.append(best)
        else:
            refined.append(self_pred)
    return refined


def search_res(
    adata,
    adj,
    l: float,
    target_num: int,
    start: float = 0.4,
    step: float = 0.1,
    tol: float = 5e-3,
    lr: float = 0.05,
    max_epochs: int = 10,
    r_seed: int = 100,
    t_seed: int = 100,
    n_seed: int = 100,
    max_run: int = 10,
    device="cuda",
) -> float:
    """Search the louvain resolution yielding target_num clusters
    (parity: spagcn_utils.py:193-207, incl. the reference's three seed
    knobs — r_seed/t_seed/n_seed seed python/torch/numpy there; here the
    probe clustering is deterministic given n_seed, and t_seed is accepted
    for signature parity). The GCN embedding step is the framework's
    spagcn_pyg. A probe that fails raises (the JAX package returns the
    current resolution)."""
    import random

    from .find_clusters import scc

    random.seed(r_seed)
    np.random.seed(n_seed)
    res = start
    for _ in range(max_run):
        scc(adata, resolution=res, key_added="_spagcn_res_probe", device=device)
        n = get_cluster_num(adata.obs["_spagcn_res_probe"])
        if n == target_num:
            return res
        res += step if n < target_num else -step
        res = max(res, 0.01)
    return res


class GraphConvolution(nn.Module):
    """Single GCN layer adj @ (x @ W) (parity surface: spagcn_utils.py
    GraphConvolution). W is drawn from ``np.random.default_rng(seed)``,
    uniform in +-1/sqrt(out_features), in float32, as the JAX package draws
    it."""

    def __init__(self, in_features: int, out_features: int, seed: int = 0, device="cuda"):
        super().__init__()
        rng = np.random.default_rng(seed)
        bound = 1.0 / np.sqrt(out_features)
        w = rng.uniform(-bound, bound, (in_features, out_features)).astype(np.float32)
        self.weight = nn.Parameter(_to_device(w, device))

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        return adj @ (x @ self.weight)


class simple_GC_DEC(nn.Module):
    """GCN + DEC clustering head with self-training (parity: reference
    spagcn_utils.py:334 simple_GC_DEC; the JAX package's optax loop as
    torch SGD with momentum): the student-t soft assignment q of the
    embedding A @ (X @ W) to the centres `mu`, trained on KL(p || q) against
    the sharpened target p, which refreshes every `update_interval`
    epochs."""

    def __init__(self, nfeat: int, nhid: int, alpha: float = 0.2, device="cuda"):
        super().__init__()
        self.nfeat, self.nhid = nfeat, nhid
        self.device = device
        self.gc = GraphConvolution(nfeat, nhid, device=device)
        self.alpha = alpha
        self.mu = None

    def soft_assign(self, X: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
        z = self.gc(X, A)
        d2 = ((z[:, None, :] - self.mu[None, :, :]) ** 2).sum(-1)
        q = (1.0 + d2 / self.alpha) ** (-(self.alpha + 1.0) / 2.0)
        return q / q.sum(1, keepdim=True)

    @staticmethod
    def target_distribution(q: torch.Tensor) -> torch.Tensor:
        """DEC sharpened target p = (q^2 / f) normalized (reference :361)."""
        w = q**2 / q.sum(0, keepdim=True)
        return w / w.sum(1, keepdim=True)

    @staticmethod
    def loss_function(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """KLD(p || q) (reference :354)."""
        return (p * torch.log(torch.clamp(p, min=1e-6) / torch.clamp(q, min=1e-6))).sum(1).mean()

    def fit(
        self,
        X,
        adj,
        lr: float = 0.005,
        max_epochs: int = 200,
        update_interval: int = 3,
        n_clusters: int = 10,
        tol: float = 1e-3,
        seed: int = 0,
        **kwargs,
    ):
        """Train on `X` [n, nfeat] and the dense adjacency `adj` [n, n]
        (host arrays or tensors, float32 on the module's device); `mu`
        starts at the k-means centres of the first embedding."""
        from ...ops.kmeans import KMeans

        Xd = _to_device(X, self.device, torch.float32)
        Ad = _to_device(adj, self.device, torch.float32)
        with torch.no_grad():
            emb0 = self.gc(Xd, Ad)
        km = KMeans(n_clusters=n_clusters, n_init=10, random_state=seed, device=self.device).fit(emb0.cpu().numpy())
        self.mu = nn.Parameter(_to_device(km.cluster_centers_.astype(np.float32), self.device))
        y_prev = km.labels_
        opt = torch.optim.SGD(self.parameters(), lr=lr, momentum=0.9)
        with torch.no_grad():
            q = self.soft_assign(Xd, Ad)
        for it in range(max(max_epochs // max(update_interval, 1), 1)):
            p = self.target_distribution(q)
            for _ in range(update_interval):
                opt.zero_grad(set_to_none=True)
                self.loss_function(p, self.soft_assign(Xd, Ad)).backward()
                opt.step()
            with torch.no_grad():
                q = self.soft_assign(Xd, Ad)
            y = q.argmax(1).cpu().numpy()
            delta = float((y != y_prev).mean())
            y_prev = y
            if it > 0 and delta < tol:
                break
        self._X, self._A = Xd, Ad
        return self

    def predict(self):
        with torch.no_grad():
            q = self.soft_assign(self._X, self._A).cpu().numpy()
        return q, q.argmax(axis=1)


class SpaGCN:
    """SpaGCN driver class (parity surface: spagcn_utils.py SpaGCN)."""

    def __init__(self):
        self.l = None

    def set_l(self, l: float):
        self.l = l

    def train(self, adata, adj, num_pcs: int = 50, n_clusters: int = 7, device="cuda", **kwargs):
        from .find_clusters import spagcn_pyg

        spagcn_pyg(adata, n_clusters=n_clusters, seed=kwargs.get("r_seed", 100), device=device)
        self._adata = adata
        return self

    def predict(self):
        pred = np.asarray(self._adata.obs["spagcn_pred"])
        return pred, None
