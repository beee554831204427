"""pySTAGATE wrapper class (capability parity: reference
spateo/tools/cluster/_stagate.py:10; counterpart of
`spateo_tpu.tools.cluster._stagate`). `train` fits the STAGATE
graph-attention autoencoder (`external.stagate.train_stagate`) on the
device; `cal_pSM` runs on the STAGATE embedding in `.obsm['STAGATE']`, its
kNN graph from `find_neighbors.knn` on the device.
`num_batch_x/num_batch_y/batch_size` are accepted for signature parity and
ignored."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from scipy.sparse import issparse

from ...core.anndata import AnnData
from ...logging import logger_manager as lm


class pySTAGATE:
    """STAGATE training/prediction object (parity surface: reference
    _stagate.py:10)."""

    def __init__(
        self,
        adata: AnnData,
        num_batch_x: int = 1,
        num_batch_y: int = 1,
        basis: str = "spatial",
        spatial_key: Optional[List[str]] = None,
        batch_size: int = 1,
        rad_cutoff: float = 200,
        num_epoch: int = 1000,
        lr: float = 0.001,
        weight_decay: float = 1e-4,
        hidden_dims: Optional[List[int]] = None,
        device="cuda",
    ) -> None:
        coords = adata.obsm[basis]
        if issparse(coords):
            adata.obsm[basis] = coords = coords.toarray()
        adata.obs["X"] = np.asarray(coords)[:, 0]
        adata.obs["Y"] = np.asarray(coords)[:, 1]
        self.adata = adata
        self.basis = basis
        self.rad_cutoff = rad_cutoff
        self.num_epoch = num_epoch
        self.lr = lr
        self.hidden_dims = list(hidden_dims) if hidden_dims is not None else [512, 30]
        self.device = device
        self._trained = "STAGATE" in adata.obsm

    def train(self):
        """Train the STAGATE model on the object's device."""
        from ...external.stagate import train_stagate

        train_stagate(
            self.adata,
            hidden_dims=tuple(self.hidden_dims),
            n_epochs=self.num_epoch,
            lr=self.lr,
            rad_cutoff=self.rad_cutoff,
            key_added="STAGATE",
            verbose=False,
            device=self.device,
        )
        self._trained = True

    def predicted(self):
        """Store the STAGATE representation (.obsm['STAGATE']) and the
        non-negative reconstruction (.layers['STAGATE_ReX']) (parity:
        reference _stagate.py predicted)."""
        if not self._trained:
            self.train()
        rex = np.asarray(self.adata.layers["STAGATE_rec"])
        rex = np.where(rex < 0, 0, rex)
        self.adata.layers["STAGATE_ReX"] = rex
        lm.main_info('The STAGATE representation values are stored in adata.obsm["STAGATE"].')
        lm.main_info('The rex values are stored in adata.layers["STAGATE_ReX"].')

    def cal_pSM(
        self,
        n_neighbors: int = 20,
        resolution: float = 1,
        max_cell_for_subsampling: int = 5000,
        psm_key: str = "pSM_STAGATE",
    ):
        """Pseudo-spatial map via diffusion pseudotime over the STAGATE
        embedding (parity: reference _stagate.py cal_pSM — the scanpy DPT
        pipeline replaced by a diffusion-map pseudotime on the kNN graph)."""
        if not self._trained:
            self.train()
        from scipy.sparse import csgraph, csr_matrix
        from scipy.sparse.linalg import eigsh

        from ..find_neighbors import _knn_graph, knn

        z = np.asarray(self.adata.obsm["STAGATE"])
        n = len(z)
        if n > max_cell_for_subsampling:
            rng = np.random.default_rng(0)
            idx = np.sort(rng.choice(n, max_cell_for_subsampling, replace=False))
        else:
            idx = np.arange(n)
        zz = z[idx]
        idx, _ = knn(zz, min(n_neighbors, len(zz) - 1), device=self.device)
        A = _knn_graph(idx, np.ones(idx.size), len(zz))
        A = A.maximum(A.T)
        L = csgraph.laplacian(csr_matrix(A), normed=True)
        k = min(3, len(zz) - 2)
        vals, vecs = eigsh(L, k=k + 1, which="SM")
        order = np.argsort(vals)
        psm_sub = vecs[:, order[1]]  # Fiedler vector as the 1-d pseudo-axis
        psm_sub = (psm_sub - psm_sub.min()) / max(psm_sub.max() - psm_sub.min(), 1e-12)
        if len(idx) < n:
            # extend to unsampled cells via nearest sampled neighbor
            from scipy.spatial import cKDTree

            near = cKDTree(zz).query(z, k=1)[1]
            psm = psm_sub[near]
        else:
            psm = psm_sub
        self.adata.obs[psm_key] = psm
        lm.main_info(f"The pseudo-spatial map values are stored in adata.obs['{psm_key}'].")
        return psm
