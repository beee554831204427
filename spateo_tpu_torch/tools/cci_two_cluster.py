"""CCI between two spatially-adjacent clusters
(capability parity: reference spateo/tools/cci_two_cluster.py:33 + cci_fdr.py;
counterpart of `spateo_tpu.tools.cci_two_cluster`).

`find_cci_two_group` takes its spatial pairs from `find_neighbors.knn` on the
device, draws its permutations on the host from ``np.random.default_rng(seed)``
in the JAX package's order, and scores all of them on the device in chunks of
batched gathers (at most `NULL_CHUNK_ELEMS` entries of [permutations, pairs,
L-R pairs] a chunk), with one host copy of the null scores. The ligand-receptor
tables are read by path from the CSVs beside the JAX package
(`spateo_tpu/tools/database/`; ``path=`` overrides it). The other functions are
the JAX package's host code.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import pandas as pd
import torch
from scipy.sparse import issparse

from ..core.anndata import AnnData
from ..core.bridge import _to_device
from ..svg.utils import multipletests_bh

#: The CCI databases (CSV data) shipped in the repository beside the JAX package.
_DB_DIR = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..", "spateo_tpu", "tools", "database"))

#: Entries of [permutations, pairs, L-R pairs] one chunk of the null holds.
NULL_CHUNK_ELEMS = 1 << 26


def permutation_null(lig: torch.Tensor, rec: torch.Tensor, perm_s: torch.Tensor, perm_r: torch.Tensor) -> torch.Tensor:
    """[num, P] null scores on the device of `lig`: for permutation p, the
    mean over pairs of lig[perm_s[p]] * rec[perm_r[p]] ([n, P] expression,
    [num, pairs] cell indices), in chunks of `NULL_CHUNK_ELEMS`."""
    num, n_pairs = perm_s.shape
    out = torch.empty((num, lig.shape[1]), dtype=lig.dtype, device=lig.device)
    chunk = max(1, NULL_CHUNK_ELEMS // max(n_pairs * lig.shape[1], 1))
    for s in range(0, num, chunk):
        out[s : s + chunk] = (lig[perm_s[s : s + chunk]] * rec[perm_r[s : s + chunk]]).mean(1)
    return out


def _load_lr_network(path: Optional[str], species: str) -> pd.DataFrame:
    base = path if path else _DB_DIR + os.sep
    files = {
        "human": "lr_db_human.csv",
        "mouse": "lr_db_mouse.csv",
        "drosophila": "lr_network_drosophila.csv",
        "zebrafish": "lr_network_zebrafish.csv",
        "axolotl": "lr_network_axolotl.csv",
    }
    lr_network = pd.read_csv(os.path.join(base, files[species]), index_col=0)
    if species == "axolotl":
        lr_network["from"] = lr_network["human_ligand"]
        lr_network["to"] = lr_network["human_receptor"]
    lr_network["lr_pair"] = lr_network["from"].astype(str).str.cat(lr_network["to"].astype(str), sep="-")
    return lr_network


def find_cci_two_group(
    adata: AnnData,
    path: Optional[str] = None,
    species: str = "human",
    layer: Optional[str] = None,
    group: Optional[str] = None,
    lr_pair: Optional[list] = None,
    sender_group: Optional[str] = None,
    receiver_group: Optional[str] = None,
    mode: str = "mode2",
    filter_lr: str = "outer",
    top: int = 20,
    spatial_neighbors: str = "spatial_neighbors",
    spatial_distances: str = "spatial_distances",
    min_cells_by_counts: int = 0,
    min_pairs: int = 5,
    min_pairs_ratio: float = 0.01,
    num: int = 1000,
    pvalue: float = 0.05,
    fdr: bool = False,
    n_neighbors: int = 10,
    seed: int = 0,
    device="cuda",
) -> Optional[dict]:
    """Permutation test of L-R co-expression between spatially-adjacent cells
    of a sender and receiver cluster (parity: cci_two_cluster.py:33).

    Returns {'cell_pair': DataFrame, 'lr_pair': DataFrame}; also annotates
    `adata.obs[group + 'sp']` with proximal/distal subclusters. The kNN and
    the scores run on `device`.
    """
    lr_network = _load_lr_network(path, species)
    X = adata.layers[layer] if layer is not None else adata.X
    X = X.toarray() if issparse(X) else np.asarray(X, dtype=float)
    groups = np.asarray(adata.obs[group]).astype(str)
    obs_names = np.asarray(adata.obs_names)

    sender_mask = groups == str(sender_group)
    receiver_mask = groups == str(receiver_group)
    sender_id = obs_names[sender_mask]
    receiver_id = obs_names[receiver_mask]
    cell_pair_all = len(sender_id) * len(receiver_id) / 2

    # spatial KNN pairs
    coords = np.asarray(adata.obsm["spatial"], dtype=float)
    from .find_neighbors import knn

    idx, _ = knn(coords, min(n_neighbors + 1, adata.n_obs), device=device)
    senders, receivers = [], []
    sender_set = set(np.where(sender_mask)[0])
    receiver_set = set(np.where(receiver_mask)[0])
    for i in range(adata.n_obs):
        if i in sender_set:
            for j in idx[i, 1:]:
                if j in receiver_set:
                    senders.append(i)
                    receivers.append(int(j))
    cell_pair = pd.DataFrame(
        {"cell_sender": obs_names[senders], "cell_receiver": obs_names[receivers]}
    )
    cell_pair["cell_pair_name"] = cell_pair["cell_sender"] + ">-<" + cell_pair["cell_receiver"]
    if cell_pair.shape[0] < min_pairs:
        raise ValueError(f"cell pairs found between {sender_group} and {receiver_group} less than min_pairs")
    if cell_pair.shape[0] / max(cell_pair_all, 1) < min_pairs_ratio:
        raise ValueError(
            f"cell pairs found between {sender_group} and {receiver_group} less than min_pairs_ratio"
        )

    # proximal / distal subclusters
    group_sp = group + "sp"
    sp = groups.copy().astype(object)
    prox_senders = set(cell_pair["cell_sender"])
    prox_receivers = set(cell_pair["cell_receiver"])
    for i, name in enumerate(obs_names):
        if name in prox_senders:
            sp[i] = f"{sender_group}_prox"
        elif name in prox_receivers:
            sp[i] = f"{receiver_group}_prox"
        elif sender_mask[i]:
            sp[i] = f"{sender_group}_dist"
        elif receiver_mask[i]:
            sp[i] = f"{receiver_group}_dist"
    adata.obs[group_sp] = sp

    # candidate LR pairs
    if lr_pair is None:
        lr_network = lr_network[lr_network["from"].isin(adata.var_names) & lr_network["to"].isin(adata.var_names)]
        if min_cells_by_counts > 0:
            n_expr = (X > 0).sum(axis=0)
            expr_ok = set(np.asarray(adata.var_names)[n_expr >= min_cells_by_counts])
            lr_network = lr_network[lr_network["from"].isin(expr_ok) & lr_network["to"].isin(expr_ok)]
    else:
        lr_network = lr_network[lr_network["lr_pair"].isin(lr_pair)]
    if lr_network.empty:
        raise ValueError("No intersected ligand-receptor pairs between your adata object and the L-R database.")

    var_idx = {g: i for i, g in enumerate(adata.var_names)}
    lig_cols = np.array([var_idx[l] for l in lr_network["from"]])
    rec_cols = np.array([var_idx[r] for r in lr_network["to"]])

    s_idx = np.asarray(senders)
    r_idx = np.asarray(receivers)
    lig_expr = X[:, lig_cols]  # [n, P]
    rec_expr = X[:, rec_cols]

    # observed score per LR pair: mean over pairs of lig(sender) * rec(receiver), float32
    lig_d = _to_device(lig_expr, device, torch.float32)
    rec_d = _to_device(rec_expr, device, torch.float32)
    s_d = _to_device(s_idx.astype(np.int64), device)
    r_d = _to_device(r_idx.astype(np.int64), device)
    obs_score = (lig_d[s_d] * rec_d[r_d]).mean(0)

    # permutation null: permute which cells are senders/receivers (host draws, the JAX order)
    rng = np.random.default_rng(seed)
    n_pairs = len(s_idx)
    perm = np.empty((2, num, n_pairs), np.int64)
    for p in range(num):
        perm[0, p] = rng.choice(adata.n_obs, n_pairs, replace=True)
        perm[1, p] = rng.choice(adata.n_obs, n_pairs, replace=True)
    perm_d = _to_device(perm.astype(np.int32), device).long()
    scores = torch.cat([obs_score[None], permutation_null(lig_d, rec_d, perm_d[0], perm_d[1])]).cpu().numpy()
    obs_score, null = scores[0], scores[1:]
    pvals = ((null >= obs_score[None, :]).sum(axis=0) + 1) / (num + 1)

    lr_df = pd.DataFrame(
        {
            "lr_pair": lr_network["lr_pair"].values,
            "from": lr_network["from"].values,
            "to": lr_network["to"].values,
            "lr_co_exp_num": ((lig_expr[s_idx] > 0) & (rec_expr[r_idx] > 0)).sum(axis=0),
            "lr_co_exp_ratio": ((lig_expr[s_idx] > 0) & (rec_expr[r_idx] > 0)).mean(axis=0),
            "lr_score": obs_score,
            "lr_value": pvals,
        }
    )
    if fdr:
        lr_df["lr_qvalue"] = multipletests_bh(lr_df["lr_value"].values)
        lr_df = lr_df[lr_df["lr_qvalue"] < pvalue]
    else:
        lr_df = lr_df[lr_df["lr_value"] < pvalue]
    lr_df = lr_df.sort_values("lr_score", ascending=False)
    return {"cell_pair": cell_pair, "lr_pair": lr_df}


def prepare_cci_cellpair_adata(
    adata: AnnData,
    sender_group: Optional[str] = None,
    receiver_group: Optional[str] = None,
    group: Optional[str] = None,
    cci_dict: Optional[dict] = None,
    all_cell_pair: bool = False,
) -> AnnData:
    """Mark sender/receiver cell pairs for plotting (parity:
    cci_two_cluster.py helper)."""
    adata.obs["spec"] = "other"
    if cci_dict is not None and not all_cell_pair:
        send = set(cci_dict["cell_pair"]["cell_sender"])
        recv = set(cci_dict["cell_pair"]["cell_receiver"])
        adata.obs.loc[[n in send for n in adata.obs_names], "spec"] = "sender"
        adata.obs.loc[[n in recv for n in adata.obs_names], "spec"] = "receiver"
    else:
        groups = np.asarray(adata.obs[group]).astype(str)
        adata.obs.loc[groups == str(sender_group), "spec"] = "sender"
        adata.obs.loc[groups == str(receiver_group), "spec"] = "receiver"
    return adata


def prepare_cci_df(cci_df: pd.DataFrame, means_col: str, pval_col: str, lr_pair_col: str, sr_pair_col: str):
    """Split a CCI result table into ligrec-ready 'means' and 'pvalues'
    DataFrames (interaction-pair rows x 'sender|receiver' columns), the
    structure `st.pl.ligrec` consumes (parity: reference
    cci_two_cluster.py:446)."""
    df = cci_df.copy()
    split = df[sr_pair_col].str.split("-", expand=True)
    df["sender"], df["receiver"] = split[0], split[1]
    df["_col"] = df["sender"] + "|" + df["receiver"]
    means = df.pivot_table(index=lr_pair_col, columns="_col", values=means_col, aggfunc="mean")
    pvals = df.pivot_table(index=lr_pair_col, columns="_col", values=pval_col, aggfunc="mean")
    pvals = pvals.reindex(index=means.index, columns=means.columns)
    means.index.name = pvals.index.name = None
    means.columns.name = pvals.columns.name = None
    return {"means": means, "pvalues": pvals}


def calculate_group_pair_lr_pair(adata, group, group_pairs, cols, lr_network) -> pd.DataFrame:
    """Mean (ligand_in_sender + receptor_in_receiver)/2 per L-R pair and
    group pair (parity: reference cci_two_cluster.py:417)."""
    from scipy.sparse import issparse

    names = list(map(str, adata.var_names))
    X = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X, dtype=float)
    lig_idx = [names.index(str(g)) for g in lr_network["from"]]
    rec_idx = [names.index(str(g)) for g in lr_network["to"]]
    groups = np.asarray(adata.obs[group]).astype(str)

    dfl = pd.DataFrame(index=lr_network["lr_pair"], columns=cols, dtype=float)
    dfr = pd.DataFrame(index=lr_network["lr_pair"], columns=cols, dtype=float)
    for g in cols:
        m = groups == str(g)
        dfl[g] = X[m][:, lig_idx].mean(axis=0) if m.any() else 0.0
        dfr[g] = X[m][:, rec_idx].mean(axis=0) if m.any() else 0.0
    df = pd.DataFrame(index=lr_network["lr_pair"], columns=pd.Index(group_pairs, tupleize_cols=False), dtype=float)
    for gp in group_pairs:
        df[gp] = (dfl[gp[0]].values + dfr[gp[1]].values) / 2
    return df
