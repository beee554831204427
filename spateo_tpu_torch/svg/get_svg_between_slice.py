"""Cross-slice SVG detection via Gromov-Wasserstein distances (counterpart of
`spateo_tpu.svg.get_svg_between_slice`; reference
spateo/svg/get_svg_between_slice.py:25-156).

Per-gene GW distances between two slices are entropic-proximal GW
(alpha = 1 `ops.ot.fgw`) on `device`, one solve a gene, as in the JAX
package; the costs C1, C2 go to the device once a call."""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import pandas as pd
import torch
from scipy.sparse import issparse
from scipy.stats import norm

from ..alignment.methods.math import as_tensor
from ..core.anndata import AnnData
from .get_svg import bin_scale_adata_get_distance
from .utils import multipletests_hs, shuffle_adata


def cal_gw_dis_on_genes(inp1, inp2, device="cuda") -> Tuple[List, List, List, List]:
    """GW distance + positive-expression ratios per gene between two slices
    (parity: between_slice.py:130-156 — only the SECOND slice is shuffled
    for the bootstrap, :134-135; seed 0 = unshuffled observed statistic).

    ``inp1 = (C1, C2, adata1, adata2)``, ``inp2 = (seed, gene_set)``;
    returns ``(gene_set, gws, pos_r1s, pos_r2s)``.
    """
    from ..ops.ot import fgw

    C1, C2, adata1, adata2 = inp1
    C1_d, C2_d = (as_tensor(np.asarray(C, np.float32), device) for C in (C1, C2))
    seed, gene_set = inp2
    adata2 = shuffle_adata(adata2, seed)

    X1 = adata1.X.toarray() if issparse(adata1.X) else np.asarray(adata1.X)
    X2 = adata2.X.toarray() if issparse(adata2.X) else np.asarray(adata2.X)
    gws, pos_r1s, pos_r2s = [], [], []
    dummy_M = torch.zeros((C1.shape[0], C2.shape[0]), dtype=torch.float32, device=C1_d.device)
    eps = max(float(np.maximum(C1.max(), C2.max())) * 1e-2, 1e-4)
    for gene_id in gene_set:
        p = X1[:, adata1.var_names.get_loc(gene_id)].astype(np.float64)
        q = X2[:, adata2.var_names.get_loc(gene_id)].astype(np.float64)
        psum, qsum = p.sum(), q.sum()
        if psum == 0 or qsum == 0:
            gws.append(0.0)
            pos_r1s.append(float(np.sum(p > 0) / len(p)))
            pos_r2s.append(float(np.sum(q > 0) / len(q)))
            continue
        p = p / psum
        q = q / qsum
        _, obj = fgw(dummy_M, C1_d, C2_d, p, q, alpha=1.0, eps=eps, max_iter=30, device=device)
        gws.append(float(obj))
        pos_r1s.append(float(np.sum(p > 0) / len(p)))
        pos_r2s.append(float(np.sum(q > 0) / len(q)))
    return list(gene_set), gws, pos_r1s, pos_r2s


def cal_gro_wass_bs(
    adata1: AnnData,
    adata2: AnnData,
    bin_size1: int = 1,
    bin_size2: int = 1,
    bin_layer: str = "spatial",
    cell_distance_method: str = "geodesic",
    distance_layer: str = "spatial",
    n_neighbors: int = 30,
    gene_set: Union[List, np.ndarray] = None,
    processes: int = 1,
    bootstrap: int = 100,
    min_dis_cutoff: float = 2.0,
    max_dis_cutoff: float = 6.0,
    larger_or_small: str = "larger",
    device="cuda",
):
    """Per-gene cross-slice Gromov-Wasserstein with bootstrap permutation
    p-values (parity: between_slice.py:25-128 — same signature, output
    columns ``Gromov-wasserstein_distance``/``positive_ratio1``/
    ``positive_ratio2``/``mean``/``std``/``zscore``/``pvalue``/
    ``adj_pvalue``/``fc``/``log2fc``/``-log10adjp`` indexed by gene, same
    Holm-Sidak adjustment (the reference's statsmodels default), and the
    same ``(gw_df, adata1, adata2)`` return of the binned/scaled slices).

    ``processes`` is accepted for signature parity; the per-gene solves run
    one after another on `device` instead of over host processes.
    """
    adata1, C1 = bin_scale_adata_get_distance(
        adata1,
        bin_size=bin_size1,
        bin_layer=bin_layer,
        distance_layer=distance_layer,
        min_dis_cutoff=min_dis_cutoff,
        max_dis_cutoff=max_dis_cutoff,
        cell_distance_method=cell_distance_method,
        n_neighbors=n_neighbors,
    )
    adata2, C2 = bin_scale_adata_get_distance(
        adata2,
        bin_size=bin_size2,
        bin_layer=bin_layer,
        distance_layer=distance_layer,
        min_dis_cutoff=min_dis_cutoff,
        max_dis_cutoff=max_dis_cutoff,
        cell_distance_method=cell_distance_method,
        n_neighbors=n_neighbors,
    )
    # the reference exits the interpreter here (between_slice.py:63-69);
    # raise instead so library users get a recoverable error
    if gene_set is None:
        raise ValueError("Please provide gene_set")
    gene_set_ov = np.intersect1d(adata1.var_names, adata2.var_names)
    if np.isin(gene_set, gene_set_ov, invert=True).any():
        raise ValueError("gene_set is not all in intersection of two adata")

    genes, gws, pos_r1s, pos_r2s = cal_gw_dis_on_genes((C1, C2, adata1, adata2), (0, gene_set), device)
    gw_df0 = pd.DataFrame(
        {
            "gene_id": list(gene_set),
            "Gromov-wasserstein_distance": gws,
            "positive_ratio1": pos_r1s,
            "positive_ratio2": pos_r2s,
        }
    )

    boot_genes, boot_gws = [], []
    for seed in range(1, bootstrap + 1):
        g, w, _, _ = cal_gw_dis_on_genes((C1, C2, adata1, adata2), (seed, gene_set), device)
        boot_genes += list(g)
        boot_gws += list(w)

    gw_df = gw_df0.set_index("gene_id")
    if bootstrap > 0:
        boot = pd.DataFrame({"gene_id": boot_genes, "w": boot_gws})
        stats = boot.groupby("gene_id")["w"].agg(["mean", "std"])
        gw_df["mean"] = stats["mean"].reindex(gw_df.index).values
        gw_df["std"] = stats["std"].reindex(gw_df.index).values
        with np.errstate(divide="ignore", invalid="ignore"):
            gw_df["zscore"] = (gw_df["Gromov-wasserstein_distance"] - gw_df["mean"]) / gw_df["std"]
        gw_df = gw_df.replace(np.inf, 0).replace(np.nan, 0)

        if larger_or_small == "larger":
            gw_df["pvalue"] = norm.sf(gw_df["zscore"])
        elif larger_or_small == "small":
            gw_df["pvalue"] = 1 - norm.sf(gw_df["zscore"])
        gw_df["adj_pvalue"] = multipletests_hs(gw_df["pvalue"].values)

        with np.errstate(divide="ignore", invalid="ignore"):
            gw_df["fc"] = gw_df["Gromov-wasserstein_distance"] / gw_df["mean"]
            gw_df["log2fc"] = np.log2(gw_df["fc"])
            gw_df["-log10adjp"] = -np.log10(gw_df["adj_pvalue"])
        gw_df = gw_df.replace(np.inf, 0).replace(np.nan, 0)
    return gw_df, adata1, adata2
