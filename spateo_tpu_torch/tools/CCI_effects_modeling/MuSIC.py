"""MuSIC: spatially-weighted regression of cell-cell-interaction effects.

Capability parity with reference spateo/tools/CCI_effects_modeling/MuSIC.py:39
(`load_and_process`:470, `define_sig_inputs`:870 — incl. membrane-bound vs
secreted spatial weights :1490-1580, heterocomplex combination :1189-1226,
unpaired-L/R masking :1811-1864 — `run_subsample`:2086 (total-counts
filtering + spatially-stratified per-target draws + unsampled->sampled
mapping), `_set_search_range`:2530, `_compute_all_wi`:2606, `local_fit`:2665
(hurdle-style conditioned weights), `find_optimal_bw`:2837, `mpi_fit`:2940,
`fit`:3183 (per-target GRN feature filtering, concurrence skip, correlation
feature mask), `predict`:3570, AICc :3644-3675, `save_results`:3709,
`return_outputs`:3775).

Counterpart of `spateo_tpu.tools.CCI_effects_modeling.MuSIC`, method for
method. The reference's vestigial-MPI per-cell loop (`mpi_fit` iterating
`self.x_chunk` serially) is one batched fit on the device: the per-cell
conditioned spatial weights (the reference's `get_wi(i, cov=..., ct=...)`
loop) are one [q, n] tensor on the device
(`find_neighbors._conditioned_kernel_weights_batch`), masked there, and
every cell's local GLM is solved from it by `regression_utils.iwls_batch_full`,
which copies only the [q, k] and [q] results to the host. The golden-section
bandwidth search, the design matrix, subsampling, AICc and the outputs are
host code, as in the JAX package. The model runs on ``device`` (a keyword of
the constructor, default ``"cuda"``).

The CCI databases are read as data from the JAX package's
`tools/database/` directory by file path (``cci_dir=`` overrides it); no code
of that package runs. `normalize=True` takes `preprocessing.normalize_total`,
`smooth=True` `svg.get_svg.smooth`, and `spatial_subsample=True` the strata
of `ops.kmeans.KMeans`. `load_state` takes a design built elsewhere (for
example the JAX package's, through `core.bridge.music_state_from_reference`).
"""

from __future__ import annotations

import itertools
import json
import os
from itertools import product
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import pandas as pd
import scipy.sparse
from scipy.sparse import issparse

import torch

from ...core.anndata import AnnData, read_h5ad
from ...core.bridge import _to_device
from ...logging import logger_manager as lm
from ..find_neighbors import _conditioned_kernel_weights_batch, get_wi_batch
from .regression_utils import _family, iwls_batch_full, multicollinearity_check

#: The CCI databases (CSV data) shipped in the repository beside the JAX package.
_DB_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "spateo_tpu", "tools", "database")
)

#: The state `load_state` takes (`core.bridge.music_state_from_reference` returns it).
STATE_KEYS = (
    "X", "feature_names", "targets_expr", "coords", "sample_names", "ct_vec", "x_chunk", "subsampled",
    "subsampled_indices", "n_samples_subsampled", "subsampled_sample_names", "neighboring_unsampled",
    "spatial_weights_membrane_bound", "spatial_weights_secreted", "spatial_weights_niche",
    "ligands_expr", "ligands_expr_nonlag", "receptors_expr",
)


def _read_db_csv(path: str) -> Optional[pd.DataFrame]:
    """Read a database CSV, returning None for missing files or git-lfs
    pointer stubs (the GRN files ship as LFS pointers)."""
    try:
        with open(path, "rb") as f:
            head = f.read(40)
        if b"git-lfs" in head:
            return None
        return pd.read_csv(path, index_col=0)
    except (FileNotFoundError, OSError):
        return None


def _clean_cat(s: str) -> str:
    """Category name -> single alphanumeric word, first letters capitalized
    (reference MuSIC.py:1022)."""
    import re

    return re.sub(r"\b([a-zA-Z0-9])", lambda m: m.group(1).upper(), re.sub(r"[^a-zA-Z0-9]+", "", str(s)))


class MuSIC:
    """Spatially weighted regression on spatial omics data with parallel
    processing (parity surface: reference MuSIC.py:39)."""

    def __init__(self, parser=None, args_list: Optional[List[str]] = None, verbose: bool = True, **kwargs):
        self.logger = lm.get_main_logger()
        self.verbose = verbose
        if parser is not None:
            self.arg_retrieve = parser.parse_args(args_list)
            self.parse_stgwr_args()
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._set_defaults()
        self._fitted = False
        self.set_up = False

    # -- configuration ------------------------------------------------------
    def _set_defaults(self):
        defaults = dict(
            adata_path=None,
            csv_path=None,
            mod_type="niche",
            species="human",
            cci_dir=_DB_DIR,
            output_path="./music_results/results.csv",
            custom_ligands=None,
            custom_lig_path=None,
            custom_receptors=None,
            custom_rec_path=None,
            custom_pathways=None,
            custom_pathways_path=None,
            custom_targets=None,
            targets_path=None,
            init_betas_path=None,
            init_betas=None,
            normalize=False,
            smooth=False,
            log_transform=False,
            normalize_signaling=False,
            target_expr_threshold=0.05,
            multicollinear_threshold=None,
            include_unpaired_lr=False,
            coords_key="spatial",
            group_key="cell_type",
            group_subset=None,
            covariate_keys=None,
            total_counts_key="total_counts",
            total_counts_threshold=0.0,
            distr="gaussian",
            kernel="bisquare",
            bw=None,
            minbw=None,
            maxbw=None,
            bw_fixed=False,
            exclude_self=True,
            n_neighbors=10,
            n_neighbors_membrane_bound=8,
            n_neighbors_secreted=25,
            distance_membrane_bound=None,
            distance_secreted=None,
            use_expression_neighbors=False,
            fit_intercept=True,
            no_hurdle=False,
            tolerance=1e-3,
            max_iter=500,
            patience=5,
            ridge_lambda=0.3,
            subsample=False,
            spatial_subsample=False,
            subsample_size=5000,
            seed=888,
            clip=5.0,
            device="cuda",
        )
        for k, v in defaults.items():
            if not hasattr(self, k):
                setattr(self, k, v)
        if self.cci_dir is None:
            self.cci_dir = _DB_DIR
        # round-1 compat: `subsample=True` means spatially-stratified subsampling
        if getattr(self, "subsample", False):
            self.spatial_subsample = True
        self.n_neighbors_niche = self.n_neighbors_secreted
        self.distr_obj = _family(self.distr)

    def parse_stgwr_args(self):
        """Flags -> attributes (parity: reference MuSIC.py:327)."""
        a = self.arg_retrieve
        for key, val in vars(a).items():
            setattr(self, key, val)

    # -- data loading -------------------------------------------------------
    def load_and_process(self, upstream: bool = False):
        """Load AnnData and preprocess (parity: reference MuSIC.py:470)."""
        if getattr(self, "adata", None) is None:
            if self.adata_path is not None:
                self.adata = read_h5ad(self.adata_path)
            elif self.csv_path is not None:
                df = pd.read_csv(self.csv_path, index_col=0)
                coords = df.iloc[:, :2].values
                expr = df.iloc[:, 2:]
                self.adata = AnnData(
                    X=expr.values, obs=pd.DataFrame(index=df.index), var=pd.DataFrame(index=expr.columns)
                )
                self.adata.obsm[self.coords_key] = coords
            else:
                raise ValueError("Provide `adata_path`, `csv_path` or an `adata` object.")
        # group_subset: keep cells of the chosen groups plus their spatial
        # neighbors (reference MuSIC.py:513-530)
        if self.group_subset is not None and self.group_key in self.adata.obs:
            in_group = np.asarray(
                pd.Series(np.asarray(self.adata.obs[self.group_key]).astype(str)).isin(
                    [str(g) for g in np.atleast_1d(self.group_subset)]
                )
            )
            coords_all = np.asarray(self.adata.obsm[self.coords_key], float)[:, :2]
            from scipy.spatial import cKDTree

            tree = cKDTree(coords_all[in_group])
            d, _ = tree.query(coords_all, k=1)
            radius = np.median(tree.query(coords_all[in_group], k=min(self.n_neighbors + 1, int(in_group.sum())))[0][:, -1])
            keep = in_group | (d <= radius)
            self.group_subsampled_sample_names = pd.Index(np.asarray(self.adata.obs_names)[in_group])
            self.adata = self.adata[np.flatnonzero(keep)]
        self.sample_names = pd.Index(np.asarray(self.adata.obs_names))
        self.coords = np.asarray(self.adata.obsm[self.coords_key], dtype=float)[:, :2]
        self.n_samples = self.adata.n_obs
        self.x_chunk = np.arange(self.n_samples)
        if self.normalize:
            from ...preprocessing.normalize import normalize_total

            normalize_total(self.adata)
        if self.smooth:
            from ...svg.get_svg import smooth as smooth_fn

            self.adata = smooth_fn(self.adata)
        if self.log_transform:
            from ...preprocessing.transform import log1p

            log1p(self.adata)

    # -- databases ----------------------------------------------------------
    def _load_db(self):
        sp = self.species
        if self.cci_dir is None:
            self.cci_dir = _DB_DIR
        if sp not in ("human", "mouse"):
            raise ValueError("Invalid species specified. Must be one of 'human' or 'mouse'.")
        self.lr_db = _read_db_csv(os.path.join(self.cci_dir, f"lr_db_{sp}.csv"))
        if self.lr_db is None:
            raise FileNotFoundError(f"CCI resources cannot be found at {self.cci_dir}.")
        self.r_tf_db = _read_db_csv(os.path.join(self.cci_dir, f"{sp}_receptor_TF_db.csv"))
        self.tf_target_db = _read_db_csv(os.path.join(self.cci_dir, f"{sp}_TF_target_db.csv"))
        self.grn = _read_db_csv(os.path.join(self.cci_dir, f"{sp}_GRN.csv"))

    # -- spatial weights -----------------------------------------------------
    def _compute_all_wi(
        self,
        bw: Union[float, int],
        bw_fixed: Optional[bool] = None,
        exclude_self: Optional[bool] = None,
        kernel: Optional[str] = None,
        verbose: bool = False,
    ) -> scipy.sparse.csr_matrix:
        """Spatial weights of every sample, computed on the device in blocks
        of query rows and returned as host CSR (parity: reference
        MuSIC.py:2606 `_compute_all_wi`, which maps `get_wi` over a process
        Pool)."""
        bw_fixed = self.bw_fixed if bw_fixed is None else bw_fixed
        exclude_self = self.exclude_self if exclude_self is None else exclude_self
        kernel = self.kernel if kernel is None else kernel
        W = get_wi_batch(
            self.coords,
            bw,
            fixed_bw=bw_fixed,
            exclude_self=exclude_self,
            kernel=kernel,
            normalize_weights=bool(self.normalize),
            device=self.device,
        )
        # the reference passes threshold=0.01 for these all-pairs weights
        W[W < 0.01] = 0.0
        return scipy.sparse.csr_matrix(W)

    # -- design matrices ----------------------------------------------------
    def _select_molecules(self, which: str) -> Tuple[List[str], List[str]]:
        """Select candidate ligands or receptors: custom list, pathway subset
        or spatially-variable fallback (parity: reference MuSIC.py:1028-1161
        for ligands, :1230-1313 for receptors). Returns (molecules,
        complexes)."""
        db = self.lr_db
        col = "from" if which == "ligand" else "to"
        database_entries = set(db[col])
        custom = self.custom_ligands if which == "ligand" else self.custom_receptors
        custom_path = self.custom_lig_path if which == "ligand" else self.custom_rec_path
        if custom_path is not None and custom is None:
            with open(custom_path) as f:
                custom = [l for l in f.read().splitlines() if l]
        if custom is not None:
            mols = [m for m in custom if m in database_entries or any(m in e.split("_") for e in database_entries)]
            complexes = [m for m in mols if "_" in m]
            mols = [part for item in mols for part in item.split("_")]
        elif self.custom_pathways is not None or self.custom_pathways_path is not None:
            pathways = self.custom_pathways
            if pathways is None:
                with open(self.custom_pathways_path) as f:
                    pathways = [p for p in f.read().splitlines() if p]
            pathways = [p for p in pathways if p in set(db["pathway"])]
            sub = db[db["pathway"].isin(pathways)]
            entries = list(set(sub[col]))
            complexes = [e for e in entries if "_" in e]
            mols = [part for item in entries for part in item.split("_")]
        else:
            # spatially-variable fallback (reference MuSIC.py:1124-1161)
            complexes = [e for e in database_entries if "_" in e]
            all_mols = [part for item in database_entries for part in item.split("_")]
            from ..spatial_degs import moran_i

            m_degs = moran_i(self.adata, device=self.device)
            m_filter = m_degs[m_degs.moran_q_val < 0.05].sort_values(by=["moran_i"], ascending=False).index
            mols = [g for g in m_filter if g in all_mols]
            if len(mols) == 0:
                m_filter = m_degs.sort_values(by=["moran_i"], ascending=False).index
                mols = [g for g in m_filter if g in all_mols][:10]
            # pull in the other members of any complex a selected member belongs to
            for element in complexes:
                members = element.split("_")
                if any(m in mols for m in members):
                    mols.extend(members)
            mols = list(set(mols))
        # complexes whose components are all among the selected molecules are
        # candidates for geometric-mean combination even when the user listed
        # the components individually (superset of reference custom-path
        # behavior, needed because the database keys pairs by the complex)
        mol_set = set(mols)
        extra = [e for e in database_entries if "_" in e and all(p in mol_set for p in e.split("_"))]
        complexes = sorted(set(complexes) | set(extra))
        mols = [m for m in mols if m in set(self.adata.var_names)]
        return sorted(set(mols)), complexes

    def _combine_complexes(self, expr: pd.DataFrame, complexes: List[str], database_entries: set) -> pd.DataFrame:
        """Geometric-mean heterocomplex combination + component dropping
        (parity: reference MuSIC.py:1189-1226)."""
        to_drop: List[str] = []
        threshold = self.n_samples * self.target_expr_threshold
        for element in complexes:
            parts = element.split("_")
            if all(part in expr.columns for part in parts):
                expr[element] = np.prod(expr[parts].values, axis=1) ** (1.0 / len(parts))
                for part in parts:
                    if part not in database_entries and (expr[part] != 0).sum() > threshold:
                        to_drop.append(part)
            else:
                partial = [p for p in parts if p in expr.columns and p not in database_entries]
                to_drop.extend(partial)
        expr = expr.drop(columns=list(set(to_drop)), errors="ignore")
        return expr.loc[:, ~expr.columns.duplicated(keep="first")]

    def define_sig_inputs(self, adata: Optional[AnnData] = None, recompute: bool = False):
        """Build the independent-variable design matrix (parity: reference
        MuSIC.py:870). Implements the full signaling model: separate
        membrane-bound vs secreted spatial lags, heterocomplexes, unpaired
        L/R masking, covariates and GRN-filtered targets."""
        adata = adata if adata is not None else self.adata
        if not hasattr(self, "coords"):
            self.load_and_process()
            adata = self.adata
        X_raw = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X, dtype=float)
        expr_df = pd.DataFrame(X_raw, index=adata.obs_names, columns=adata.var_names)
        out_stem = os.path.splitext(self.output_path)[0]

        self._load_db_for_model()

        # ------------------------------------------------------------------
        # component arrays
        # ------------------------------------------------------------------
        if self.mod_type == "niche":
            groups = pd.Series(np.asarray(adata.obs[self.group_key]).astype(str), index=adata.obs_names)
            cats = pd.get_dummies(groups, dtype=float)
            cats.columns = [_clean_cat(c) for c in cats.columns]
            self.cell_categories = cats.reindex(sorted(cats.columns), axis=1)

        if self.mod_type in ("lr", "ligand"):
            ligands, l_complexes = self._select_molecules("ligand")
            if not ligands:
                raise ValueError("None of the selected ligands could be found in the dataset.")
            lig_expr = expr_df[ligands].copy()
            lig_expr = self._combine_complexes(lig_expr, l_complexes, set(self.lr_db["from"]))
            self.ligands_expr = lig_expr
            self.ligands_expr_nonlag = lig_expr.copy()

        if self.mod_type in ("lr", "receptor"):
            receptors, r_complexes = self._select_molecules("receptor")
            if not receptors:
                raise ValueError("None of the selected receptors could be found in the dataset.")
            rec_expr = expr_df[receptors].copy()
            if self.normalize_signaling:
                rng_ = rec_expr.max().max() - rec_expr.min().min()
                rec_expr = (rec_expr - rec_expr.min().min()) / max(rng_, 1e-12)
            rec_expr = self._combine_complexes(rec_expr, r_complexes, set(self.lr_db["to"]))
            self.receptors_expr = rec_expr

        # matched L:R pairs (reference MuSIC.py:1380-1426)
        if self.mod_type == "lr":
            lr_ref = self.lr_db[["from", "to"]]
            pairs = lr_ref[
                lr_ref["from"].isin(self.ligands_expr.columns) & lr_ref["to"].isin(self.receptors_expr.columns)
            ].drop_duplicates(keep="first")
            self.lr_pairs = [tuple(x) for x in zip(pairs["from"], pairs["to"])]
            if len(self.lr_pairs) == 0:
                raise RuntimeError(
                    "No matched pairs between the selected ligands and receptors were found. Check the custom "
                    "ligand/receptor lists against the L:R database."
                )
            if not self.include_unpaired_lr:
                keep_l = {p[0] for p in self.lr_pairs}
                keep_r = {p[1] for p in self.lr_pairs}
                self.ligands_expr = self.ligands_expr[[c for c in self.ligands_expr.columns if c in keep_l]]
                self.receptors_expr = self.receptors_expr[[c for c in self.receptors_expr.columns if c in keep_r]]

        # ------------------------------------------------------------------
        # targets (reference MuSIC.py:1431-1488)
        # ------------------------------------------------------------------
        if self.targets_path is not None:
            with open(self.targets_path) as f:
                targets = [t for t in f.read().splitlines() if t in adata.var_names]
        elif self.custom_targets is not None:
            targets = [t for t in self.custom_targets if t in adata.var_names]
        elif self.mod_type in ("lr", "receptor") and self.r_tf_db is not None and self.tf_target_db is not None:
            tf_subset = self.r_tf_db[self.r_tf_db["receptor"].isin(self.receptors_expr.columns)]
            tfs = [tf for tf in set(tf_subset["tf"]) if tf in adata.var_names]
            if tfs:
                tf_pct = (expr_df[tfs] > 0).mean(axis=0).values
                tfs = list(np.asarray(tfs)[tf_pct > self.target_expr_threshold])
            targets_sub = self.tf_target_db[self.tf_target_db["TF"].isin(tfs)]
            targets = [t for t in set(targets_sub["target"]) if t in adata.var_names]
            if targets:
                t_pct = (expr_df[targets] > 0).mean(axis=0).values
                targets = list(np.asarray(targets)[t_pct > self.target_expr_threshold])
        else:
            raise ValueError(
                "For niche and ligand models, `targets_path`/`custom_targets` must be provided. For L:R and "
                "receptor models targets can be inferred from the receptor-TF-target databases."
            )
        if self.mod_type != "niche" and self.grn is not None:
            targets = [t for t in targets if t in self.grn.index]
        targets = sorted(set(targets))
        targets_expr = expr_df[targets].copy()
        for col in targets_expr.columns:
            cap = np.percentile(targets_expr[col], 99.7)
            targets_expr[col] = np.floor(np.where(targets_expr[col] > cap, cap, targets_expr[col]))
        self.targets_expr = targets_expr
        self.targets = targets

        # ------------------------------------------------------------------
        # spatial lag of ligand expression: separate membrane-bound vs
        # secreted weights (reference MuSIC.py:1490-1580)
        # ------------------------------------------------------------------
        if self.mod_type in ("lr", "ligand"):
            Path(os.path.join(out_stem, "spatial_weights")).mkdir(parents=True, exist_ok=True)
            mb_path = os.path.join(out_stem, "spatial_weights", "spatial_weights_membrane_bound.npz")
            sec_path = os.path.join(out_stem, "spatial_weights", "spatial_weights_secreted.npz")
            W_mb = None
            if os.path.exists(mb_path) and not recompute:
                W_mb = scipy.sparse.load_npz(mb_path)
                if W_mb.shape[0] != adata.n_obs:
                    W_mb = None
            if W_mb is None:
                bw = self.n_neighbors_membrane_bound if self.distance_membrane_bound is None else self.distance_membrane_bound
                W_mb = self._compute_all_wi(
                    bw=bw, bw_fixed=self.distance_membrane_bound is not None, exclude_self=True, verbose=False
                )
                scipy.sparse.save_npz(mb_path, W_mb)
            W_sec = None
            if os.path.exists(sec_path) and not recompute:
                W_sec = scipy.sparse.load_npz(sec_path)
                if W_sec.shape[0] != adata.n_obs:
                    W_sec = None
            if W_sec is None:
                bw = self.n_neighbors_secreted if self.distance_secreted is None else self.distance_secreted
                # autocrine signaling is easy with secreted signals -> keep self
                W_sec = self._compute_all_wi(
                    bw=bw, bw_fixed=self.distance_secreted is not None, exclude_self=False, verbose=False
                )
                scipy.sparse.save_npz(sec_path, W_sec)
            self.spatial_weights_membrane_bound = W_mb
            self.spatial_weights_secreted = W_sec

            lagged = np.zeros_like(self.ligands_expr.values, dtype=float)
            for i, ligand in enumerate(self.ligands_expr.columns):
                expr_vec = self.ligands_expr[ligand].values
                matching = self.lr_db[self.lr_db["from"].isin(ligand.split("_")) | (self.lr_db["from"] == ligand)]
                secreted = (
                    matching["type"].str.contains("Secreted Signaling").any()
                    or matching["type"].str.contains("ECM-Receptor").any()
                )
                W = W_sec if secreted else W_mb
                lagged[:, i] = np.asarray(W @ expr_vec).ravel()
            self.ligands_expr = pd.DataFrame(lagged, index=adata.obs_names, columns=self.ligands_expr.columns)
            if self.normalize_signaling:
                rng_ = self.ligands_expr.max().max() - self.ligands_expr.min().min()
                self.ligands_expr = (self.ligands_expr - self.ligands_expr.min().min()) / max(rng_, 1e-12)

        # ------------------------------------------------------------------
        # assemble X_df per mod_type (reference MuSIC.py:1582-1954)
        # ------------------------------------------------------------------
        if self.mod_type == "niche":
            Path(os.path.join(out_stem, "spatial_weights")).mkdir(parents=True, exist_ok=True)
            niche_path = os.path.join(out_stem, "spatial_weights", "spatial_weights_niche.npz")
            if "spatial_weights" in adata.obsp:
                W_niche = adata.obsp["spatial_weights"]
            elif os.path.exists(niche_path) and not recompute:
                W_niche = scipy.sparse.load_npz(niche_path)
            else:
                W_niche = self._compute_all_wi(
                    bw=self.n_neighbors_niche, bw_fixed=False, exclude_self=False, kernel="uniform"
                )
                scipy.sparse.save_npz(niche_path, W_niche)
            adata.obsp["spatial_weights"] = W_niche
            cats = self.cell_categories
            dmat_neighbors = np.asarray((W_niche > 0).astype(int) @ cats.values)
            if len(cats.columns) <= 10:
                # category x neighbor-category interaction, mirroring the
                # reference's patsy dmatrix("categories:dmat_neighbors-1")
                conn_cols = list(product(cats.columns, cats.columns))
                conn_cols.sort(key=lambda x: x[1])
                connections = np.stack(
                    [cats[a].values * dmat_neighbors[:, list(cats.columns).index(b)] for a, b in conn_cols], axis=1
                )
                connections[connections > 1] = 1
                niche_array = np.hstack((cats.values, connections))
                feature_names = list(cats.columns) + [f"{a}-{b}" for a, b in conn_cols]
                X_df = pd.DataFrame(niche_array, index=adata.obs_names, columns=feature_names)
            else:
                dmat_neighbors[dmat_neighbors > 1] = 1
                neighbors_cols = ["Proxim" + c for c in cats.columns]
                X_df = pd.DataFrame(dmat_neighbors, index=adata.obs_names, columns=neighbors_cols)

        elif self.mod_type == "lr":
            lr_labels = [f"{l}:{r}" for l, r in self.lr_pairs]
            X_df = pd.DataFrame(
                {
                    f"{l}:{r}": self.ligands_expr[l].values * self.receptors_expr[r].values
                    for l, r in self.lr_pairs
                },
                index=adata.obs_names,
            )[lr_labels]
            # drop very sparse columns (<0.1% nonzero; reference :1657)
            sparse_cols = [c for c in X_df.columns if (X_df[c] != 0).sum() <= self.n_samples * 0.001]
            X_df = X_df.drop(columns=sparse_cols)
            X_df = X_df.loc[:, (X_df != 0).any(axis=0)]
            if self.multicollinear_threshold is not None:
                X_df = multicollinearity_check(X_df, self.multicollinear_threshold, logger=self.logger)
            X_df = self._combine_overlapping_lr(X_df)
            if self.include_unpaired_lr:
                X_df = self._add_unpaired(X_df)
                unpaired = [c for c in X_df.columns if ":" not in c]
                X_df[unpaired] = X_df[unpaired].apply(np.rint)
            X_df = X_df.apply(np.log1p)
            X_df = X_df.apply(lambda col: (col - col.min()) / max(col.max() - col.min(), 1e-12))
            X_df[X_df < 0.2] = 0

        elif self.mod_type in ("ligand", "receptor"):
            X_df = (self.ligands_expr if self.mod_type == "ligand" else self.receptors_expr).copy()
            X_df = X_df.loc[:, (X_df != 0).any(axis=0)]
            if self.mod_type == "ligand":
                self.ligand_to_check_dict = {}
                for lig in X_df.columns:
                    mask, checked = self._cognate_receptor_mask(lig)
                    self.ligand_to_check_dict[lig] = checked
                    X_df[lig] = X_df[lig] * mask
            if self.multicollinear_threshold is not None:
                X_df = multicollinearity_check(X_df, self.multicollinear_threshold, logger=self.logger)
            X_df = X_df.apply(np.log1p)
            X_df = X_df.apply(lambda col: (col - col.min()) / max(col.max() - col.min(), 1e-12))
            X_df[X_df < 0.3] = 0
        else:
            raise ValueError("Invalid `mod_type`. Must be one of 'niche', 'lr', 'ligand' or 'receptor'.")

        X_df = X_df.fillna(0).replace([np.inf, -np.inf], 0)
        # alphabetize multi-member feature names (reference :1963)
        X_df.columns = [
            ":".join("/".join(sorted(part.split("/"))) for part in str(feat).split(":")) for feat in X_df.columns
        ]

        # save design matrix + components (reference :1968-2026)
        dm_dir = os.path.join(out_stem, "design_matrix")
        Path(dm_dir).mkdir(parents=True, exist_ok=True)
        X_df.to_csv(os.path.join(dm_dir, "design_matrix.csv"))
        if self.mod_type in ("ligand", "lr"):
            self.ligands_expr.to_csv(os.path.join(dm_dir, "ligands_expr.csv"))
            self.ligands_expr_nonlag.to_csv(os.path.join(dm_dir, "ligands_expr_nonlag.csv"))
        if self.mod_type in ("receptor", "lr"):
            self.receptors_expr.to_csv(os.path.join(dm_dir, "receptors_expr.csv"))
        if self.mod_type == "niche":
            self.cell_categories.to_csv(os.path.join(dm_dir, "cell_categories.csv"))
        self.targets_expr.to_csv(os.path.join(dm_dir, "targets.csv"))

        self.X = X_df.values.astype(float)
        self.feature_names = list(X_df.columns)
        if self.mod_type == "ligand":
            self.ligands = self.feature_names
        elif self.mod_type == "receptor":
            self.receptors = self.feature_names
        elif self.mod_type == "lr":
            self.lr_pairs = [tuple(p.split(":")) for p in self.feature_names if ":" in p]

        # covariates (reference :2044)
        if self.covariate_keys is not None:
            matched_obs = [k for k in self.covariate_keys if k in self.adata.obs]
            matched_var = [k for k in self.covariate_keys if k in set(self.adata.var_names)]
            for key in self.covariate_keys:
                if key not in matched_obs and key not in matched_var:
                    self.logger.info(f"Covariate key '{key}' not found in adata; not adding it to X.")
            cov_parts = []
            if matched_obs:
                cov_parts.append(np.asarray(self.adata.obs[matched_obs].values, float))
            if matched_var:
                cov_parts.append(
                    np.asarray(expr_df[matched_var].values, float)
                )
            if cov_parts:
                self.X = np.concatenate([self.X] + cov_parts, axis=1)
                self.feature_names += matched_obs + matched_var

        if self.fit_intercept:
            self.X = np.concatenate((np.ones((self.X.shape[0], 1)), self.X), axis=1)
            self.feature_names = ["intercept"] + self.feature_names

        # prevent all-zero rows (reference :2070)
        zero_rows = np.where(~np.any(self.X != 0, axis=1))[0]
        if zero_rows.size:
            self.X[zero_rows, 0] += 1e-6

        self.n_features = self.X.shape[1]
        self.X_df = pd.DataFrame(self.X, columns=self.feature_names, index=adata.obs_names)
        # distance in "signaling space" (reference :2080)
        self.feature_distance = np.where(self.X > 0, 1, 0) if self.mod_type != "niche" else None
        return self.X_df

    def _load_db_for_model(self):
        """The databases `mod_type` reads: all of them for signaling models,
        the L:R table and the GRN for niche models."""
        if self.mod_type in ("lr", "ligand", "receptor"):
            self._load_db()
        else:
            self.lr_db = _read_db_csv(os.path.join(self.cci_dir, f"lr_db_{self.species}.csv"))
            self.grn = _read_db_csv(os.path.join(self.cci_dir, f"{self.species}_GRN.csv"))

    def load_state(self, state: dict):
        """Take a design built elsewhere instead of `define_sig_inputs`:
        `state` holds the `STATE_KEYS` (X with the intercept column,
        feature_names, targets_expr, coords, sample_names, ct_vec, x_chunk,
        the subsampling dictionaries, the spatial weights and, where present,
        the ligand and receptor expression frames), as
        `core.bridge.music_state_from_reference` returns them from a JAX
        package `MuSIC` after `define_sig_inputs`. `self.adata` must be set
        (its obs and var are read by `fit`). The model is then set up: `fit`
        fits this design."""
        for key in STATE_KEYS:
            if key in state and state[key] is not None:
                setattr(self, key, state[key])
        self.sample_names = pd.Index(self.sample_names)
        self.X = np.asarray(self.X, float)
        self.feature_names = list(self.feature_names)
        self.targets = list(self.targets_expr.columns)
        self.n_samples = self.X.shape[0]
        self.n_features = self.X.shape[1]
        self.X_df = pd.DataFrame(self.X, columns=self.feature_names, index=self.sample_names)
        self.feature_distance = np.where(self.X > 0, 1, 0) if self.mod_type != "niche" else None
        self.subsampled = bool(state.get("subsampled", False))
        self.fitted_indices = self.x_chunk
        self._load_db_for_model()
        self.set_up = True
        return self

    def _cognate_receptor_mask(self, lig: str) -> Tuple[np.ndarray, List[str]]:
        """Boolean mask over cells: 1 where cognate receptors (or
        receptor-associated TFs) of `lig` are present (reference
        MuSIC.py:1894-1931). Returns (mask, checked_genes)."""
        adata = self.adata
        assoc = self.lr_db[self.lr_db["from"] == lig]["to"].unique().tolist()
        assoc = [comp for item in assoc for comp in str(item).split("_")]
        assoc = [r for r in assoc if r in set(adata.var_names)]
        X = adata.X
        names = list(map(str, adata.var_names))
        n_cell_threshold = min(100, self.target_expr_threshold * self.n_samples)

        def col_sum(g):
            j = names.index(g)
            col = X[:, j]
            return float(col.sum()) if not issparse(X) else float(col.sum())

        above = [r for r in assoc if col_sum(r) > n_cell_threshold]
        if above:
            to_check, thr = above, 0
        else:
            tfs = []
            if self.r_tf_db is not None:
                tfs = self.r_tf_db[self.r_tf_db["receptor"].isin(assoc)]["tf"].unique().tolist()
            to_check = [comp for item in (assoc + tfs) for comp in str(item).split("_")]
            to_check = [g for g in to_check if g in names]
            thr = 3
        to_check = list(dict.fromkeys(to_check))
        if not to_check:
            return np.ones(self.n_samples), []
        idx = [names.index(g) for g in to_check]
        sub = X[:, idx]
        sub = sub.toarray() if issparse(sub) else np.asarray(sub)
        mask = (sub.sum(axis=1) > thr).astype(float).ravel()
        return mask, to_check

    def _combine_overlapping_lr(self, X_df: pd.DataFrame) -> pd.DataFrame:
        """Per-receptor combination of highly-overlapping ligand features
        (parity: reference MuSIC.py:1679-1809)."""
        pair_cols = [c for c in X_df.columns if ":" in c]
        receptors = sorted({c.split(":")[1] for c in pair_cols})
        for receptor in receptors:
            receptor_cols = [c for c in pair_cols if c.split(":")[1] == receptor and c in X_df.columns]
            if len(receptor_cols) <= 1:
                continue
            ligands = [c.split(":")[0] for c in receptor_cols]
            receptor_df = X_df[(X_df[receptor_cols] != 0).any(axis=1)]
            if len(receptor_df) == 0:
                continue
            overlap = (receptor_df[receptor_cols] != 0).all(axis=1).mean()
            k = len(receptor_cols)
            threshold = 0.67 if k == 2 else 0.5 if k == 3 else 0.4 if k == 4 else 0.33 if k >= 5 else 1
            if overlap > threshold:
                combined_col = f"{'/'.join(ligands)}:{receptor}"
                X_df[combined_col] = X_df[receptor_cols].mean(axis=1)
                X_df = X_df.drop(columns=receptor_cols)
            else:
                overlaps = {}
                for l1, l2 in itertools.combinations(ligands, 2):
                    overlaps[(l1, l2)] = (
                        (receptor_df[[f"{l1}:{receptor}", f"{l2}:{receptor}"]] != 0).all(axis=1).mean()
                    )
                cols_to_drop = set()
                for ligand in ligands:
                    exceeding = [p for p in overlaps if ligand in p and overlaps[p] > 0.67]
                    if len(exceeding) > 1:
                        combined = sorted(set(itertools.chain(*exceeding)))
                        combined_cols = [f"{l}:{receptor}" for l in combined]
                        kc = len(combined_cols)
                        thr = 0.67 if kc == 2 else 0.5 if kc == 3 else 0.4 if kc == 4 else 0.33 if kc >= 5 else 1
                        cdf = receptor_df[(receptor_df[combined_cols] != 0).any(axis=1)]
                        c_overlap = (cdf[combined_cols] != 0).all(axis=1).mean() if len(cdf) else 0.0
                        if c_overlap > thr:
                            X_df[f"{'/'.join(combined)}:{receptor}"] = X_df[combined_cols].mean(axis=1)
                            cols_to_drop.update(combined_cols)
                        else:
                            for pair in exceeding:
                                other = pair[0] if pair[1] == ligand else pair[1]
                                X_df[f"{ligand}/{other}:{receptor}"] = X_df[
                                    [f"{ligand}:{receptor}", f"{other}:{receptor}"]
                                ].mean(axis=1)
                                cols_to_drop.update([f"{ligand}:{receptor}", f"{other}:{receptor}"])
                X_df = X_df.drop(columns=list(cols_to_drop))
        # keep the most comprehensive of subset-overlapping combined columns
        left = [set(c.split(":")[0].split("/")) for c in X_df.columns]
        right = [c.split(":")[1] if ":" in c else "" for c in X_df.columns]
        keep = []
        for i, col in enumerate(X_df.columns):
            if any(
                i != j and left[i].issubset(left[j]) and left[i] != left[j] and right[i] == right[j]
                for j in range(len(X_df.columns))
            ):
                continue
            keep.append(col)
        return X_df[keep]

    def _add_unpaired(self, X_df: pd.DataFrame) -> pd.DataFrame:
        """Add unpaired ligands (masked by cognate receptor/TF presence) and
        receptors (parity: reference MuSIC.py:1811-1864)."""
        paired_l = {p[0] for p in self.lr_pairs}
        for lig in [l for l in self.ligands_expr.columns if l not in paired_l]:
            mask, _ = self._cognate_receptor_mask(lig)
            X_df[lig] = self.ligands_expr[lig].values * mask
        paired_r = {p[1] for p in self.lr_pairs}
        for rec in [r for r in self.receptors_expr.columns if r not in paired_r]:
            X_df[rec] = self.receptors_expr[rec].values
        return X_df

    # -- model setup ---------------------------------------------------------
    def _set_up_model(self, verbose: bool = True):
        self.load_and_process()
        self.define_sig_inputs()
        if self.spatial_subsample or self.total_counts_threshold != 0.0:
            self.run_subsample(verbose=verbose)
            self.subsampled = True
        else:
            self.x_chunk = np.arange(self.n_samples)
            self.subsampled = False
        self.fitted_indices = self.x_chunk
        self.set_up = True

    def run_subsample(self, verbose: bool = True, y: Optional[pd.DataFrame] = None):
        """Per-target subsampling for very large N (parity: reference
        MuSIC.py:2086): optional total-counts filtering, then spatially
        stratified draws (KMeans strata, balanced zero/nonzero sampling) and
        a mapping from each unsampled cell to its closest sampled cell with a
        matching zero/nonzero expression pattern.

        Sets `subsampled_indices`, `n_samples_subsampled`,
        `subsampled_sample_names`, `neighboring_unsampled` (all per-target
        dictionaries) and writes them as JSON checkpoints."""
        parent_dir = os.path.dirname(self.output_path) or "."
        Path(os.path.join(parent_dir, "subsampling")).mkdir(parents=True, exist_ok=True)
        _, filename = os.path.split(self.output_path)
        filename = os.path.splitext(filename)[0]
        neighboring_unsampled_path = os.path.join(parent_dir, "subsampling", f"{filename}.json")
        subsampled_names_path = os.path.join(parent_dir, "subsampling", f"{filename}_cell_names.json")

        y_arr = y if y is not None else (self.targets_expr if hasattr(self, "targets_expr") else self.target)
        existing_targets = set()
        if os.path.exists(neighboring_unsampled_path) and os.path.exists(subsampled_names_path):
            if verbose:
                self.logger.info("Loading existing subsampling results from previous run and resuming...")
            with open(neighboring_unsampled_path) as f:
                self.neighboring_unsampled = json.load(f)
            with open(subsampled_names_path) as f:
                self.subsampled_sample_names = json.load(f)
            existing_targets.update(self.neighboring_unsampled.keys())
            self.subsampled_indices = {
                t: [self.sample_names.get_loc(n) for n in names]
                for t, names in self.subsampled_sample_names.items()
            }
            self.n_samples_subsampled = {t: len(v) for t, v in self.subsampled_indices.items()}
        else:
            self.neighboring_unsampled = {}
            self.subsampled_sample_names = {}
            self.subsampled_indices = {}
            self.n_samples_subsampled = {}

        n_samples = self.n_samples
        sample_names = self.sample_names
        coords = self.coords
        rng = np.random.default_rng(self.seed)

        # total-counts filtering (reference :2173)
        threshold_names = None
        if self.total_counts_threshold != 0.0:
            if self.total_counts_key not in self.adata.obs:
                raise KeyError(f"{self.total_counts_key} not found in .obs of AnnData.")
            tc = np.asarray(self.adata.obs[self.total_counts_key], float)
            hq = tc >= self.total_counts_threshold
            threshold_names = pd.Index(np.asarray(sample_names)[hq])
            if verbose:
                self.logger.info(
                    f"Subsetting to cells with >= {self.total_counts_threshold} total counts "
                    f"({int(hq.sum())}/{n_samples})."
                )
            if not self.spatial_subsample:
                for target in y_arr.columns:
                    if target in existing_targets:
                        continue
                    values = np.asarray(y_arr[target].values, float).reshape(-1, 1)
                    sampled_idx = np.flatnonzero(hq)
                    closest = self._closest_sampled_map(
                        coords, values, sampled_idx, sample_names
                    )
                    self.subsampled_indices[target] = sampled_idx.tolist()
                    self.n_samples_subsampled[target] = len(sampled_idx)
                    self.subsampled_sample_names[target] = list(map(str, np.asarray(sample_names)[sampled_idx]))
                    self.neighboring_unsampled[target] = closest

        if self.spatial_subsample:
            if verbose:
                self.logger.info("Performing stratified subsampling from different regions of the data...")
            from ...ops.kmeans import KMeans

            n_clust = max(int(0.05 * n_samples), 2)
            km = KMeans(n_clusters=n_clust, random_state=0, n_init=10, device=self.device).fit(coords)
            spatial_clusters = km.predict(coords).astype(int)

            for target in y_arr.columns:
                if target in existing_targets:
                    if verbose:
                        self.logger.info(f"Skipping already processed target: {target}")
                    continue
                values = np.asarray(y_arr[target].values, float)
                picked: List[int] = []
                for stratum in np.unique(spatial_clusters):
                    members = np.flatnonzero(spatial_clusters == stratum)
                    stratum_vals = values[members]
                    density = np.count_nonzero(stratum_vals) / max(len(stratum_vals), 1)
                    nz = members[stratum_vals != 0]
                    z = members[stratum_vals == 0]
                    n_nz = int(np.ceil((len(nz) // 2) * density))
                    n_z = max(n_nz, 3)
                    if len(z):
                        picked.extend(rng.choice(z, min(n_z, len(z)), replace=False).tolist())
                    if len(nz):
                        picked.extend(rng.choice(nz, min(max(n_nz, 1), len(nz)), replace=False).tolist())
                picked = sorted(set(picked))
                if threshold_names is not None:
                    tset = set(threshold_names)
                    picked = [i for i in picked if str(sample_names[i]) in tset]
                if not picked:
                    picked = list(range(min(n_samples, 10)))
                if verbose:
                    self.logger.info(f"For target {target} subsampled from {n_samples} to {len(picked)} cells.")
                closest = self._closest_sampled_map(coords, values.reshape(-1, 1), np.asarray(picked), sample_names)
                self.subsampled_indices[target] = picked
                self.n_samples_subsampled[target] = len(picked)
                self.subsampled_sample_names[target] = list(map(str, np.asarray(sample_names)[picked]))
                self.neighboring_unsampled[target] = closest

        with open(neighboring_unsampled_path, "w") as f:
            json.dump(self.neighboring_unsampled, f)
        with open(subsampled_names_path, "w") as f:
            json.dump(self.subsampled_sample_names, f)
        self.subsampled = True

    @staticmethod
    def _closest_sampled_map(coords, values, sampled_idx, sample_names) -> Dict[str, List[str]]:
        """Map each unsampled cell to the closest sampled cell whose
        zero/nonzero expression pattern matches (reference MuSIC.py:2367-2394
        mismatch-masked argmin)."""
        from scipy.spatial.distance import cdist

        ref = coords[sampled_idx]
        distances = cdist(coords.astype(float), ref.astype(float), "euclidean")
        all_expr = (np.asarray(values).ravel() != 0)
        sampled_expr = all_expr[sampled_idx]
        mismatch = all_expr[:, None] != sampled_expr[None, :]
        big = distances.max() + 1
        distances[mismatch] = big
        closest_indices = np.argmin(distances, axis=1)
        sampled_names = np.asarray(sample_names)[sampled_idx]
        sampled_set = set(map(str, sampled_names))
        closest: Dict[str, List[str]] = {}
        for i, idx in enumerate(closest_indices):
            key = str(sampled_names[idx])
            closest.setdefault(key, [])
            name_i = str(np.asarray(sample_names)[i])
            if name_i not in sampled_set:
                closest[key].append(name_i)
        return closest

    def map_new_cells(self):
        """Project an existing fit onto cells added to the AnnData after the
        model was fit (parity: reference MuSIC.py:2419): every cell absent
        from the fitted (subsampled) set is mapped to its closest fitted
        cell with a matching zero/nonzero expression pattern, and the
        subsampling JSON checkpoints are extended in place."""
        parent_dir = os.path.dirname(self.output_path) or "."
        Path(os.path.join(parent_dir, "subsampling")).mkdir(parents=True, exist_ok=True)
        _, filename = os.path.split(self.output_path)
        filename = os.path.splitext(filename)[0]
        neighboring_unsampled_path = os.path.join(parent_dir, "subsampling", f"{filename}.json")
        subsampled_names_path = os.path.join(parent_dir, "subsampling", f"{filename}_cell_names.json")

        if os.path.exists(neighboring_unsampled_path):
            with open(neighboring_unsampled_path) as f:
                self.neighboring_unsampled = json.load(f)
            with open(subsampled_names_path) as f:
                self.subsampled_sample_names = json.load(f)
        else:
            # no checkpoint on disk: keep any in-memory subsampling state
            # (the initial fit's), else the fitted set is all cells
            self.neighboring_unsampled = getattr(self, "neighboring_unsampled", None) or {}
            self.subsampled_sample_names = getattr(self, "subsampled_sample_names", None) or {}

        y_arr = self.targets_expr if hasattr(self, "targets_expr") else self.target
        for target in y_arr.columns:
            fitted_names = self.subsampled_sample_names.get(target)
            if fitted_names is None:
                fitted_names = [str(n) for n in getattr(self, "fitted_sample_names", self.sample_names)]
            fitted_set = set(map(str, fitted_names))
            sampled_idx = np.asarray([i for i, n in enumerate(self.sample_names) if str(n) in fitted_set], int)
            if len(sampled_idx) == 0 or len(sampled_idx) == self.n_samples:
                continue
            closest = self._closest_sampled_map(self.coords, y_arr[target].values, sampled_idx, self.sample_names)
            merged = self.neighboring_unsampled.get(target, {})
            for k, v in closest.items():
                merged.setdefault(k, [])
                merged[k] = sorted(set(merged[k]) | set(v))
            self.neighboring_unsampled[target] = merged
            self.subsampled_sample_names[target] = sorted(fitted_set)

        with open(neighboring_unsampled_path, "w") as f:
            json.dump(self.neighboring_unsampled, f)
        with open(subsampled_names_path, "w") as f:
            json.dump(self.subsampled_sample_names, f)
        self.logger.info("map_new_cells: neighbor mapping extended for all targets.")

    def setup_downstream(self, adata=None):
        """Set up the downstream (signaling-associated differential
        expression) model (parity: reference MuSIC.py:654): load the L:R,
        receptor-TF, TF-TF, cofactor and GRN databases for the species and
        select the measured, expression-thresholded transcription factors
        that will act as regulators."""
        if adata is not None:
            self.adata = adata
        self._load_db()
        from scipy.sparse import issparse

        names = list(map(str, self.adata.var_names))
        X = self.adata.X.toarray() if issparse(self.adata.X) else np.asarray(self.adata.X, dtype=float)
        tf_pool = set()
        if getattr(self, "r_tf_db", None) is not None:
            tf_pool |= set(map(str, self.r_tf_db["tf"]))
        if getattr(self, "tf_target_db", None) is not None:
            tf_pool |= set(map(str, self.tf_target_db["TF"]))
        tfs = [t for t in sorted(tf_pool) if t in names]
        if tfs:
            pct = (pd.DataFrame(X, columns=names)[tfs] > 0).mean(axis=0)
            thr = getattr(self, "target_expr_threshold", 0.05)
            tfs = [t for t in tfs if pct[t] > thr]
        self.tfs_for_downstream = tfs
        self.logger.info(f"setup_downstream: {len(tfs)} measured TFs retained as regulators.")
        return tfs

    def local_fit(
        self,
        i: int,
        y: np.ndarray,
        X: np.ndarray,
        bw,
        y_label: str = "target",
        coords: Optional[np.ndarray] = None,
        mask_indices: Optional[np.ndarray] = None,
        feature_mask: Optional[np.ndarray] = None,
        final: bool = False,
        fit_predictor: bool = False,
    ):
        """Local weighted fit for ONE sample (parity: reference
        MuSIC.py:2665) — the per-cell entry under `mpi_fit`'s batched
        fan-out, running the same conditioned-weights + IWLS kernels with a
        single-query chunk. Returns the beta row when `final`, else
        ``[i, diagnostic, hat_i, *inv_diag]`` like the reference's
        bandwidth-selection output."""
        y = np.asarray(y, float).ravel()
        X = np.asarray(X, float)
        chunk = np.asarray([int(i)], int)
        distr = "gaussian" if (self.distr == "gaussian" or fit_predictor) else self.distr
        W = self._masked_weights(y, bw, chunk, mask_indices)
        Xfit = X if feature_mask is None else X * np.asarray(feature_mask, float)[None, :]
        clip = float(self.clip) if np.isscalar(self.clip) else 5.0
        betas, hats, inv_diag, preds = iwls_batch_full(
            y, Xfit, W, focal=chunk, distr=distr, ridge_lambda=self.ridge_lambda, clip=clip
        )
        if final:
            return betas[0]
        diagnostic = float(y[int(i)] - preds[0]) if distr == "gaussian" else float(preds[0])
        return [float(i), diagnostic, float(hats[0])] + list(np.asarray(inv_diag[0]).ravel())

    # -- bandwidth ----------------------------------------------------------
    def _set_search_range(self):
        """Bandwidth search range (parity: reference MuSIC.py:2530)."""
        if self.minbw is None or self.maxbw is None:
            if self.bw_fixed:
                if self.distance_membrane_bound is not None and self.distance_secreted is not None:
                    minbw = self.distance_membrane_bound * (1.5 if self.kernel != "uniform" else 1.0)
                    maxbw = self.distance_secreted * (1.5 if self.kernel != "uniform" else 1.0)
                else:
                    from scipy.spatial import cKDTree

                    tree = cKDTree(self.coords)
                    nn_d = tree.query(self.coords, k=2)[0][:, 1]
                    min_dist = float(np.min(nn_d[nn_d > 0])) if np.any(nn_d > 0) else 1.0
                    minbw, maxbw = min_dist, min_dist * 10
            else:
                maxbw = self.n_neighbors_secreted * (2 if self.kernel != "uniform" else 1)
                minbw = self.n_neighbors_membrane_bound
            if self.minbw is None:
                self.minbw = minbw
            if self.maxbw is None:
                self.maxbw = maxbw
        if self.minbw >= self.maxbw:
            raise ValueError("The minimum bandwidth must be less than the maximum bandwidth.")

    def find_optimal_bw(self, range_lowest: float, range_highest: float, function: Callable) -> Optional[float]:
        """Golden-section search minimizing the given score function
        (parity: reference MuSIC.py:2837, incl. patience / NaN handling and
        plateau detection)."""
        delta = 0.38197
        new_lb = range_lowest + delta * np.abs(range_highest - range_lowest)
        new_ub = range_highest - delta * np.abs(range_highest - range_lowest)
        optimum_bw = None
        difference = 1.0e9
        iterations = patience = nan_count = 0
        optimum_score_history: List[float] = []
        results_dict: Dict[float, float] = {}

        while (np.abs(difference) > self.tolerance and iterations < self.max_iter and patience < 3) or nan_count < 3:
            iterations += 1
            if not self.bw_fixed:
                new_lb = np.round(new_lb)
                new_ub = np.round(new_ub)
            if new_lb in results_dict:
                lb_score = results_dict[new_lb]
            else:
                lb_score = function(new_lb)
                results_dict[new_lb] = lb_score
            if new_ub in results_dict:
                ub_score = results_dict[new_ub]
            else:
                ub_score = function(new_ub)
                results_dict[new_ub] = ub_score

            if ub_score < lb_score or np.isnan(lb_score):
                optimum_score = ub_score
                optimum_bw = new_ub
                range_lowest = new_lb
                new_lb = new_ub
                new_ub = range_highest - delta * np.abs(range_highest - range_lowest)
            else:
                optimum_score = lb_score
                optimum_bw = new_lb
                range_highest = new_ub
                new_ub = new_lb
                new_lb = range_lowest + delta * np.abs(range_highest - range_lowest)
            difference = lb_score - ub_score
            optimum_score_history.append(optimum_score)
            most_optimum_score = np.min(optimum_score_history)
            if iterations >= 3:
                if optimum_score_history[-2] == most_optimum_score:
                    patience += 1
                elif np.isnan(lb_score) or np.isnan(ub_score):
                    nan_count += 1
                else:
                    nan_count = 0
                    patience = 0
                if np.abs(optimum_score_history[-2] - optimum_score_history[-1]) <= 0.01 * np.abs(
                    most_optimum_score
                ):
                    patience = 3
            if patience == 3:
                self.logger.info(f"Returning bandwidth {optimum_bw}")
                return optimum_bw
            if nan_count == 3:
                self.logger.info("Score is NaN for three bandwidth iterations- exiting optimization.")
                return None
        return optimum_bw

    # -- conditioned weights (the TPU-batched local_fit front half) ---------
    def _conditioned_weights(self, y: np.ndarray, bw: Union[float, int], chunk: np.ndarray) -> np.ndarray:
        """Spatial weights of each query cell in `chunk`, with the
        reference's hurdle-style conditioning (reference MuSIC.py:2724-2755):
        for niche models every query is compared against same-cell-type
        samples; for signaling models, queries whose target expression is
        zero are restricted to same-cell-type samples. With
        `use_expression_neighbors`, distances come from the binarized design
        ("signaling space") with a uniform kernel.

        Returns the [len(chunk), n_samples] float32 weights as a tensor on
        the model's device."""
        y = np.asarray(y, float).ravel()
        ct = getattr(self, "ct_vec", None)
        if ct is None:
            if self.group_key is not None and self.group_key in self.adata.obs:
                cell_types = pd.Series(np.asarray(self.adata.obs[self.group_key]).astype(str))
            else:
                cell_types = pd.Series(["NA"] * self.n_samples)
            cat_to_num = {k: v + 1 for v, k in enumerate(cell_types.unique())}
            ct = cell_types.map(cat_to_num).values.astype(np.int32)
            self.ct_vec = ct
        y_chunk_zero = y[chunk] == 0
        if self.mod_type == "niche" or hasattr(self, "target"):
            cond_ct = np.ones(len(chunk), bool)
        else:
            cond_ct = y_chunk_zero
        if self.no_hurdle:
            cond_ct = np.zeros(len(chunk), bool)

        if self.use_expression_neighbors and self.feature_distance is not None:
            space = np.asarray(self.feature_distance, np.float32)
            kernel_fn = "uniform"
        else:
            space = np.asarray(self.coords, np.float32)
            kernel_fn = self.kernel
        dev = self.device
        space_d = _to_device(space, dev)
        chunk_d = _to_device(np.asarray(chunk, np.int64), dev)
        ct_d = _to_device(np.asarray(ct, np.int32), dev)
        W = _conditioned_kernel_weights_batch(
            space_d[chunk_d],
            space_d,
            float(bw) if self.bw_fixed else int(bw),
            ct_d[chunk_d],
            ct_d,
            _to_device(np.asarray(cond_ct, bool), dev),
            function=kernel_fn,
            fixed=self.bw_fixed,
            exclude_self=self.exclude_self,
            normalize=bool(self.normalize),
            self_idx=chunk_d,
        )
        return W

    def _masked_weights(self, y: np.ndarray, bw, chunk: np.ndarray, mask_indices) -> torch.Tensor:
        """`_conditioned_weights` with the `mask_indices` columns set to 0 on
        the device (no host round trip of the [q, n] weights)."""
        W = self._conditioned_weights(y, bw, chunk)
        if mask_indices is not None and len(mask_indices):
            W[:, _to_device(np.asarray(mask_indices, np.int64), W.device)] = 0.0
        return W

    # -- fitting ------------------------------------------------------------
    def mpi_fit(
        self,
        y: np.ndarray,
        X: np.ndarray,
        X_labels: Optional[List[str]] = None,
        y_label: str = "target",
        bw: Union[float, int] = 10,
        coords: Optional[np.ndarray] = None,
        mask_indices: Optional[np.ndarray] = None,
        feature_mask: Optional[np.ndarray] = None,
        final: bool = True,
        fit_predictor: bool = False,
    ):
        """Local fits for every cell of `self.x_chunk` (name kept for parity
        with reference MuSIC.py:2940). On a single device the fan-out is the
        batched device kernel; with a multi-device mesh the query-cell axis
        shards over the 'data' mesh axis (the reference's vestigial-MPI
        design made real).

        When `final`, saves reference-format per-target results
        (index, residual/prediction, influence, b_*, se_*) and returns the
        coefficient array; otherwise returns the AICc for `bw`."""
        y = np.asarray(y, float).ravel()
        X = np.asarray(X, float)
        n_samples, n_features = X.shape
        X_labels = X_labels if X_labels is not None else list(self.feature_names)
        chunk = np.asarray(self.x_chunk, int)
        distr = "gaussian" if (self.distr == "gaussian" or fit_predictor) else self.distr

        # the JAX package pads the query count to 256-row buckets (repeats of
        # the first query, sliced off after the fit) so that every target
        # reuses one compiled program; kept, so that the blocks and their
        # shapes are the JAX package's
        chunk_p = self._padded_chunk(chunk)
        q_true = len(chunk)

        W = self._masked_weights(y, bw, chunk_p, mask_indices)
        Xfit = X
        if feature_mask is not None:
            Xfit = X * np.asarray(feature_mask, float)[None, :]
        clip = float(self.clip) if np.isscalar(self.clip) else 5.0
        betas, hats, inv_diag, preds = iwls_batch_full(
            y,
            Xfit,
            W,
            focal=chunk_p,
            distr=distr,
            ridge_lambda=self.ridge_lambda,
            clip=clip,
        )
        betas, hats, inv_diag, preds = betas[:q_true], hats[:q_true], inv_diag[:q_true], preds[:q_true]
        true = y[chunk]

        if final:
            q = len(chunk)
            if distr == "gaussian":
                residuals = true - preds
                ENP = float(np.sum(hats))
                RSS = float(np.sum(residuals**2))
                TSS = float(np.sum((true - true.mean()) ** 2))
                r_squared = 1 - RSS / max(TSS, 1e-12)
                sigma_squared = RSS / max(n_samples - ENP, 1e-12)
                se = np.sqrt(np.maximum(inv_diag * sigma_squared, 0.0))
                diag_col = residuals
                aicc = self.compute_aicc_linear(RSS, ENP, n_samples=n_samples)
                self.output_diagnostics(aicc, ENP, r_squared, None, y_label=y_label)
            else:
                pred_y = np.maximum(preds - 1, 0.0)  # pseudocount adjustment
                deviance = self.distr_obj.deviance(true.reshape(-1, 1), np.maximum(preds, 1e-8).reshape(-1, 1))
                ll = self.distr_obj.log_likelihood(true.reshape(-1, 1), np.maximum(preds, 1e-8).reshape(-1, 1))
                ENP = n_features + 1 if self.fit_intercept else n_features
                se = np.sqrt(np.maximum(inv_diag, 0.0))
                diag_col = pred_y
                aicc = self.compute_aicc_glm(float(ll), ENP, n_samples=n_samples)
                self.output_diagnostics(aicc, ENP, None, float(deviance), y_label=y_label)

            header = "index," + ("residual," if distr == "gaussian" else "prediction,") + "influence,"
            for x in X_labels:
                header += "b_" + str(x) + ","
            for x in X_labels:
                header += "se_" + str(x) + ","
            all_fit_outputs = np.concatenate(
                [chunk.reshape(-1, 1), np.asarray(diag_col).reshape(-1, 1), hats.reshape(-1, 1), betas, se], axis=1
            )
            self.save_results(all_fit_outputs, header, label=y_label)
            self._last_hats = hats
            self._last_se = se
            self._last_aicc = aicc
            return betas

        # bandwidth-selection scoring
        if distr == "gaussian":
            residuals = true - preds
            RSS = float(np.sum(residuals**2))
            trace_hat = float(np.sum(hats[~np.isnan(hats)]))
            aicc = self.compute_aicc_linear(RSS, trace_hat, n_samples=n_samples)
            return aicc
        mask = ~(np.isnan(hats) | np.isnan(preds))
        num_valid = len(mask)
        ll = self.distr_obj.log_likelihood(
            true[mask].reshape(-1, 1), np.maximum(preds[mask], 1e-8).reshape(-1, 1)
        )
        norm_ll = float(ll) / num_valid
        trace_hat = float(np.sum(hats[mask]))
        norm_trace_hat = trace_hat / num_valid
        return self.compute_aicc_glm(norm_ll, norm_trace_hat, n_samples=n_samples)

    #: Query rows of `mpi_fit` are padded to a multiple of this.
    QUERY_BUCKET = 256

    @classmethod
    def _padded_chunk(cls, chunk: np.ndarray) -> np.ndarray:
        """`chunk` padded with repeats of its first query to a multiple of
        `QUERY_BUCKET` rows."""
        q_true = len(chunk)
        q_pad = -(-q_true // cls.QUERY_BUCKET) * cls.QUERY_BUCKET
        return np.concatenate([chunk, np.full(q_pad - q_true, chunk[0], int)]) if q_pad > q_true else chunk

    def fit(
        self,
        y: Optional[pd.DataFrame] = None,
        X: Optional[np.ndarray] = None,
        multiscale: bool = False,
        fit_predictor: bool = False,
        verbose: bool = True,
    ):
        """Fit every target gene (parity: reference MuSIC.py:3183):
        per-target GRN/TF-based feature filtering, concurrence skip,
        correlation feature mask, per-target clip, per-target subsample
        chunks, bandwidth search, final fit + save."""
        if not self.set_up:
            self._set_up_model(verbose=verbose)
        y_arr = self.targets_expr if y is None else y
        X_orig = self.X if X is None else np.asarray(X, float)

        if self.group_key is not None and self.group_key in self.adata.obs:
            cell_types = pd.Series(np.asarray(self.adata.obs[self.group_key]).astype(str))
        else:
            cell_types = pd.Series(["NA"] * self.n_samples)
        cat_to_num = {k: v + 1 for v, k in enumerate(cell_types.unique())}
        self.ct_vec = cell_types.map(cat_to_num).values.astype(np.int32)

        self.coeffs: Dict[str, pd.DataFrame] = {}
        self.standard_errors: Dict[str, pd.DataFrame] = {}
        self.bws: Dict[str, float] = {}
        self.aiccs: Dict[str, float] = {}
        full_chunk = np.asarray(self.x_chunk, int)

        for target in y_arr.columns:
            y_t = np.asarray(y_arr[target].values, float).ravel()
            keep_indices, X_labels = self._filter_features_for_target(target, y_arr)
            if keep_indices is None:
                continue
            Xt = X_orig[:, keep_indices]

            # concurrence check (reference :3443)
            if self.mod_type in ("lr", "receptor", "ligand"):
                y_bin = (y_t != 0).astype(int)
                conc = ((Xt != 0).astype(int) * y_bin[:, None]).sum(axis=0) / max(y_bin.sum(), 1)
                if np.all(conc <= self.target_expr_threshold):
                    self.logger.info(
                        f"None of the interactions are present in more than "
                        f"{self.target_expr_threshold * 100}% of cells expressing {target}. Skipping."
                    )
                    continue

            # per-target subsample chunk + collinearity feature mask (:3460)
            if getattr(self, "subsampled", False) and target in getattr(self, "subsampled_indices", {}):
                self.x_chunk = np.asarray(self.subsampled_indices[target], int)
                feature_mask = self._correlation_feature_mask(Xt, y_t)
            else:
                self.x_chunk = full_chunk
                feature_mask = None

            # coefficient bounds from y (reference :3500)
            if self.distr != "gaussian":
                lim = np.log(np.abs(y_t + 1e-6))
                self.clip = float(np.percentile(lim, 99.7))
            else:
                self.clip = float(np.percentile(y_t, 99.7))
            if not np.isfinite(self.clip) or self.clip <= 0:
                self.clip = 5.0

            if self.bw is not None:
                bw = self.bw
            else:
                self._set_search_range()
                if verbose:
                    self.logger.info(f"Target {target}: bandwidth search range {self.minbw}-{self.maxbw}.")
                fit_function = lambda b: self.mpi_fit(
                    y_t, Xt, X_labels=X_labels, y_label=target, bw=b, feature_mask=feature_mask, final=False,
                    fit_predictor=fit_predictor,
                )
                bw = self.find_optimal_bw(self.minbw, self.maxbw, fit_function)
                if bw is None:
                    self.logger.info(f"Could not fit target {target}. Skipping.")
                    continue
                if self.bw_fixed:
                    bw = round(bw, 2)
            betas = self.mpi_fit(
                y_t, Xt, X_labels=X_labels, y_label=target, bw=bw, feature_mask=feature_mask, final=True,
                fit_predictor=fit_predictor,
            )
            idx_names = np.asarray(self.sample_names)[self.x_chunk]
            self.coeffs[target] = pd.DataFrame(betas, index=idx_names, columns=[f"b_{c}" for c in X_labels])
            self.standard_errors[target] = pd.DataFrame(
                self._last_se, index=idx_names, columns=[f"se_{c}" for c in X_labels]
            )
            self.bws[target] = bw
            self.aiccs[target] = self._last_aicc
            if verbose:
                self.logger.info(f"Fitted target {target}: bw={bw}, AICc={self.aiccs[target]:.2f}")
        self.x_chunk = full_chunk
        self._fitted = True
        return self

    def _filter_features_for_target(self, target: str, y_arr: pd.DataFrame):
        """GRN/TF-database feature filtering per target (parity: reference
        MuSIC.py:3256-3317). Degrades to all features when the GRN database
        is unavailable (the GRN csvs ship as LFS pointers)."""
        if self.mod_type in ("lr", "receptor", "ligand") and self.grn is not None and self.r_tf_db is not None:
            gene_query = target.split("_")[0] if "_" in target else target
            if gene_query not in self.grn.index:
                return list(range(len(self.feature_names))), list(self.feature_names)
            target_row = self.grn.loc[gene_query]
            target_TFs = target_row[target_row == 1].index.tolist()
            subset_idx = np.nonzero(np.asarray(y_arr[target].values))[0]
            names = list(map(str, self.adata.var_names))
            target_TF_sub = [tf for tf in target_TFs if tf in self.grn.index and tf in names]
            if target_TF_sub and len(subset_idx):
                Xa = self.adata.X
                cols = [names.index(tf) for tf in target_TF_sub]
                sub = Xa[subset_idx][:, cols]
                sub = sub.toarray() if issparse(sub) else np.asarray(sub)
                proportions = np.mean(sub > 0, axis=0)
                target_TF_sub = list(np.asarray(target_TF_sub)[proportions > self.target_expr_threshold])
            if target_TF_sub:
                primary_rows = self.grn.loc[target_TF_sub]
                secondary = primary_rows.columns[(primary_rows == 1).any()].tolist()
                target_TFs = list(set(target_TFs + secondary))
            if len(target_TFs) == 0:
                self.logger.info(f"No regulators associated with target {target}. Skipping.")
                return None, None
            temp = self.r_tf_db[self.r_tf_db["tf"].isin(target_TFs)]
            target_receptors = temp["receptor"].unique().tolist()
            lr_sub = self.lr_db[self.lr_db["to"].isin(target_receptors)]
            target_ligands = lr_sub["from"].unique().tolist()
            if self.mod_type in ("lr", "receptor"):
                molecules = target_receptors + target_ligands
            else:
                molecules = target_ligands
            keep = [i for i, feat in enumerate(self.feature_names) if any(m in feat for m in molecules) or feat == "intercept"]
            if len(keep) <= (1 if self.fit_intercept else 0):
                self.logger.info(f"No features kept for target {target}. Using all features.")
                return list(range(len(self.feature_names))), list(self.feature_names)
            self.logger.info(
                f"For target {target}, from {len(self.feature_names)} features, kept {len(keep)} to fit model."
            )
            return keep, [self.feature_names[i] for i in keep]
        return list(range(len(self.feature_names))), list(self.feature_names)

    @staticmethod
    def _correlation_feature_mask(X: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Global-correlation feature mask used with subsampling to avoid
        false-negative coefficients from collinearity (reference
        MuSIC.py:3466-3496)."""
        from scipy import stats as sps

        correlations = []
        for j in range(X.shape[1]):
            m = (X[:, j].ravel() != 0) & (y.ravel() != 0)
            xs, ys = X[m, j], y[m]
            if xs.size <= 1:
                correlations.append(0.0)
            else:
                try:
                    correlations.append(sps.pearsonr(xs, ys)[0])
                except Exception:
                    correlations.append(np.nan)
        correlations = np.nan_to_num(np.asarray(correlations))
        mask = np.where(np.abs(correlations) < 0.1, np.abs(correlations), 1.0)
        mask = np.where(correlations < -0.1, mask, 1.0)
        return mask

    # -- prediction ----------------------------------------------------------
    def predict(
        self,
        input: Optional[pd.DataFrame] = None,
        coeffs: Optional[Dict[str, pd.DataFrame]] = None,
        adjust_for_subsampling: bool = False,
    ) -> pd.DataFrame:
        """Predicted expression per target (parity: reference MuSIC.py:3570)."""
        input_df = self.X_df if input is None else input
        if not isinstance(input_df, pd.DataFrame):
            input_df = pd.DataFrame(np.asarray(input_df), columns=self.feature_names, index=self.sample_names)
        coeffs = coeffs if coeffs is not None else self.coeffs
        all_y_pred = {}
        for target, cdf in coeffs.items():
            sub = input_df.loc[cdf.index] if set(cdf.index) <= set(input_df.index) else input_df.iloc[: len(cdf)]
            feats = [c[2:] for c in cdf.columns if c.startswith("b_")]
            vals = np.zeros(len(cdf))
            for j, f in enumerate(feats):
                if f in sub.columns:
                    vals = vals + np.asarray(sub[f].values, float) * np.asarray(cdf.iloc[:, j].values, float)
                elif f == "intercept":
                    vals = vals + np.asarray(cdf.iloc[:, j].values, float)
            if self.distr != "gaussian":
                vals = self.distr_obj.predict(vals)
                vals = np.maximum(vals - 1, 0.0)
            all_y_pred[target] = pd.Series(vals, index=cdf.index)
        return pd.DataFrame(all_y_pred)

    def predict_and_save(self, input=None, coeffs=None, adjust_for_subsampling: bool = True):
        """Predict and persist (parity: reference MuSIC.py:3754)."""
        y_pred = self.predict(input, coeffs, adjust_for_subsampling=adjust_for_subsampling)
        parent_dir = os.path.dirname(self.output_path) or "."
        y_pred.to_csv(os.path.join(parent_dir, "predictions.csv"))
        return y_pred

    # -- diagnostics ---------------------------------------------------------
    def compute_aicc_linear(self, RSS: float, trace_hat: float, n_samples: Optional[int] = None) -> float:
        """AICc for the linear GWR model (parity: reference MuSIC.py:3644)."""
        n = self.n_samples if n_samples is None else n_samples
        denom = n - trace_hat - 2.0
        if denom <= 0:
            denom = 1e-6
        return float(n * np.log(max(RSS, 1e-12) / n) + n * np.log(2 * np.pi) + n * (n + trace_hat) / denom)

    def compute_aicc_glm(self, ll: float, trace_hat: float, n_samples: Optional[int] = None) -> float:
        """AICc for generalized linear GWR (parity: reference MuSIC.py:3659)."""
        n = self.n_samples if n_samples is None else n_samples
        n_eff = n - trace_hat
        return float(-2 * ll + 2 * self.n_features + (2 * self.n_features * (self.n_features + 1)) / max(n_eff - 1, 1e-6))

    def output_diagnostics(self, aicc=None, ENP=None, r_squared=None, deviance=None, y_label=None) -> None:
        """Log fit diagnostics (parity: reference MuSIC.py:3676)."""
        y_label = y_label or self.distr
        if aicc is not None:
            self.logger.info(f"Corrected Akaike information criterion for {y_label} model: {aicc}")
        if ENP is not None:
            self.logger.info(f"Effective number of parameters for {y_label} model: {ENP}")
        if self.distr == "gaussian" and r_squared is not None:
            self.logger.info(f"R-squared for {y_label} model: {r_squared}")
        elif deviance is not None:
            self.logger.info(f"Deviance for {y_label} model: {deviance}")

    # -- persistence ---------------------------------------------------------
    def save_results(self, data: np.ndarray, header: str, label: Optional[str]) -> None:
        """Save reference-format results CSV (parity: reference
        MuSIC.py:3709): `{output_stem}_{label}.csv` with columns
        index,residual|prediction,influence,b_*,se_*."""
        parent = os.path.dirname(self.output_path) or "."
        Path(parent).mkdir(parents=True, exist_ok=True)
        if label is not None:
            path = os.path.splitext(self.output_path)[0] + f"_{label}" + os.path.splitext(self.output_path)[1]
        else:
            path = self.output_path
        np.savetxt(path, data, delimiter=",", header=header[:-1], comments="")
        self.saved = True

    def return_outputs(
        self,
        adjust_for_subsampling: bool = True,
        load_for_interpreter: bool = False,
        load_from_downstream: Optional[str] = None,
    ) -> Tuple[Dict[str, pd.DataFrame], Dict[str, pd.DataFrame]]:
        """Load fitted coefficients + standard errors from the saved
        per-target CSVs, extending subsampled fits to their unsampled
        neighbors and masking non-expressing cells (parity: reference
        MuSIC.py:3775)."""
        parent_dir = os.path.dirname(self.output_path) or "."
        all_coeffs: Dict[str, pd.DataFrame] = {}
        all_se: Dict[str, pd.DataFrame] = {}
        stem = os.path.splitext(os.path.basename(self.output_path))[0]
        file_list = [f for f in os.listdir(parent_dir) if os.path.isfile(os.path.join(parent_dir, f))]
        for file in file_list:
            if "predictions" in file or not file.startswith(stem + "_") or not file.endswith(".csv"):
                continue
            target = file[len(stem) + 1 : -4]
            outputs = pd.read_csv(os.path.join(parent_dir, file))
            if "index" in outputs.columns:
                idx = outputs["index"].values
                names = [str(self.sample_names[int(i)]) for i in idx] if hasattr(self, "sample_names") else idx
                outputs.index = names
            betas = outputs[[c for c in outputs.columns if c.startswith("b_")]]
            ses = outputs[[c for c in outputs.columns if c.startswith("se_")]]
            if betas.shape[1] == 0 or (betas == 0).all().all():
                continue
            if adjust_for_subsampling and getattr(self, "neighboring_unsampled", None) and target in self.neighboring_unsampled:
                mapping = self.neighboring_unsampled[target]
                betas = betas.reindex(self.sample_names.astype(str), fill_value=0)
                ses = ses.reindex(self.sample_names.astype(str), fill_value=0)
                for sampled_name, unsampled in mapping.items():
                    for u in unsampled:
                        if sampled_name in betas.index:
                            betas.loc[u] = betas.loc[sampled_name]
                            ses.loc[u] = ses.loc[sampled_name]
            # mask cells not expressing the target / without the interaction
            if hasattr(self, "X_df") and target in set(map(str, self.adata.var_names)):
                names = list(map(str, self.adata.var_names))
                Xa = self.adata.X[:, names.index(target)]
                expr = (Xa.toarray() if issparse(Xa) else np.asarray(Xa)).ravel()
                expr_s = pd.Series(expr, index=self.sample_names.astype(str)).reindex(betas.index).fillna(0)
                zero = expr_s.values == 0
                betas.loc[zero] = 0
                ses.loc[zero] = 0
                for col in betas.columns:
                    feat = col[2:]
                    if "intercept" not in feat and feat in self.X_df.columns:
                        m = (
                            pd.Series(self.X_df[feat].values, index=self.sample_names.astype(str))
                            .reindex(betas.index)
                            .fillna(0)
                            .values
                            != 0
                        )
                        betas[col] = betas[col].values * m
                        ses["se_" + feat] = ses["se_" + feat].values * m
            all_coeffs[target] = betas
            all_se[target] = ses
        return all_coeffs, all_se

    def return_intercepts(self):
        """Final intercepts per target (parity: reference MuSIC.py:3952)."""
        if not self.fit_intercept:
            self.logger.info("No intercepts were fit, returning None.")
            return None
        coeffs, _ = self.return_outputs(adjust_for_subsampling=False)
        return {t: df["b_intercept"].values for t, df in coeffs.items() if "b_intercept" in df.columns}
