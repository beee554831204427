"""Interpretation of fitted MuSIC models (counterpart of
`spateo_tpu.tools.CCI_effects_modeling.MuSIC_downstream`; reference
spateo/tools/CCI_effects_modeling/MuSIC_downstream.py:67 — coefficient
significance :201, effect potential / sender-receiver vector field :5336,
top interacting pairs, CCI DEG detection :6607).

`MuSIC_Interpreter` subclasses the port's `MuSIC`, so it runs on the
model's ``device``. What runs there: the CCI DEG GLM
(`_fit_downstream_molecule`: the [n, n] `get_wi_batch_tensor` weights of the
neighbour space, built once per design and kept on the device across
`fit_all=True`'s molecules, and `iwls_batch_full`, which copies back only
the [n, k] results), the `permutation_test` refits (`mpi_fit`) and the
spatial weights of `_load_or_compute_weights` (`_compute_all_wi`). The rest
is the JAX package's host code (pandas, scipy sparse, the effect
potentials); matplotlib is imported only inside the plot methods
(`add_interaction_effect_to_adata(visualize=True)` draws through the port's
`plotting.space`).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
import torch

from ...logging import logger_manager as lm
from ..find_neighbors import get_wi_batch_tensor
from .MuSIC import MuSIC
from .regression_utils import assign_significance, iwls_batch_full, multitesting_correction, wald_test


class MuSIC_Interpreter(MuSIC):
    """Downstream analysis of a fitted MuSIC model (parity surface:
    MuSIC_downstream.py:67)."""

    def __init__(self, parser=None, args_list=None, keep_coeff_threshold_proportion_cells: float = 0, **kwargs):
        super().__init__(parser=parser, args_list=args_list, **kwargs)
        self.keep_column_threshold_proportion_cells = keep_coeff_threshold_proportion_cells
        # the reference init eagerly loads any fitted coefficients from the
        # output directory (MuSIC_downstream.py:186); keep that contract but
        # tolerate a not-yet-fitted model (lazy load on first use)
        try:
            if os.path.isdir(os.path.dirname(self.output_path) or "."):
                self.load_coeffs()
        except Exception:
            pass

    def _apply_keep_column_threshold(self) -> None:
        """Zero out coefficient columns nonzero in fewer than
        `keep_column_threshold_proportion_cells` x (cells expressing the
        target) cells — the reference's false-positive filter
        (MuSIC_downstream.py:187-196)."""
        prop = getattr(self, "keep_column_threshold_proportion_cells", 0) or 0
        if not prop or not getattr(self, "coeffs", None):
            return
        for target, df in self.coeffs.items():
            if hasattr(self, "targets_expr") and target in getattr(self, "targets_expr", pd.DataFrame()).columns:
                n_expressing = int((self.targets_expr[target] > 0).sum())
            else:
                n_expressing = len(df)
            threshold = int(prop * n_expressing)
            for col in df.columns:
                if int((df[col] != 0).sum()) < threshold:
                    df[col] = 0
                    if getattr(self, "standard_errors", None) and target in self.standard_errors:
                        se_col = col.replace("b_", "se_", 1)
                        if se_col in self.standard_errors[target].columns:
                            self.standard_errors[target][se_col] = 0

    # -- loading fitted results --------------------------------------------
    def load_coeffs(self, output_dir: Optional[str] = None) -> Dict[str, pd.DataFrame]:
        """Load fitted per-target coefficients. Understands both the
        reference-format files `{output_stem}_{target}.csv` written by
        `MuSIC.save_results` (reference MuSIC.py:3709 — columns
        index,residual|prediction,influence,b_*,se_*) and plain
        `{target}.csv` coefficient tables."""
        coeffs: Dict[str, pd.DataFrame] = {}
        parent_dir = os.path.dirname(self.output_path) or "."
        stem = os.path.splitext(os.path.basename(self.output_path))[0]
        if output_dir is None and os.path.isdir(parent_dir):
            for f in sorted(os.listdir(parent_dir)):
                if f.startswith(stem + "_") and f.endswith(".csv") and "predictions" not in f:
                    target = f[len(stem) + 1 : -4]
                    df = pd.read_csv(os.path.join(parent_dir, f))
                    b_cols = [c for c in df.columns if c.startswith("b_")]
                    if not b_cols:
                        continue
                    if "index" in df.columns and hasattr(self, "sample_names"):
                        df.index = [str(self.sample_names[int(i)]) for i in df["index"].values]
                    coeffs[target] = df[b_cols]
                    se_cols = [c for c in df.columns if c.startswith("se_")]
                    if se_cols:
                        if not hasattr(self, "standard_errors") or self.standard_errors is None:
                            self.standard_errors = {}
                        self.standard_errors[target] = df[se_cols]
        out_dir = output_dir or os.path.splitext(self.output_path)[0]
        if os.path.isdir(out_dir):
            for f in sorted(os.listdir(out_dir)):
                if f.endswith(".csv") and os.path.splitext(f)[0] not in coeffs:
                    df = pd.read_csv(os.path.join(out_dir, f), index_col=0)
                    b_cols = [c for c in df.columns if c.startswith("b_")]
                    if b_cols:
                        coeffs[os.path.splitext(f)[0]] = df[b_cols]
        self.coeffs = coeffs
        self._apply_keep_column_threshold()
        return coeffs

    # -- significance -------------------------------------------------------
    def compute_coeff_significance(self, method: str = "fdr_bh", significance_threshold: float = 0.05):
        """Per-cell coefficient significance (parity: reference
        MuSIC_downstream.py:201 `compute_coeff_significance`): Wald tests
        against the model's own per-cell standard errors (`se_*`, stored at
        fit time and re-loaded from the result CSVs), with zero-coefficient
        or zero-SE entries fixed at p=1 exactly as the reference's task
        filter does. Falls back to the cross-cell coefficient spread when
        no fitted SEs exist (e.g. coefficients injected directly)."""
        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        self.pvalues: Dict[str, pd.DataFrame] = {}
        self.qvalues: Dict[str, pd.DataFrame] = {}
        self.is_significant: Dict[str, pd.DataFrame] = {}
        ses = getattr(self, "standard_errors", None) or {}
        for target, cdf in self.coeffs.items():
            betas = cdf.values
            se_df = ses.get(target)
            if se_df is not None:
                # align se_X columns with b_X columns
                se_lookup = {c.replace("se_", "", 1): se_df[c].values for c in se_df.columns}
                se = np.column_stack([
                    se_lookup.get(c.replace("b_", "", 1), np.zeros(len(cdf))) for c in cdf.columns
                ])
                testable = (betas != 0) & (se != 0)
                pv = np.ones_like(betas, dtype=float)
                pv[testable] = wald_test(betas[testable], se[testable])
            else:
                sd = betas.std(axis=0, keepdims=True) + 1e-12
                pv = wald_test(betas, np.broadcast_to(sd, betas.shape))
            qv = np.stack([multitesting_correction(pv[:, j], method=method) for j in range(pv.shape[1])], axis=1)
            self.pvalues[target] = pd.DataFrame(pv, index=cdf.index, columns=cdf.columns)
            self.qvalues[target] = pd.DataFrame(qv, index=cdf.index, columns=cdf.columns)
            self.is_significant[target] = self.qvalues[target] < significance_threshold
        return self.is_significant

    # -- effect summaries ---------------------------------------------------
    def effect_distribution(self) -> pd.DataFrame:
        """Mean |effect| of each interaction feature on each target."""
        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        rows = {}
        for target, cdf in self.coeffs.items():
            rows[target] = cdf.abs().mean(axis=0)
        return pd.DataFrame(rows).T

    def top_interactions(self, n: int = 10) -> pd.DataFrame:
        """Strongest (feature, target) effects across the fitted models."""
        eff = self.effect_distribution()
        stacked = eff.stack().sort_values(ascending=False)
        out = stacked.head(n).reset_index()
        out.columns = ["target", "feature", "mean_abs_effect"]
        return out

    def get_effect_potential(
        self,
        target: Optional[str] = None,
        ligand: Optional[str] = None,
        receptor: Optional[str] = None,
        sender_cell_type: Optional[str] = None,
        receiver_cell_type: Optional[str] = None,
        spatial_weights_membrane_bound=None,
        spatial_weights_secreted=None,
        spatial_weights_niche=None,
        store_summed_potential: bool = True,
    ):
        """Sender->receiver signaling effect potential through the spatial
        weight matrices (parity: reference MuSIC_downstream.py:5336):

        - ligand/lr models: sent potential = W (secreted or membrane-bound,
          chosen from the L:R database `type` of the ligand) scaled rowwise
          by non-lagged ligand expression, columnwise by receptor expression
          (lr only), the per-receiver coefficient and the target-expression
          indicator;
        - niche models: W_niche scaled by sender-cell-type membership (and
          optionally receiver-cell-type membership) and the per-receiver
          coefficient.

        Returns (effect_potential [n, n] sparse,
        normalized_effect_potential_sum_sender [n],
        normalized_effect_potential_sum_receiver [n])."""
        import scipy.sparse

        if self.mod_type == "receptor":
            raise ValueError("Sent potential is not defined for receptor models.")
        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        if target is None:
            target = getattr(self, "target_for_downstream", None) or next(iter(self.coeffs))
        if ligand is None:
            ligand = getattr(self, "ligand_for_downstream", None)
            if ligand is None and self.mod_type in ("ligand", "lr"):
                raise ValueError("Must provide ligand for ligand models.")
        if receptor is None:
            receptor = getattr(self, "receptor_for_downstream", None)
            if receptor is None and self.mod_type == "lr":
                raise ValueError("Must provide receptor for lr models.")
        if sender_cell_type is None:
            sender_cell_type = getattr(self, "sender_ct_for_downstream", None)
            if sender_cell_type is None and self.mod_type == "niche":
                raise ValueError("Must provide sender cell type for niche models.")
        if receiver_cell_type is None:
            receiver_cell_type = getattr(self, "receiver_ct_for_downstream", None)

        n = self.adata.n_obs
        coeffs = self.coeffs[target].copy()
        coeffs[coeffs.abs() < 1e-2] = 0
        if hasattr(self, "targets_expr") and target in self.targets_expr.columns:
            target_expr = np.asarray(self.targets_expr[target].values).reshape(1, -1)
        else:
            from scipy.sparse import issparse as _iss

            names = list(map(str, self.adata.var_names))
            col = self.adata.X[:, names.index(target)] if target in names else np.ones((n, 1))
            target_expr = (col.toarray() if _iss(col) else np.asarray(col)).reshape(1, -1)
        target_indicator = np.where(target_expr != 0, 1, 0)

        def _coeff_column(label):
            col = label if label in coeffs.columns else f"b_{label}"
            if col not in coeffs.columns:
                raise KeyError(f"feature `{label}` not among fitted features: {list(coeffs.columns)}")
            vals = np.zeros(n)
            pos = {str(nm): k for k, nm in enumerate(self.adata.obs_names)}
            for ci, cell in enumerate(coeffs.index):
                k = pos.get(str(cell))
                if k is not None:
                    vals[k] = coeffs[col].values[ci]
            return vals.reshape(1, -1)

        if self.mod_type in ("ligand", "lr"):
            if spatial_weights_membrane_bound is None:
                spatial_weights_membrane_bound = self._load_or_compute_weights("membrane_bound")
            if spatial_weights_secreted is None:
                spatial_weights_secreted = self._load_or_compute_weights("secreted")
            # membrane-bound or secreted, per the database type of the ligand
            if not hasattr(self, "lr_db") or self.lr_db is None:
                self._load_db()
            matching = self.lr_db[self.lr_db["from"].isin(str(ligand).split("/"))]
            secreted = (
                matching["type"].str.contains("Secreted Signaling").any()
                or matching["type"].str.contains("ECM-Receptor").any()
            )
            W = spatial_weights_secreted if secreted else spatial_weights_membrane_bound
            W = scipy.sparse.csr_matrix(W)
            lig_parts = str(ligand).split("/")
            if hasattr(self, "ligands_expr_nonlag") and all(p in self.ligands_expr_nonlag.columns for p in lig_parts):
                lig_expr = self.ligands_expr_nonlag[lig_parts].mean(axis=1).values.reshape(-1, 1)
            else:
                from scipy.sparse import issparse as _iss

                names = list(map(str, self.adata.var_names))
                cols = [names.index(p) for p in lig_parts if p in names]
                sub = self.adata.X[:, cols] if cols else np.ones((n, 1))
                sub = sub.toarray() if _iss(sub) else np.asarray(sub)
                lig_expr = sub.mean(axis=1).reshape(-1, 1)
            sent_potential = W.multiply(lig_expr)
            if self.mod_type == "lr":
                if hasattr(self, "receptors_expr") and receptor in self.receptors_expr.columns:
                    rec_expr = self.receptors_expr[receptor].values.reshape(1, -1)
                else:
                    from scipy.sparse import issparse as _iss

                    names = list(map(str, self.adata.var_names))
                    parts = [p for p in str(receptor).split("_") if p in names]
                    if parts:
                        sub = self.adata.X[:, [names.index(p) for p in parts]]
                        sub = sub.toarray() if _iss(sub) else np.asarray(sub)
                        rec_expr = np.prod(sub, axis=1).reshape(1, -1) ** (1.0 / len(parts))
                    else:
                        rec_expr = np.ones((1, n))
                sent_potential = sent_potential.multiply(rec_expr)
            label = f"{ligand}" if self.mod_type == "ligand" else f"{ligand}:{receptor}"
            coeff = _coeff_column(label)
            effect_sign = np.where(coeff > 0, 1, -1)
            effect_potential = scipy.sparse.csr_matrix(sent_potential.multiply(coeff).multiply(target_indicator))
        elif self.mod_type == "niche":
            if spatial_weights_niche is None:
                spatial_weights_niche = self._load_or_compute_weights("niche")
            W = scipy.sparse.csr_matrix(spatial_weights_niche)
            if not hasattr(self, "cell_categories"):
                groups = pd.Series(np.asarray(self.adata.obs[self.group_key]).astype(str), index=self.adata.obs_names)
                self.cell_categories = pd.get_dummies(groups, dtype=float)
            sender_vec = self.cell_categories[sender_cell_type].values.reshape(-1, 1)
            sent_potential = W.multiply(sender_vec)
            if receiver_cell_type is not None:
                recv_vec = self.cell_categories[receiver_cell_type].values.reshape(1, -1)
                sent_potential = sent_potential.multiply(recv_vec)
            try:
                coeff = _coeff_column(f"Proxim{sender_cell_type}")
            except KeyError:
                coeff = _coeff_column(sender_cell_type)
            effect_sign = np.where(coeff > 0, 1, -1)
            effect_potential = scipy.sparse.csr_matrix(sent_potential.multiply(coeff).multiply(target_indicator))
        else:
            raise ValueError(f"Effect potential undefined for mod_type {self.mod_type}")

        def _norm_signed(v):
            sign = np.where(v > 0, 1, -1)
            a = np.abs(v)
            rng = a.max() - a.min()
            return ((a - a.min()) / max(rng, 1e-12)) * sign

        sum_sender = np.asarray(effect_potential.sum(axis=1)).reshape(-1)
        sum_receiver = np.asarray(effect_potential.sum(axis=0)).reshape(-1)
        norm_sender = _norm_signed(sum_sender)
        norm_receiver = _norm_signed(sum_receiver)

        if store_summed_potential:
            if self.mod_type == "niche":
                tag = f"{sender_cell_type}" + (f"_to_{receiver_cell_type}" if receiver_cell_type else "")
                self.adata.obs[f"norm_sum_sent_effect_potential_{tag}_for_{target}"] = norm_sender
                self.adata.obs[f"norm_sum_received_effect_potential_from_{tag}_for_{target}"] = norm_receiver
            elif self.mod_type == "ligand":
                lig_tag = replace_hla_with_hlas(replace_col_with_collagens(str(ligand))) if "/" in str(ligand) else ligand
                self.adata.obs[f"norm_sum_sent_effect_potential_{lig_tag}_for_{target}"] = norm_sender
                self.adata.obs[f"norm_sum_received_effect_potential_from_{lig_tag}_for_{target}"] = norm_receiver
            else:
                lig_tag = replace_hla_with_hlas(replace_col_with_collagens(str(ligand))) if "/" in str(ligand) else ligand
                self.adata.obs[
                    f"norm_sum_sent_effect_potential_{lig_tag}_for_{target}_via_{receptor}"
                ] = norm_sender
                self.adata.obs[
                    f"norm_sum_received_effect_potential_from_{lig_tag}_for_{target}_via_{receptor}"
                ] = norm_receiver
            self.adata.obs["effect_sign"] = effect_sign.reshape(-1)
        return effect_potential, norm_sender, norm_receiver

    def _load_or_compute_weights(self, which: str):
        """Load the saved spatial-weight matrix of the given signaling type,
        or recompute it with the model's bandwidth settings (reference
        MuSIC_downstream.py:5414-5436)."""
        import scipy.sparse as sp

        attr = f"spatial_weights_{which}"
        if getattr(self, attr, None) is not None:
            return getattr(self, attr)
        path = os.path.join(os.path.splitext(self.output_path)[0], "spatial_weights", f"spatial_weights_{which}.npz")
        if os.path.exists(path):
            W = sp.load_npz(path)
            if W.shape[0] == self.adata.n_obs:
                setattr(self, attr, W)
                return W
        if not hasattr(self, "coords"):
            self.coords = np.asarray(self.adata.obsm[self.coords_key], float)[:, :2]
            self.n_samples = self.adata.n_obs
        if which == "membrane_bound":
            W = self._compute_all_wi(self.n_neighbors_membrane_bound, bw_fixed=False, exclude_self=True)
        elif which == "secreted":
            W = self._compute_all_wi(self.n_neighbors_secreted, bw_fixed=False, exclude_self=True)
        else:
            W = self._compute_all_wi(self.n_neighbors_secreted, bw_fixed=False, exclude_self=True, kernel="uniform")
        setattr(self, attr, W)
        return W

    def sender_receiver_effect_deg_detection(
        self, target: str, significance_threshold: float = 0.05, n_top: int = 25
    ) -> pd.DataFrame:
        """Genes co-varying with the interaction effect on a target ("CCI
        DEGs"; parity surface: MuSIC_downstream.py:6607): correlation of each
        gene with the per-cell total predicted effect, BH-corrected."""
        from scipy.sparse import issparse
        from scipy.stats import norm as norm_dist

        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        cdf = self.coeffs[target]
        total_effect = cdf.abs().sum(axis=1).values
        adata = self.adata
        idx = [adata.obs_names.get_loc(i) for i in cdf.index if i in adata.obs_names]
        X = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X, dtype=float)
        X = X[idx]
        te = total_effect[: len(idx)]
        tez = (te - te.mean()) / max(te.std(), 1e-12)
        Xz = (X - X.mean(0)) / np.maximum(X.std(0), 1e-12)
        corr = (Xz * tez[:, None]).mean(axis=0)
        n = len(te)
        z = corr * np.sqrt(max(n - 3, 1))
        pv = 2 * norm_dist.sf(np.abs(z))
        qv = multitesting_correction(pv)
        out = pd.DataFrame({"correlation": corr, "pvalue": pv, "qvalue": qv}, index=adata.var_names)
        out = out[out["qvalue"] < significance_threshold].sort_values("correlation", ascending=False)
        return out.head(n_top)

    def permutation_test(
        self,
        target: str,
        n_permutations: int = 100,
        permute_nonzeros_only: bool = False,
        seed: int = 0,
        **kwargs,
    ) -> pd.DataFrame:
        """Permutation test for a target gene (reference semantics,
        MuSIC_downstream.py:7941): refit the spatial model against the
        nonpermuted expression and `n_permutations` scrambles of it
        (`permute_nonzeros_only` scrambles values only among the expressing
        cells, keeping the zero pattern fixed — the reference's
        expressing-subset mode). The observed and per-permutation
        predictions and truths are cached on
        `self._perm_predictions[target]` / `self._perm_truth[target]` for
        `eval_permutation_test`. Returns the per-feature effect-size null
        summary (mean |effect| + permutation p-value)."""
        if not hasattr(self, "X_df"):
            self._set_up_model()
        if not hasattr(self, "coords"):
            # interpreter constructed around an externally-fitted model
            self.coords = np.asarray(self.adata.obsm[self.coords_key], float)[:, :2]
            self.n_samples = self.adata.n_obs
        if not hasattr(self, "x_chunk"):
            self.x_chunk = np.arange(self.n_samples)
        rng = np.random.default_rng(seed)
        y = np.asarray(self.targets_expr[target].values, dtype=np.float32)
        X = np.asarray(self.X_df.values, dtype=np.float32)

        def permute(vec):
            if not permute_nonzeros_only:
                return rng.permutation(vec)
            out = vec.copy()
            nz = np.flatnonzero(vec != 0)
            out[nz] = vec[nz][rng.permutation(len(nz))]
            return out

        self.permuted_nonzeros_only = permute_nonzeros_only
        bw = self.bws.get(target) if getattr(self, "bws", None) else None
        if bw is None and getattr(self, "bw", None):
            bw = float(self.bw)
        if bw is None:
            self._set_search_range()
            bw = self.find_optimal_bw(
                self.minbw, self.maxbw, lambda b: self.mpi_fit(y, X, y_label=target, bw=b, final=False)
            )
        import tempfile

        def predict_from(betas):
            B = np.asarray(betas, float)
            if B.shape[1] == X.shape[1] + 1:
                vals = B[:, 0] + (B[:, 1:] * X[: len(B)]).sum(1)
            else:
                vals = (B * X[: len(B)]).sum(1)
            if self.distr != "gaussian":
                vals = np.asarray(self.distr_obj.predict(vals))
                vals = np.maximum(vals - 1, 0.0)
            return vals

        saved_out = self.output_path
        truth_cols, pred_cols = {}, {}
        with tempfile.TemporaryDirectory() as tmp:
            # permutation fits write throwaway CSVs
            self.output_path = os.path.join(tmp, "perm.csv")
            obs_betas = self.mpi_fit(y, X, y_label=target, bw=bw, final=True)
            obs_effect = np.abs(obs_betas).mean(axis=0)
            truth_cols["nonpermuted"] = y.astype(float)
            pred_cols["nonpermuted"] = predict_from(obs_betas)
            null = np.zeros((n_permutations, X.shape[1]), np.float32)
            for p in range(n_permutations):
                yp = permute(y)
                betas_p = self.mpi_fit(yp, X, y_label=target, bw=bw, final=True)
                null[p] = np.abs(betas_p).mean(axis=0)
                truth_cols[f"permutation_{p}"] = yp.astype(float)
                pred_cols[f"permutation_{p}"] = predict_from(betas_p)
            self.output_path = saved_out
        if not hasattr(self, "_perm_predictions"):
            self._perm_predictions, self._perm_truth = {}, {}
        idx = pd.Index(self.adata.obs_names[: len(y)])
        self._perm_predictions[target] = pd.DataFrame(pred_cols, index=idx)
        self._perm_truth[target] = pd.DataFrame(truth_cols, index=idx)
        pv = ((null >= obs_effect[None, :]).sum(axis=0) + 1) / (n_permutations + 1)
        names = getattr(self, "feature_names", None) or list(self.X_df.columns)
        return pd.DataFrame({"mean_abs_effect": obs_effect, "perm_pvalue": pv}, index=names)

    # ------------------------------------------------------------------
    # adata filtering / annotation (parity: MuSIC_downstream.py:316-470)
    # ------------------------------------------------------------------
    def filter_adata_spatial(self, instructions: List[str]):
        """Subset adata by spatial-coordinate predicates like
        "x < 500" / "y >= 100" (parity: MuSIC_downstream.py filter_adata_spatial)."""
        coords = np.asarray(self.adata.obsm[self.coords_key], float)
        mask = np.ones(len(coords), bool)
        axis_map = {"x": 0, "y": 1, "z": 2}
        import operator

        ops = {"<=": operator.le, ">=": operator.ge, "<": operator.lt, ">": operator.gt, "==": operator.eq}
        for ins in instructions:
            parts = ins.split()
            ax, op, val = parts[0], parts[1], float(parts[2])
            mask &= ops[op](coords[:, axis_map[ax]], val)
        self.adata = self.adata[np.flatnonzero(mask)]
        self.coords = np.asarray(self.adata.obsm[self.coords_key], float)[:, :2]
        self.n_samples = self.adata.n_obs
        return self.adata

    def filter_adata_custom(self, cell_ids: List[str]):
        """Subset adata to the given cell IDs (parity: filter_adata_custom)."""
        keep = [i for i, n in enumerate(self.adata.obs_names) if str(n) in set(map(str, cell_ids))]
        self.adata = self.adata[keep]
        self.coords = np.asarray(self.adata.obsm[self.coords_key], float)[:, :2]
        self.n_samples = self.adata.n_obs
        return self.adata

    def add_interaction_effect_to_adata(self, targets, interactions, visualize: bool = False):
        """Write per-cell predicted effects into .obs as
        f'{interaction}_effect_on_{target}' (parity: MuSIC_downstream.py:316)."""
        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        targets = [targets] if isinstance(targets, str) else list(targets)
        interactions = [interactions] if isinstance(interactions, str) else list(interactions)
        for t in targets:
            cdf = self.coeffs[t]
            for i in interactions:
                col = i if i in cdf.columns else f"b_{i}"
                if col not in cdf.columns:
                    lm.main_warning(f"interaction `{i}` not among the fitted features for `{t}`; skipping")
                    continue
                eff = np.zeros(self.adata.n_obs)
                pos = {str(n): k for k, n in enumerate(self.adata.obs_names)}
                vals = np.asarray(cdf[col].values, float)
                for ci, cell in enumerate(cdf.index):
                    k = pos.get(str(cell))
                    if k is not None:
                        eff[k] = vals[ci]
                # reference obs key + raw coefficient semantics
                # (MuSIC_downstream.py:316 adata.obs[f"{target}_{interaction}_effect"])
                self.adata.obs[f"{t}_{i}_effect"] = eff
                self.adata.obs[f"{i}_effect_on_{t}"] = eff  # legacy alias
                if visualize:
                    from ...plotting.space import space as _space

                    # reference clamps the color scale at the 99.7th
                    # percentile before rendering (:75 in the method body)
                    p997 = float(np.percentile(eff, 99.7))
                    plot_col = f"{t}_{i}_effect_plot"
                    self.adata.obs[plot_col] = np.minimum(eff, p997)
                    _space(self.adata, color=[plot_col], space=self.coords_key, save_show_or_return="return")
        return self.adata

    def compute_and_visualize_diagnostics(
        self, type: str = "correlations", n_genes_per_plot: int = 20, save_show_or_return: str = "return"
    ):
        """Diagnostics between observed and predicted expression per target
        (reference semantics, MuSIC_downstream.py:453). "correlations":
        Pearson + Spearman over all cells AND over the expressing subset,
        with the reference's largest-prediction-outlier removal; "rmse":
        RMSE over all cells + expressing subset; "confusion": per-gene 2x2
        confusion matrices of expressed/not-expressed, plotted
        `n_genes_per_plot` per figure with counts annotated.

        Returns the metric DataFrame (correlations keeps the pearson_r /
        rmse column names alongside the reference's four metrics;
        confusion returns {gene: 2x2 ndarray}). Figure modes ("show"/
        "axes") render the reference's per-metric barplots with dashed
        mean lines and mean legends."""
        from scipy.stats import pearsonr, spearmanr

        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        preds = None
        pred_path = os.path.join(os.path.dirname(self.output_path) or ".", "predictions.csv")
        if os.path.exists(pred_path):
            preds = pd.read_csv(pred_path, index_col=0)
        else:
            if not hasattr(self, "X_df"):
                self._set_up_model()
            preds = self.predict()
        all_genes = [g for g in preds.columns if g in set(map(str, self.adata.var_names))]
        from scipy.sparse import issparse

        def observed(gene):
            col = self.adata[:, gene].X
            return (col.toarray() if issparse(col) else np.asarray(col)).reshape(-1)

        if type == "confusion":
            cms = {}
            for gene in all_genes:
                y = observed(gene) > 0
                p = np.asarray(preds[gene].values, float) > 0
                n = min(len(y), len(p))
                y, p = y[:n], p[:n]
                cm = np.array([
                    [np.sum(~y & ~p), np.sum(~y & p)],
                    [np.sum(y & ~p), np.sum(y & p)],
                ])
                cms[gene] = cm
            if save_show_or_return in ("show", "save", "both", "all", "axes"):
                import matplotlib.pyplot as plt

                figs = []
                for start in range(0, len(all_genes), n_genes_per_plot):
                    chunk = all_genes[start : start + n_genes_per_plot]
                    fig, axs = plt.subplots(1, len(chunk), figsize=(2.2 * len(chunk), 2.5), squeeze=False)
                    for ax, gene in zip(axs.ravel(), chunk):
                        ax.imshow(cms[gene], cmap="Blues")
                        for (i, j), v in np.ndenumerate(cms[gene]):
                            ax.text(j, i, str(int(v)), ha="center", va="center", fontsize=8)
                        ax.set_xticks([0, 1]); ax.set_xticklabels(["Pred \nnot expr", "Pred \nexpr"], fontsize=6)
                        ax.set_yticks([0, 1]); ax.set_yticklabels(["Actual \nnot expr", "Actual \nexpr"], fontsize=6)
                        ax.set_title(gene, fontsize=9)
                    figs.append(fig)
                self._last_diagnostic_figs = figs
            return cms

        rows = {}
        for i, gene in enumerate(all_genes):
            y = observed(gene)
            p = np.asarray(preds[gene].values, float)
            n = min(len(y), len(p))
            y, p = y[:n], p[:n]
            if type == "correlations":
                # reference outlier guard: drop the largest predicted value
                out = int(np.argmax(p)) if len(p) else 0
                yp, pp = np.delete(y, out), np.delete(p, out)
                nzi = yp != 0
                def _safe(f, a, b):
                    if len(a) < 2 or np.std(a) == 0 or np.std(b) == 0:
                        return 0.0
                    return float(f(a, b)[0])
                rows[gene] = {
                    "pearson_r": _safe(pearsonr, yp, pp),
                    "spearman_r": _safe(spearmanr, yp, pp),
                    "nz_pearson_r": _safe(pearsonr, yp[nzi], pp[nzi]),
                    "nz_spearman_r": _safe(spearmanr, yp[nzi], pp[nzi]),
                }
            elif type == "rmse":
                nzi = y != 0
                rows[gene] = {
                    "rmse": float(np.sqrt(((y - p) ** 2).mean())),
                    "nz_rmse": float(np.sqrt(((y[nzi] - p[nzi]) ** 2).mean())) if nzi.any() else 0.0,
                }
            else:
                raise ValueError(
                    f"Unrecognized input for type: {type}. Options: 'correlations', 'confusion', 'rmse'."
                )
        df = pd.DataFrame(rows).T
        if type == "rmse" and "rmse" in df.columns:
            df["pearson_r"] = np.nan  # keep a stable column set for callers
        if save_show_or_return in ("show", "save", "both", "all", "axes"):
            import matplotlib.pyplot as plt

            metric_cols = [c for c in df.columns if df[c].notna().any()]
            figs = []
            for c in metric_cols:
                fig, ax = plt.subplots(figsize=(max(3, 0.5 * len(df)), 4))
                ax.bar(range(len(df)), df[c].values, color="#FF7F00", edgecolor="black")
                mean_v = float(df[c].mean())
                ax.axhline(mean_v, color="black", linestyle="--", linewidth=2)
                ax.legend(
                    [plt.Line2D([0], [0], color="black", linewidth=2, linestyle="--")],
                    [f"Mean: {mean_v:.3f}"], loc="center left", bbox_to_anchor=(1, 0.5), fontsize=8,
                )
                ax.set_xticks(range(len(df)))
                ax.set_xticklabels(df.index, rotation=90)
                ax.set_title(c)
                figs.append((fig, ax))
            self._last_diagnostic_figs = figs
            if save_show_or_return == "axes":
                return figs, df
        return df

    # ------------------------------------------------------------------
    # 3D effect plots (parity: MuSIC_downstream.py:767-1281; pyvista ->
    # the framework's mplot3d renderer)
    # ------------------------------------------------------------------
    def _coords3d(self):
        c = np.asarray(self.adata.obsm[self.coords_key], float)
        if c.shape[1] == 2:
            c = np.concatenate([c, np.zeros((len(c), 1))], 1)
        return c[:, :3]

    def _effect_3d_scatter(self, plot_vals: np.ndarray, title: str, zero_opacity: float, size: float, save_path):
        """Compose the reference's effect-magnitude 3D figure
        (MuSIC_downstream.py:837-935): zeros split into their own black
        trace with `zero_opacity`, nonzeros colored on the "hot" scale with
        a labeled colorbar. Renders with mplot3d (pyvista/plotly absent
        from this image, PARITY.md); `save_path` writes a PNG."""
        import matplotlib.pyplot as plt

        coords = self._coords3d()
        is_zero = plot_vals == 0.0
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(projection="3d")
        nz = ~is_zero
        sc = ax.scatter(
            coords[nz, 0], coords[nz, 1], coords[nz, 2], c=plot_vals[nz], cmap="hot", s=size**2
        )
        if is_zero.any():
            ax.scatter(
                coords[is_zero, 0], coords[is_zero, 1], coords[is_zero, 2],
                c="#000000", s=size**2, alpha=zero_opacity,
            )
        cb = fig.colorbar(sc, ax=ax, shrink=0.6, pad=0.1)
        cb.set_label(title)
        ax.set_title(title)
        ax.set_axis_off()
        if save_path:
            fig.savefig(save_path if not str(save_path).endswith(".html") else str(save_path)[:-5] + ".png", dpi=150)
        return fig, ax

    @staticmethod
    def _clip_effect_values(vals: pd.Series, pcutoff: float, min_value: float) -> pd.Series:
        """Reference percentile clamp (:829-834): values above the `pcutoff`
        percentile (99.9 when pcutoff=0) snap to the cutoff; values below
        `min_value` snap to `min_value`."""
        cutoff = np.percentile(vals.values, pcutoff if pcutoff != 0 else 99.9)
        vals = vals.copy()
        vals[vals > cutoff] = cutoff
        vals[vals < min_value] = min_value
        return vals

    def plot_interaction_effect_3D(
        self,
        target: str,
        interaction: str,
        save_path: Optional[str] = None,
        pcutoff: Optional[float] = 99.7,
        min_value: Optional[float] = 0,
        zero_opacity: float = 1.0,
        size: float = 2.0,
        n_neighbors_smooth: Optional[int] = 0,
        **kwargs,
    ):
        """3D scatter colored by the per-cell effect of `interaction` on
        `target` (reference semantics, MuSIC_downstream.py:767): optional
        neighbor smoothing (mean over nonzero neighbor coefficients when at
        least 5 are nonzero, :810-827), percentile/minimum clamping, and a
        separate black trace for zero-effect cells."""
        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        if target not in self.coeffs:
            raise ValueError(f"Target {target} not found in this model's directory. Please provide a valid target.")
        if getattr(self, "X_df", None) is not None and interaction not in self.X_df.columns:
            raise ValueError(f"Interaction {interaction} not found in this model's directory.")
        cdf = self.coeffs[target]
        col = f"b_{interaction}" if f"b_{interaction}" in cdf.columns else interaction
        coef = cdf[col].reindex(pd.Index(self.adata.obs_names)).fillna(0.0)
        if n_neighbors_smooth:
            from scipy.spatial import cKDTree

            coords = self._coords3d()
            _, idx = cKDTree(coords).query(coords, k=min(n_neighbors_smooth + 1, len(coords)))
            vals = coef.values[idx[:, 1:]]
            nz_count = (vals != 0).sum(axis=1)
            with np.errstate(invalid="ignore"):
                means = np.where(nz_count > 0, vals.sum(axis=1) / np.maximum(nz_count, 1), 0.0)
            coef = pd.Series(np.where(nz_count >= 5, means, 0.0), index=coef.index)
        coef = self._clip_effect_values(coef, pcutoff, min_value)
        return self._effect_3d_scatter(
            coef.values, f"{interaction.title()} Effect on {target.title()}", zero_opacity, size, save_path
        )

    def plot_multiple_interaction_effects_3D(
        self, effects: List[str], save_path: Optional[str] = None, include_combos_of_two: bool = False, **kwargs
    ):
        """Categorical 3D view of which interaction-target effect dominates
        each cell (reference semantics, MuSIC_downstream.py:937). Effects
        are "interaction:target" strings (split on the LAST colon so L:R
        interaction names survive); a cell is "nonzero" for an effect when
        its coefficient is positive and "strong" when it reaches the mean
        positive coefficient (:970-975). Cells strong for 2+ effects fall
        into "Multiple interactions" (or the pair category with
        `include_combos_of_two`, :981-994). Returns (fig, ax, categories)."""
        import matplotlib.pyplot as plt

        from ...plotting.colorlabel import godsnot_102, vega_10

        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        obs = pd.Index(self.adata.obs_names)
        nonzero, strong = {}, {}
        for effect in effects:
            interaction, target = effect.rsplit(":", 1)
            if target not in self.coeffs:
                lm.main_info(f"{target} not found in this model's directory. Skipping this interaction-target pair.")
                continue
            cdf = self.coeffs[target]
            col = f"b_{interaction}" if f"b_{interaction}" in cdf.columns else interaction
            if col not in cdf.columns:
                lm.main_info(f"{interaction} not found for {target}. Skipping this interaction-target pair.")
                continue
            coef = cdf[col].reindex(obs).fillna(0.0).values
            pos = coef[coef > 0]
            mean_val = pos.mean() if pos.size else np.inf
            nonzero[effect] = coef > 0
            strong[effect] = coef >= mean_val
        kept = list(nonzero)
        cats = np.full(len(obs), "Other", dtype=object)
        for i in range(len(obs)):
            active = [e for e in kept if nonzero[e][i]]
            strong_active = [e for e in kept if strong[e][i]]
            if include_combos_of_two:
                if len(strong_active) >= 3:
                    cats[i] = "Multiple interactions"
                elif len(strong_active) == 2:
                    cats[i] = f"{strong_active[0]} and {strong_active[1]}"
                elif len(active) == 1:
                    cats[i] = active[0]
            else:
                if len(strong_active) >= 2:
                    cats[i] = "Multiple interactions"
                elif len(active) == 1:
                    cats[i] = active[0]
        categories = pd.Series(cats, index=obs, name="interaction_categories")
        self.adata.obs["interaction_categories"] = categories.values
        counts = categories.value_counts()
        palette = godsnot_102 if include_combos_of_two else vega_10
        color_mapping = dict(zip(counts.index, palette))
        color_mapping["Multiple interactions"] = "#71797E"
        color_mapping["Other"] = "#D3D3D3"
        coords = self._coords3d()
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(projection="3d")
        for group, color in color_mapping.items():
            mask = categories.values == group
            if not mask.any():
                continue
            s = 1.25 if group == "Other" else 2.0
            ax.scatter(coords[mask, 0], coords[mask, 1], coords[mask, 2], c=color, s=s**2, label=group)
        ax.legend(loc="upper right", fontsize=7)
        ax.set_title(
            "L:R Interaction Effect on Target (format Ligand:Receptor-Target)"
            if self.mod_type == "lr"
            else "Ligand Effect on Target (format Ligand-Target)"
        )
        ax.set_axis_off()
        if save_path:
            fig.savefig(save_path if not str(save_path).endswith(".html") else str(save_path)[:-5] + ".png", dpi=150)
        return fig, ax, categories

    def plot_tf_effect_3D(
        self,
        target: str,
        tf: str,
        save_path: Optional[str] = None,
        ligand_targets: bool = True,
        receptor_targets: bool = False,
        target_gene_targets: bool = False,
        pcutoff: float = 99.7,
        min_value: float = 0,
        zero_opacity: float = 1.0,
        size: float = 2.0,
        **kwargs,
    ):
        """TF-effect magnitude over the fitted downstream model (reference
        semantics, MuSIC_downstream.py:1086): the coefficient source is the
        downstream ligand/receptor/target-gene model from
        `CCI_deg_detection`, then the same clamp/zero-split composition as
        `plot_interaction_effect_3D`."""
        if ligand_targets:
            attr = "ligand"
        elif receptor_targets:
            attr = "receptor"
        elif target_gene_targets:
            attr = "target"
        else:
            raise ValueError(
                "Please set either 'ligand_targets', 'receptor_targets', or 'target_gene_targets' to True."
            )
        store = getattr(self, f"downstream_model_{attr}_coeffs", None)
        if not store:
            raise ValueError(
                f"No fitted downstream {attr} model found. Run CCI_deg_detection_setup(...) and CCI_deg_detection()."
            )
        if target not in store:
            raise ValueError(f"Target {target} not found in this model's directory. Please provide a valid target.")
        cdf = store[target]
        if f"b_{tf}" not in cdf.columns:
            raise ValueError(f"TF {tf} not found in this model's directory.")
        coef = cdf[f"b_{tf}"].reindex(pd.Index(self.adata.obs_names)).fillna(0.0)
        coef = self._clip_effect_values(coef, pcutoff, min_value)
        return self._effect_3d_scatter(
            coef.values, f"{tf.title()} Effect on {target.title()}", zero_opacity, size, save_path
        )

    def visualize_overlap_between_interacting_components_3D(
        self, target: str, interaction: str, save_path: Optional[str] = None, size: float = 2.0, **kwargs
    ):
        """Categorical 3D view of the overlap between the interaction
        feature and target expression (reference semantics,
        MuSIC_downstream.py:1281): interaction-active cells come from the
        DESIGN MATRIX (nonzero X_df feature — i.e. neighborhood ligand [+
        receptor] signal, :1319-1322), not raw ligand expression; category
        labels follow the reference's mod_type-specific wording. Returns
        (fig, ax, categories)."""
        import matplotlib.pyplot as plt
        from scipy.sparse import issparse

        from ...plotting.colorlabel import godsnot_102

        if getattr(self, "X_df", None) is None or interaction not in self.X_df.columns:
            raise ValueError(f"Interaction {interaction} not found in this model's directory.")
        names = list(map(str, self.adata.var_names))
        if target not in names:
            raise ValueError(f"Target {target} not found in this model's directory. Please provide a valid target.")
        obs = pd.Index(self.adata.obs_names)
        col = self.adata[:, target].X
        target_expressing = obs[(col.toarray() if issparse(col) else np.asarray(col)).reshape(-1) != 0]
        interaction_expressing = self.X_df.index[np.asarray(self.X_df[interaction].values, float) != 0]
        overlap = target_expressing.intersection(interaction_expressing)
        cats = pd.Series("Other", index=obs, name=f"{interaction}_{target}")
        cats.loc[target_expressing] = f"{target} only (no {interaction} in neighborhood and/or receptor)"
        if self.mod_type == "lr":
            ligand, receptor = interaction.split(":", 1)
            cats.loc[interaction_expressing] = f"{ligand.title()} in Neighborhood and {receptor}, no {target}"
            cats.loc[overlap] = f"{ligand.title()} in Neighborhood, {receptor} and {target}"
        else:
            cats.loc[interaction_expressing] = f"{interaction.title()} in Neighborhood and Receptor, no {target}"
            cats.loc[overlap] = f"{interaction.title()} in Neighborhood, Receptor and {target}"
        self.adata.obs[f"{interaction}_{target}"] = cats.values
        palette = list(godsnot_102)
        palette[1:4] = ["#B200ED", "#FFA500", "#1CE6FF"]
        color_mapping = dict(zip(cats.value_counts().index, palette))
        color_mapping["Other"] = "#D3D3D3"
        coords = self._coords3d()
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(projection="3d")
        for group, color in color_mapping.items():
            mask = cats.values == group
            if not mask.any():
                continue
            ms = size * 0.75 if group == "Other" else size
            alpha = 0.5 if group == "Other" else 1.0
            ax.scatter(coords[mask, 0], coords[mask, 1], coords[mask, 2], c=color, s=ms**2, alpha=alpha, label=group)
        ax.legend(loc="upper right", fontsize=6)
        ax.set_title(f"Distribution of interacting components:\n{interaction} and {target}")
        ax.set_axis_off()
        if save_path:
            fig.savefig(save_path if not str(save_path).endswith(".html") else str(save_path)[:-5] + ".png", dpi=150)
        return fig, ax, cats

    # ------------------------------------------------------------------
    # heatmaps / summaries (parity: MuSIC_downstream.py:1434-5330)
    # ------------------------------------------------------------------
    # -- positional distribution figures (reference MuSIC_downstream.py
    # :1434 gene_expression_heatmap, :1849 effect_distribution_heatmap,
    # :2339 effect_distribution_density — the composed z-score-along-axis
    # figures; CSV caching on disk becomes an in-memory cache on self) -----

    def _positional_axis(self, position_key: str = "spatial", coord_column=None, round_pos: bool = False):
        """(pos, x_label, save_id): integer positional coordinate per cell
        along one spatial axis plus the reference's axis labeling
        (MuSIC_downstream.py:1583-1648). `coord_column` may be a column
        index, a name ("x"/"y"/"z"), or a plane string "xy"/"yz"/"xz"/
        "-xy"/"-yz"/"-xz" — the latter project onto the plane diagonal via
        `create_new_coordinate` (reference :1584-1590). `round_pos` applies
        the reference's coordinate coarsening (:1996-2006: round to the
        nearest 10 below 1000, nearest 100 at or above)."""
        from ..utils import create_new_coordinate

        if coord_column is None:  # reference default: the first coordinate
            coord_column = 0
        x_label, save_id = "Relative position", str(position_key)
        if position_key in self.adata.obsm:
            if coord_column in ("xy", "yz", "xz", "-xy", "-yz", "-xz"):
                create_new_coordinate(self.adata, position_key, coord_column)
                pos = pd.Series(
                    np.asarray(self.adata.obs[f"{coord_column} Coordinate"], float), index=self.adata.obs_names
                )
                x_label = f"Relative position along custom {coord_column} axis"
                save_id = f"{coord_column}_axis"
            else:
                arr = np.asarray(self.adata.obsm[position_key])
                if arr.ndim == 2 and arr.shape[1] > 1:
                    col = {"x": 0, "y": 1, "z": 2}.get(coord_column, coord_column)
                    col = int(col)
                    arr = arr[:, col]
                    x_label = f"Relative position along {'XYZ'[col] if col < 3 else col}"
                    save_id = f"{'xyz'[col] if col < 3 else col}_axis"
                else:
                    arr = arr.ravel()
                pos = pd.Series(arr, index=self.adata.obs_names)
        else:
            pos = pd.Series(np.asarray(self.adata.obs[position_key]), index=self.adata.obs_names)
        if round_pos and np.issubdtype(pos.dtype, np.number):
            base = 10 if float(pos.max()) < 1000 else 100
            pos = (pos / base).round() * base
        if np.issubdtype(pos.dtype, np.floating):
            # integer binning regardless of float width (float32 coords are
            # what this framework itself writes into obsm)
            pos = pos.astype(np.int64)
        return pos, x_label, save_id

    @staticmethod
    def _positional_distribution(
        values: pd.DataFrame,
        pos: pd.Series,
        window_size: int = 3,
        top_n: int = 30,
        min_consecutive: int = 5,
        select_features: bool = True,
    ) -> pd.DataFrame:
        """Reference composition (MuSIC_downstream.py:1694-1740): per-feature
        fold change over its mean -> log1p -> z-score -> per-position mean ->
        centered rolling smooth -> keep features in the per-position top-N
        z-scores for >= `min_consecutive` consecutive positions. Returns the
        [features x positions] matrix with positions minmax-normalized."""
        if window_size % 2 == 0:
            raise ValueError("Window size must be an odd integer.")
        mean = values.mean(axis=0)
        fc = np.log1p(values / (mean + 1e-12))
        z = (fc - fc.mean(axis=0)) / (fc.std(axis=0) + 1e-12)
        z = z.copy()
        # align positions to the value rows by INDEX when the labels match
        # (coefficients may be fitted on a cell subset / different order);
        # positional assignment is only valid for an exact length match
        if isinstance(values.index, pd.Index) and values.index.isin(pos.index).all():
            z["pos"] = np.asarray(pos.loc[values.index])
        elif len(pos) == len(values):
            z["pos"] = np.asarray(pos)
        else:
            raise ValueError(
                f"positions ({len(pos)} cells) cannot be aligned to the value rows "
                f"({len(values)}): indices do not match and lengths differ"
            )
        by_pos = z.sort_values("pos").groupby("pos").mean()
        by_pos = by_pos.rolling(window_size, center=True, min_periods=1).mean()
        features = list(values.columns)
        if select_features and by_pos.shape[1] > 1:
            top_per_pos = by_pos.apply(lambda row: row.nlargest(min(top_n, len(row))).index.tolist(), axis=1)
            consecutive = {g: 0 for g in features}
            of_interest = set()
            for p in top_per_pos.index:
                tops = set(top_per_pos[p])
                for g in features:
                    if g in tops:
                        consecutive[g] += 1
                        if consecutive[g] >= min_consecutive:
                            of_interest.add(g)
                    else:
                        consecutive[g] = 0
            if of_interest:
                by_pos = by_pos[[g for g in features if g in of_interest]]
        idx = by_pos.index.to_numpy(dtype=float)
        if idx.max() > idx.min():
            by_pos.index = (idx - idx.min()) / (idx.max() - idx.min())
        return by_pos.T  # features on rows (y-axis), positions on columns

    @staticmethod
    def _neatly_arrange_rows(to_plot: pd.DataFrame) -> pd.DataFrame:
        """Order rows by where along the axis their strongest (above
        per-row 95th-percentile) z-scores sit (reference :1742-1757)."""
        column_indices = np.tile(np.arange(to_plot.shape[1]), (len(to_plot), 1))
        p95 = to_plot.apply(lambda r: np.percentile(r[r > 0], 95) if (r > 0).any() else 0.0, axis=1)
        weights = to_plot.gt(p95, axis=0) * to_plot
        total = weights.values.sum(axis=1)
        weighted_avg = np.where(total != 0, (weights.values * column_indices).sum(axis=1) / total, 0.0)
        order = pd.Series(weighted_avg, index=to_plot.index).sort_values().index
        return to_plot.loc[order]

    def _plot_positional_heatmap(
        self,
        to_plot: pd.DataFrame,
        cmap: str,
        title: str,
        x_label: str,
        y_label: str = "Gene",
        fontsize: Optional[float] = None,
        figsize=None,
    ):
        """Compose the reference's positional heatmap figure
        (MuSIC_downstream.py:1758-1817): symmetric limits at the flattened
        95th percentile, Z-score colorbar with capped aspect, scaled
        label/tick fonts."""
        import matplotlib as mpl
        import matplotlib.pyplot as plt

        fontsize = fontsize or float(mpl.rcParams.get("font.size", 10))
        flat = to_plot.values.ravel()
        max_val = float(np.quantile(flat, 0.95)) if flat.size else 1.0
        figsize = figsize or (8, max(2.0, len(to_plot) * 0.2))
        fig, ax = plt.subplots(figsize=figsize)
        im = ax.imshow(to_plot.values, aspect="auto", cmap=cmap, vmin=-max_val, vmax=max_val)
        ax.set_xticks(np.linspace(0, to_plot.shape[1] - 1, min(6, to_plot.shape[1])))
        ax.set_xticklabels([f"{float(to_plot.columns[int(i)]):.3f}" for i in ax.get_xticks()], fontsize=fontsize)
        ax.set_yticks(range(len(to_plot)))
        ax.set_yticklabels(to_plot.index, fontsize=fontsize)
        ax.set_xlabel(x_label, fontsize=fontsize * 1.25)
        ax.set_ylabel(y_label, fontsize=fontsize * 1.25)
        ax.set_title(title, fontsize=fontsize * 1.5, pad=20)
        cb = fig.colorbar(im, ax=ax, shrink=0.7)
        cb.set_label("Z-score", fontsize=fontsize * 1.5, labelpad=10)
        cb.ax.tick_params(labelsize=fontsize * 1.25)
        cb.ax.set_aspect(min(len(to_plot), 70))
        return fig, ax

    def _analyses_folder(self) -> str:
        folder = os.path.join(os.path.dirname(self.output_path) or ".", "analyses")
        os.makedirs(folder, exist_ok=True)
        return folder

    @property
    def _adata_id(self) -> str:
        return os.path.splitext(os.path.basename(getattr(self, "adata_path", None) or "adata"))[0]

    def gene_expression_heatmap(
        self,
        use_ligands: bool = False,
        use_receptors: bool = False,
        use_target_genes: bool = False,
        genes: Optional[List[str]] = None,
        position_key: str = "spatial",
        coord_column=None,
        window_size: int = 3,
        recompute: bool = False,
        neatly_arrange_y: bool = True,
        cmap: str = "magma",
        title: Optional[str] = None,
        fontsize: Optional[int] = None,
        figsize=None,
        save_show_or_return: str = "return",
        save_kwargs: Optional[dict] = None,
        **kwargs,
    ):
        """Smoothed z-scored expression distribution of genes along a spatial
        axis (reference semantics, MuSIC_downstream.py:1434 — fold change ->
        log1p -> z-score -> positional mean -> rolling smooth ->
        consecutive-top-N gene selection -> optional enrichment-position row
        ordering). `use_ligands`/`use_receptors`/`use_target_genes` read the
        model's saved design-matrix component CSVs (ligands_expr.csv /
        receptors_expr.csv / targets.csv, :1511-1568); otherwise `genes`
        must be given. The positional matrix is cached in the reference's
        `analyses/{adata_id}_distribution_{file_id}_along_{save_id}.csv`
        and reused unless `recompute`; with a cache hit, `genes` subsets the
        cached rows (:1682-1693)."""
        from scipy.sparse import issparse

        if window_size % 2 == 0:
            raise ValueError("Window size must be an odd integer.")
        if not use_ligands and not use_receptors and not use_target_genes and genes is None:
            raise ValueError(
                "Please set either 'use_ligands', 'use_receptors', or 'use_target_genes' to True, or provide a list "
                "of genes to visualize."
            )
        custom_genes = genes
        dm_dir = os.path.join(os.path.splitext(self.output_path)[0], "design_matrix")
        if use_ligands or use_receptors or use_target_genes:
            fname, file_id = (
                ("ligands_expr.csv", "ligand_expression")
                if use_ligands
                else ("receptors_expr.csv", "receptor_expression")
                if use_receptors
                else ("targets.csv", "target_gene_expression")
            )
            path = os.path.join(dm_dir, fname)
            if not os.path.exists(path):
                raise FileNotFoundError(f"{fname} not found in this model's directory.")
            expr_df = pd.read_csv(path, index_col=0)
            genes = list(expr_df.columns)
        else:
            names = list(map(str, self.adata.var_names))
            genes = [g for g in genes if g in names]
            X = self.adata.X.toarray() if issparse(self.adata.X) else np.asarray(self.adata.X)
            expr_df = pd.DataFrame(X[:, [names.index(g) for g in genes]], index=self.adata.obs_names, columns=genes)
            file_id = "expression"
        pos, x_label, save_id = self._positional_axis(position_key, coord_column)
        cache_path = os.path.join(
            self._analyses_folder(), f"{self._adata_id}_distribution_{file_id}_along_{save_id}.csv"
        )
        if os.path.exists(cache_path) and not recompute:
            to_plot = pd.read_csv(cache_path, index_col=0)
            if custom_genes is not None:
                to_plot = to_plot.loc[[g for g in custom_genes if g in to_plot.index]]
        else:
            to_plot = self._positional_distribution(expr_df, pos, window_size=window_size)
            to_plot.to_csv(cache_path)
        if neatly_arrange_y:
            to_plot = self._neatly_arrange_rows(to_plot)
        if not hasattr(self, "_positional_dfs"):
            self._positional_dfs = {}
        self._positional_dfs[("genes", position_key, coord_column)] = to_plot
        if save_show_or_return == "return":
            return to_plot
        fig, ax = self._plot_positional_heatmap(
            to_plot,
            cmap,
            title or f"Gene expression distribution along axis given by {position_key} key",
            x_label,
            fontsize=fontsize,
            figsize=figsize,
        )
        if save_show_or_return in ("axes", "all"):
            return fig, ax, to_plot
        return ax

    def effect_distribution_heatmap(
        self,
        targets=None,
        interactions=None,
        position_key: str = "spatial",
        coord_column=None,
        effect_threshold: Optional[float] = None,
        check_downstream_ligand_effects: bool = False,
        check_downstream_receptor_effects: bool = False,
        check_downstream_target_effects: bool = False,
        use_significant: bool = False,
        sort_by_target: bool = False,
        neatly_arrange_y: bool = True,
        window_size: int = 3,
        recompute: bool = False,
        cmap: str = "magma",
        title: Optional[str] = None,
        fontsize: Optional[int] = None,
        figsize=None,
        save_show_or_return: str = "return",
        save_kwargs: Optional[dict] = None,
        target_subset=None,
        interaction_subset=None,
        **kwargs,
    ):
        """Smoothed z-scored per-cell interaction-effect distribution along a
        spatial axis, one row per target-interaction pair (reference
        semantics, MuSIC_downstream.py:1849; same composition as
        `gene_expression_heatmap` applied to the fitted coefficients).
        `check_downstream_{ligand,receptor,target}_effects` switch the
        source to the fitted downstream TF models (:2082-2093);
        `use_significant` masks coefficients by `compute_coeff_significance`
        (:2151-2157); `effect_threshold` clips coefficients from below
        (:2159-2161); rows with an effect in <0.5% of cells are dropped
        (:2168-2173); `sort_by_target` orders rows by target identity,
        otherwise `neatly_arrange_y` orders by enrichment position, and with
        both off rows sort by interaction identity (:2224-2251). The
        positional matrix is cached to the reference's analyses CSV unless
        `recompute`, and on self for `effect_distribution_density`."""
        if window_size % 2 == 0:
            raise ValueError("Window size must be an odd integer.")
        targets = targets if targets is not None else target_subset
        interactions = interactions if interactions is not None else interaction_subset
        if check_downstream_ligand_effects or check_downstream_receptor_effects or check_downstream_target_effects:
            attr = (
                "ligand"
                if check_downstream_ligand_effects
                else "receptor"
                if check_downstream_receptor_effects
                else "target"
            )
            all_coeffs = getattr(self, f"downstream_model_{attr}_coeffs", None)
            if not all_coeffs:
                raise ValueError(f"No downstream model results found for {attr}s.")
            file_id = f"downstream_{attr}_effects"
        else:
            if not getattr(self, "coeffs", None):
                self.load_coeffs()
            all_coeffs = self.coeffs
            file_id = "interaction_effects"
        if use_significant and not getattr(self, "is_significant", None):
            self.compute_coeff_significance()
        tlist = [t for t in (np.atleast_1d(targets) if targets is not None else list(all_coeffs)) if t in all_coeffs]
        cols = {}
        for t in tlist:
            cdf = all_coeffs[t]
            if use_significant and t in getattr(self, "is_significant", {}):
                cdf = cdf * self.is_significant[t].astype(float)
            if effect_threshold is not None:
                cdf = cdf.clip(lower=effect_threshold)
            for c in cdf.columns:
                if c.endswith("intercept"):
                    continue
                name = c[2:] if c.startswith("b_") else c
                if interactions is not None and name not in set(np.atleast_1d(interactions)):
                    continue
                vals = np.asarray(cdf[c].values, float)
                # the reference drops combinations present in <0.5% of cells
                if (vals != 0).mean() < 0.005:
                    continue
                cols[f"{t}-{name}"] = np.abs(vals)
        if not cols:
            raise ValueError("no target-interaction columns selected for effect_distribution_heatmap")
        base_index = all_coeffs[tlist[0]].index
        for t in tlist[1:]:
            if not all_coeffs[t].index.equals(base_index):
                raise ValueError(
                    f"coefficient tables are not row-aligned across targets "
                    f"('{tlist[0]}' vs '{t}'): fit them on the same cell set "
                    "or pass a single target"
                )
        values = pd.DataFrame(cols, index=base_index)
        pos, x_label, save_id = self._positional_axis(position_key, coord_column, round_pos=True)
        cache_path = os.path.join(
            self._analyses_folder(), f"{self._adata_id}_distribution_{file_id}_along_{save_id}.csv"
        )
        if os.path.exists(cache_path) and not recompute:
            to_plot = pd.read_csv(cache_path, index_col=0)
            if interactions is not None:
                keep = set(np.atleast_1d(interactions))
                to_plot = to_plot.loc[[i for i in to_plot.index if i.split("-", 1)[-1] in keep]]
            if targets is not None:
                keep = set(np.atleast_1d(targets))
                to_plot = to_plot.loc[[i for i in to_plot.index if i.split("-", 1)[0] in keep]]
        else:
            to_plot = self._positional_distribution(values, pos, window_size=window_size)
            to_plot.to_csv(cache_path)
        if sort_by_target:
            to_plot = to_plot.loc[sorted(to_plot.index, key=lambda x: x.split("-", 1)[0])]
        elif neatly_arrange_y:
            to_plot = self._neatly_arrange_rows(to_plot)
        else:
            to_plot = to_plot.loc[sorted(to_plot.index, key=lambda x: x.split("-", 1)[-1])]
        if not hasattr(self, "_positional_dfs"):
            self._positional_dfs = {}
        self._positional_dfs[("interaction_effects", position_key, 0 if coord_column is None else coord_column)] = to_plot
        if save_show_or_return == "return":
            return to_plot
        fig, ax = self._plot_positional_heatmap(
            to_plot,
            cmap,
            title or f"Signaling effect distribution along axis given by {position_key} key",
            x_label,
            y_label="Interaction Effect on Target (formatted target-interaction)",
            fontsize=fontsize,
            figsize=figsize,
        )
        if save_show_or_return in ("axes", "all"):
            return fig, ax, to_plot
        return ax

    def effect_distribution_density(
        self,
        effect_names=None,
        position_key: str = "spatial",
        coord_column=None,
        region_lower_bound: Optional[float] = None,
        region_upper_bound: Optional[float] = None,
        region_label: Optional[str] = None,
        save_show_or_return: str = "return",
        **kwargs,
    ):
        """Density of interaction effects ALONG the positional axis (parity:
        reference :2339 — reuses the matrix computed by
        `effect_distribution_heatmap`, which must run first; negative
        z-scores are clipped to zero and used as density weights)."""
        import matplotlib.pyplot as plt

        key = ("interaction_effects", position_key, 0 if coord_column is None else coord_column)
        cached = getattr(self, "_positional_dfs", {}).get(key)
        if cached is None:
            raise ValueError(
                "Could not find the positional-distribution matrix for this position key. "
                "Please run effect_distribution_heatmap() before effect_distribution_density()."
            )
        to_plot = cached.T.copy()  # positions x effects
        to_plot[to_plot < 0] = 0.0
        coords = to_plot.index.to_numpy(dtype=float)
        names = list(np.atleast_1d(effect_names)) if effect_names is not None else list(to_plot.columns)
        missing = [n for n in names if n not in to_plot.columns]
        if missing:
            raise ValueError(f"effect_names not present in the saved distribution: {missing}")
        fig, ax = plt.subplots(figsize=(7, 3))
        grid = np.linspace(coords.min(), coords.max(), 200)
        h = max((coords.max() - coords.min()) / 25.0, 1e-6)
        for n in names:
            w = np.asarray(to_plot[n].values, float)
            if w.sum() <= 0:
                continue
            dens = (np.exp(-((grid[:, None] - coords[None, :]) ** 2) / (2 * h**2)) * w[None, :]).sum(1)
            dens /= max(np.trapezoid(dens, grid), 1e-12)
            ax.plot(grid, dens, label=n)
            ax.fill_between(grid, dens, alpha=0.2)
        if region_lower_bound is not None and region_upper_bound is not None:
            ax.axvspan(region_lower_bound, region_upper_bound, color="gray", alpha=0.2, label=region_label)
        ax.set_xlabel("Relative position")
        ax.set_ylabel("Density")
        ax.legend(fontsize=6, frameon=False)
        return ax

    def visualize_effect_specificity(
        self,
        agg_method: str = "mean",
        plot_type: str = "heatmap",
        target_subset=None,
        interaction_subset=None,
        ct_subset=None,
        group_key: Optional[str] = None,
        n_anchors: Optional[int] = None,
        effect_threshold: Optional[float] = None,
        use_significant: bool = False,
        min_query_cells: int = 30,
        significance_cutoff: float = 1.3,
        fold_change_cutoff: float = 1.5,
        fold_change_cutoff_for_labels: float = 3.0,
        fontsize: Optional[int] = None,
        figsize=None,
        cmap: str = "seismic",
        save_show_or_return: str = "return",
        save_kwargs: Optional[dict] = None,
        save_df: bool = False,
        **kwargs,
    ):
        """Specificity of each interaction's effect on each target
        (reference semantics, MuSIC_downstream.py:2587): separate the
        target-expressing cells — conditioned on a strong predicted effect
        (above `effect_threshold`, default the 75th quantile of nonzero
        coefficients) and, for L:R models, on expression of every receptor
        component — plus their spatial-graph neighborhoods (secreted or
        membrane-bound graph chosen from the ligand's L:R-database `type`)
        from the remaining cells and their neighborhoods, then compute the
        log2 fold change of neighborhood ligand expression between the two
        groups. Multi-component ligands aggregate per the reference: "/"
        complexes by arithmetic mean, "_" complexes by geometric mean over
        nonzero entries. `agg_method` "mean" compares mean expression,
        "percentage" the expressing fraction.

        `plot_type="heatmap"` yields the targets x interactions ward-
        clustered fold-change matrix (volcano: one "{interaction}-{target}"
        row with Mann-Whitney q-values). `min_query_cells` is the
        reference's 30-cell floor, exposed so small datasets can lower it.
        Returns the DataFrame for "return"; "axes" composes the divergent
        masked heatmap / volcano figure and returns (fig, ax, df)."""
        import scipy.cluster.hierarchy as sch
        from scipy.sparse import issparse
        from scipy.stats import mannwhitneyu

        if self.mod_type not in ("lr", "ligand"):
            raise ValueError("This function is only applicable for ligand-based models.")
        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        logger = lm.get_main_logger()
        target_subset = list(self.coeffs) if target_subset is None else [t for t in np.atleast_1d(target_subset) if t in self.coeffs]
        all_features = [f for f in getattr(self, "feature_names", []) if f != "intercept"]
        feature_names = all_features if interaction_subset is None else [f for f in all_features if f in set(np.atleast_1d(interaction_subset))]
        group_key = group_key or self.group_key
        if use_significant and not getattr(self, "is_significant", None):
            self.compute_coeff_significance()

        conn_secreted, conn_membrane_bound = self._specificity_graphs()
        names = list(map(str, self.adata.var_names))
        Xmat = self.adata.X.toarray() if issparse(self.adata.X) else np.asarray(self.adata.X)
        obs_names = pd.Index(self.adata.obs_names)

        if plot_type == "heatmap":
            df = pd.DataFrame(0.0, index=target_subset, columns=feature_names)
        else:
            combos = [f"{f}-{t}" for f in feature_names for t in target_subset]
            df = pd.DataFrame(index=combos, columns=["log2FC", "p-value", "q-value", "Significance", "-log10(qval)"], dtype=float)
            df["p-value"] = 1.0
            df["log2FC"] = 0.0

        if ct_subset is not None:
            groups = pd.Series(np.asarray(self.adata.obs[group_key]).astype(str), index=obs_names)
            query_pool = obs_names[groups.isin(np.atleast_1d(ct_subset)).values]
        else:
            query_pool = obs_names

        rng = np.random.default_rng(0)
        for target in target_subset:
            coef_target = self.coeffs[target]
            thr = effect_threshold
            if thr is None:
                nz = coef_target.values.flatten()
                nz = nz[nz != 0]
                thr = float(pd.Series(nz).quantile(0.75)) if nz.size else 0.0
            ct_eff = coef_target.copy()
            if use_significant and target in getattr(self, "is_significant", {}):
                sig = self.is_significant[target]
                common = [c for c in ct_eff.columns if c in sig.columns]
                ct_eff[common] = ct_eff[common] * sig.loc[ct_eff.index, common].astype(float)
            if target not in names:
                continue
            texpr = Xmat[:, names.index(target)]
            target_expressing = obs_names[texpr > 0].intersection(query_pool)

            for interaction in feature_names:
                col = f"b_{interaction}"
                if col not in ct_eff.columns:
                    continue
                affected = ct_eff.index[np.asarray(ct_eff[col].values, float) > thr]
                if self.mod_type == "lr" and ":" in interaction:
                    receptor = interaction.split(":")[1]
                    rmask = np.ones(len(obs_names), bool)
                    for r in receptor.split("_"):
                        if r in names:
                            rmask &= Xmat[:, names.index(r)] > 0
                    qmask = target_expressing.intersection(obs_names[rmask]).intersection(affected)
                else:
                    qmask = target_expressing.intersection(affected)
                if len(qmask) <= min_query_cells:
                    logger.info(f"Insufficient query cells for {interaction}-{target}. Skipping.")
                    continue
                # membrane-bound vs secreted graph from the ligand's db type
                lig = interaction.split(":")[0] if ":" in interaction else interaction
                sep = "/" if "/" in lig else "_" if "_" in lig else None
                components = lig.split(sep) if sep else [lig]
                conn = conn_secreted
                if getattr(self, "lr_db", None) is not None:
                    rows = self.lr_db[self.lr_db["from"].isin(components)]
                    secreted = rows["type"].str.contains("Secreted Signaling").any() or rows["type"].str.contains("ECM-Receptor").any()
                    conn = conn_secreted if secreted else conn_membrane_bound
                ref_names = obs_names[~obs_names.isin(target_expressing) & ~obs_names.isin(affected)]
                if len(ref_names) == 0:
                    continue

                def group_with_neighbors(pool):
                    if n_anchors is not None and len(pool) >= n_anchors:
                        anchors = pd.Index(rng.choice(pool, size=n_anchors, replace=False))
                    else:
                        anchors = pd.Index(pool)
                    sel = obs_names.get_indexer(anchors)
                    nb = np.unique(conn[sel].nonzero()[1])
                    nb = nb[~np.isin(nb, sel)]
                    return list(anchors) + list(obs_names[nb])

                query_group = group_with_neighbors(qmask)
                reference_group = group_with_neighbors(ref_names)
                comp_idx = [names.index(c) for c in components if c in names]
                if not comp_idx:
                    continue
                lv = Xmat[np.concatenate([obs_names.get_indexer(query_group), obs_names.get_indexer(reference_group)])][:, comp_idx].astype(float)
                if sep == "/":
                    lv = lv.mean(axis=1)
                elif sep == "_":
                    lv = lv.copy()
                    lv[lv == 0] = np.nan
                    with np.errstate(invalid="ignore"):
                        prod = np.nanprod(lv, axis=1)
                        cnt = np.sum(~np.isnan(lv), axis=1).astype(float)
                        cnt[cnt == 0] = np.nan
                        lv = np.power(prod, 1.0 / cnt)
                    lv = np.nan_to_num(lv)
                else:
                    lv = lv[:, 0]
                lq, lr_ = lv[: len(query_group)], lv[len(query_group):]
                if plot_type == "volcano":
                    df.loc[f"{interaction}-{target}", "p-value"] = (
                        0.0 if not lr_.any() else float(mannwhitneyu(lq, lr_)[1])
                    )
                q_agg = float(lq.mean()) if agg_method == "mean" else float((lq > 0).mean())
                r_agg = float(lr_.mean()) if agg_method == "mean" else float((lr_ > 0).mean())
                r_agg = r_agg if r_agg != 0 else 0.001
                fc = float(np.log2(max(q_agg, 1e-12) / r_agg))
                if plot_type == "volcano":
                    df.loc[f"{interaction}-{target}", "log2FC"] = fc
                else:
                    df.loc[target, interaction] = fc

        if plot_type == "volcano":
            df["q-value"] = np.asarray(multitesting_correction(df["p-value"].fillna(1.0).values, method="fdr_bh"), float)
            df["Significance"] = df["q-value"] < 0.05
            with np.errstate(divide="ignore"):
                df["-log10(qval)"] = -np.log10(df["q-value"])
        elif df.shape[0] > 1 and df.shape[1] > 1 and df.values.std() > 0:
            order = sch.dendrogram(sch.linkage(df.transpose(), method="ward"), no_plot=True)["leaves"]
            df = df.iloc[:, order]
            rorder = sch.dendrogram(sch.linkage(df, method="ward"), no_plot=True)["leaves"]
            df = df.iloc[rorder, :]

        if save_df:
            out_folder = os.path.join(os.path.dirname(self.output_path) or ".", "analyses")
            os.makedirs(out_folder, exist_ok=True)
            adata_id = os.path.splitext(os.path.basename(getattr(self, "adata_path", None) or "adata"))[0]
            df.to_csv(os.path.join(out_folder, f"{plot_type}_{adata_id}_interaction_enrichment_fold_change_target_expressing_v_nonexpressing.csv"))
        if save_show_or_return == "return":
            return df
        fig, ax = self._compose_specificity_figure(
            df, plot_type, significance_cutoff, fold_change_cutoff,
            fold_change_cutoff_for_labels, fontsize, figsize, cmap,
        )
        if save_show_or_return in ("axes", "all"):
            return fig, ax, df
        return ax

    def _specificity_graphs(self):
        """Secreted / membrane-bound spatial kNN connectivity graphs, cached
        on adata.obsp (reference MuSIC_downstream.py:2768-2797)."""
        from scipy.sparse import csr_matrix
        from scipy.spatial import cKDTree

        obsp = self.adata.obsp
        if "spatial_connectivities_secreted" in obsp and "spatial_connectivities_membrane_bound" in obsp:
            return obsp["spatial_connectivities_secreted"], obsp["spatial_connectivities_membrane_bound"]
        coords = np.asarray(self.adata.obsm[self.coords_key], float)[:, :2]
        tree = cKDTree(coords)

        def knn_graph(k):
            k = min(k + 1, len(coords))
            _, idx = tree.query(coords, k=k)
            rows = np.repeat(np.arange(len(coords)), idx.shape[1] - 1)
            cols = idx[:, 1:].ravel()
            return csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(len(coords), len(coords)))

        sec = knn_graph(int(getattr(self, "n_neighbors_secreted", 25)))
        mem = knn_graph(int(getattr(self, "n_neighbors_membrane_bound", 8)))
        obsp["spatial_connectivities_secreted"] = sec
        obsp["spatial_connectivities_membrane_bound"] = mem
        return sec, mem

    def _compose_specificity_figure(
        self, df, plot_type, significance_cutoff, fold_change_cutoff,
        fold_change_cutoff_for_labels, fontsize, figsize, cmap,
    ):
        """Reference specificity figure (MuSIC_downstream.py:3041-3190):
        zero-centered divergent heatmap with |FC|<0.1 masked and top
        colorbar, or the labeled up/down volcano."""
        import matplotlib as mpl
        import matplotlib.pyplot as plt
        from mpl_toolkits.axes_grid1 import make_axes_locatable

        fontsize = fontsize or float(mpl.rcParams.get("font.size", 10))
        divergent = {"seismic", "coolwarm", "bwr", "RdBu", "RdGy", "PuOr", "PiYG", "PRGn", "BrBG", "RdYlBu", "RdYlGn", "Spectral"}
        if cmap not in divergent:
            cmap = "seismic"
        if figsize is None:
            figsize = (max(df.shape[1] * 0.3, 4), max(df.shape[0] * 0.3, 4)) if plot_type == "heatmap" else (6, 6)
        fig, ax = plt.subplots(figsize=figsize)
        if plot_type == "volcano":
            size = 20 if len(df) > 20 else 40
            fc, nlq = df["log2FC"].astype(float), df["-log10(qval)"].astype(float)
            if nlq.max() > 8:
                ax.set_yscale("log", base=2)
            significant = nlq > significance_cutoff
            up, down = fc > fold_change_cutoff, fc < -fold_change_cutoff
            ax.scatter(fc[significant & up], nlq[significant & up], c=fc[significant & up], cmap="Reds", edgecolor="black", s=size)
            ax.scatter(fc[significant & down], nlq[significant & down], c=fc[significant & down], cmap="Blues_r", edgecolor="black", s=size)
            rest = ~(significant & (up | down))
            ax.scatter(fc[rest], nlq[rest], color="grey", edgecolor="black", s=size)
            cutoff = fold_change_cutoff_for_labels
            high = df[np.abs(fc) > cutoff]
            while high.empty and cutoff > 1e-3:
                cutoff /= 2
                high = df[np.abs(fc) > cutoff]
            for name, row in high.iterrows():
                ax.text(row["log2FC"], row["-log10(qval)"], str(name), fontsize=fontsize * 0.75, ha="center", va="center")
            ax.axhline(y=significance_cutoff, color="grey", linestyle="--", linewidth=1.5)
            ax.axvline(x=fold_change_cutoff, color="grey", linestyle="--", linewidth=1.5)
            ax.axvline(x=-fold_change_cutoff, color="grey", linestyle="--", linewidth=1.5)
            ax.set_xlabel("$\\log_2$(Fold change Interaction Enrichment \nTarget-Expressing Cells vs. Others", fontsize=fontsize * 1.25)
            ax.set_ylabel(r"$-log_{10}$(qval)", fontsize=fontsize * 1.25)
        else:
            vals = df.values.astype(float)
            max_distance = float(np.abs(vals).max()) or 1.0
            data = np.ma.masked_where(np.abs(vals) < 0.1, vals)
            cm = mpl.colormaps[cmap].copy(); cm.set_bad(color="white")
            im = ax.pcolormesh(data[::-1], cmap=cm, vmin=-max_distance, vmax=max_distance, edgecolors="grey", linewidth=0.3 * figsize[0] / 10)
            ax.set_xticks(np.arange(df.shape[1]) + 0.5); ax.set_xticklabels(df.columns, rotation=90, fontsize=fontsize)
            ax.set_yticks(np.arange(df.shape[0]) + 0.5); ax.set_yticklabels(df.index[::-1], fontsize=fontsize)
            divider = make_axes_locatable(ax)
            cax = divider.append_axes("top", size="30%", pad=0.3)
            cbar = fig.colorbar(im, cax=cax, orientation="horizontal")
            cbar.set_label("$\\log_2$(FC) Target-Expressing vs. Others", fontsize=fontsize, labelpad=10)
            cbar.ax.xaxis.set_ticks_position("top"); cbar.ax.xaxis.set_label_position("top")
            ax.set_xlabel("Neighboring Ligand" if self.mod_type == "ligand" else "L:R Interaction", fontsize=fontsize * 1.25)
            ax.set_ylabel("Target Gene", fontsize=fontsize * 1.25)
        ax.set_title("Fold Change Interaction Enrichment \nTarget-Expressing Cells vs. Others", fontsize=fontsize * 1.5)
        return fig, ax

    def visualize_neighborhood(
        self,
        target: str,
        interaction: str,
        interaction_type: str = "secreted",
        select_examples_criterion: str = "positive",
        effect_threshold: Optional[float] = None,
        cell_type: Optional[str] = None,
        group_key: Optional[str] = None,
        use_significant: bool = False,
        n_anchors: int = 100,
        n_neighbors_expressing: int = 20,
        display_plot: bool = True,
    ):
        """Example-neighborhood visualization of an interaction effect
        (reference semantics, MuSIC_downstream.py:3219): anchor cells are
        target-expressing cells that meet the effect criterion ("positive":
        |effect| above `effect_threshold`, default the 75th quantile of
        nonzero coefficients; "negative": exactly-zero effect), have more
        than `n_neighbors_expressing` spatial neighbors expressing the
        ligand (complexes: "/" = any component, "_" = all components), and
        — for L:R models, positive criterion — express every receptor
        component. Up to `n_anchors` anchors are drawn; their graph
        neighbors get the ligand expression ("/" arithmetic mean, "_"
        geometric mean over nonzero) and the anchors their target
        expression, written to
        adata.obs["{interaction}_{target}_{criterion}_example_points"].
        Returns the modified AnnData; with `display_plot`, renders the
        reference's three-layer scatter (grey rest / green anchors /
        Hot-colored neighbors) on matplotlib instead of plotly (absent
        here) and stores the axes on `self._last_neighborhood_axes`."""
        logger = lm.get_main_logger()
        if self.mod_type not in ("lr", "ligand"):
            raise ValueError("This function is only applicable for ligand-based models.")
        if select_examples_criterion not in ("positive", "negative"):
            raise ValueError("Invalid criterion for selecting examples. Options: 'positive', 'negative'.")
        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        conn_secreted, conn_membrane_bound = self._specificity_graphs()
        if interaction_type == "secreted":
            conn = conn_secreted
        elif interaction_type == "membrane-bound":
            conn = conn_membrane_bound
        else:
            raise ValueError("Invalid interaction type. Options: 'secreted', 'membrane-bound'.")

        from scipy.sparse import issparse

        adata = self.adata
        obs_names = pd.Index(adata.obs_names)
        names = list(map(str, adata.var_names))
        Xmat = adata.X.toarray() if issparse(adata.X) else np.asarray(adata.X)
        coef_target = self.coeffs[target]
        if effect_threshold is None:
            nz = coef_target.values.flatten()
            nz = nz[nz != 0]
            effect_threshold = float(pd.Series(nz).quantile(0.75)) if nz.size else 0.0
        if use_significant:
            if not getattr(self, "is_significant", None):
                self.compute_coeff_significance()
            sig = self.is_significant.get(target)
            if sig is not None:
                common = [c for c in coef_target.columns if c in sig.columns]
                coef_target = coef_target.copy()
                coef_target[common] = coef_target[common] * sig.loc[coef_target.index, common].astype(float)

        target_expression = Xmat[:, names.index(target)]
        eff = np.asarray(coef_target.loc[obs_names, f"b_{interaction}"].values, float)
        target_expressing = obs_names[target_expression > 0]
        if select_examples_criterion == "positive":
            interaction_cells = obs_names[np.abs(eff) > effect_threshold]
        else:
            interaction_cells = obs_names[eff == 0]

        lig = interaction.split(":")[0] if ":" in interaction else interaction
        sep = "/" if "/" in lig else "_" if "_" in lig else None
        lig_genes = lig.split(sep) if sep else [lig]
        lig_idx = [names.index(g) for g in lig_genes if g in names]
        if sep == "/":
            ligand_expr_mask = (Xmat[:, lig_idx] > 0).any(axis=1)
        else:
            ligand_expr_mask = (Xmat[:, lig_idx] > 0).all(axis=1)
        # count ligand-expressing neighbors per cell through the graph
        neighbor_counts = np.asarray((conn > 0) @ ligand_expr_mask.astype(float)).reshape(-1)
        enough_lig_neighbors = obs_names[neighbor_counts > n_neighbors_expressing]

        mask = target_expressing.intersection(interaction_cells).intersection(enough_lig_neighbors)
        if self.mod_type == "lr" and ":" in interaction and select_examples_criterion == "positive":
            receptor = interaction.split(":")[1]
            rmask = np.ones(len(obs_names), bool)
            for r in receptor.split("_"):
                if r in names:
                    rmask &= Xmat[:, names.index(r)] > 0
            mask = mask.intersection(obs_names[rmask])
        if cell_type is not None:
            group_key = group_key or self.group_key
            groups = pd.Series(np.asarray(adata.obs[group_key]).astype(str), index=obs_names)
            mask = mask.intersection(obs_names[groups.values == cell_type])

        logger.info(
            f"Randomly selecting {select_examples_criterion} example cells from a pool of {len(mask)} "
            f"for target {target} and interaction {interaction}."
        )
        n_sel = min(n_anchors, len(mask))
        if n_sel == len(mask):
            selected = pd.Index(mask)
        else:
            selected = pd.Index(np.random.default_rng(0).choice(mask, size=n_sel, replace=False))
        sel_idx = obs_names.get_indexer(selected)
        nb = np.unique(conn[sel_idx].nonzero()[1]) if len(sel_idx) else np.array([], int)
        nb = nb[~np.isin(nb, sel_idx)]
        neighbors_selected = obs_names[nb]

        lv = Xmat[nb][:, lig_idx].astype(float) if len(nb) else np.zeros((0, len(lig_idx)))
        if sep == "/":
            ligand_expression = lv.mean(axis=1)
        elif sep == "_":
            lv = lv.copy()
            lv[lv == 0] = np.nan
            with np.errstate(invalid="ignore"):
                prod = np.nanprod(lv, axis=1)
                cnt = np.sum(~np.isnan(lv), axis=1).astype(float)
                cnt[cnt == 0] = np.nan
                ligand_expression = np.nan_to_num(np.power(prod, 1.0 / cnt))
        else:
            ligand_expression = lv[:, 0] if lv.size else np.zeros(0)

        key = f"{interaction}_{target}_{select_examples_criterion}_example_points"
        adata.obs[key] = 0.0
        adata.obs.loc[selected, key] = target_expression[sel_idx]
        adata.obs.loc[neighbors_selected, key] = ligand_expression

        if display_plot:
            import matplotlib.pyplot as plt

            coords = np.asarray(adata.obsm[self.coords_key], float)
            three_d = coords.shape[1] > 2
            fig, ax = plt.subplots(figsize=(6, 6), subplot_kw={"projection": "3d"} if three_d else {})
            rest = np.setdiff1d(np.arange(len(obs_names)), np.concatenate([sel_idx, nb]) if len(sel_idx) else nb)
            pts = lambda idx: (coords[idx, 0], coords[idx, 1], coords[idx, 2]) if three_d else (coords[idx, 0], coords[idx, 1])
            ax.scatter(*pts(rest), color="#D3D3D3", s=4, linewidths=0, label="Other Cells")
            if len(nb):
                vals = np.minimum(ligand_expression, np.percentile(ligand_expression, 95)) if len(ligand_expression) else ligand_expression
                sc = ax.scatter(*pts(nb), c=vals, cmap="hot", s=6, linewidths=0)
                cb = fig.colorbar(sc, ax=ax, shrink=0.6)
                cb.set_label(f"{lig} Expression")
            ax.scatter(*pts(sel_idx), color="#39FF14", s=16, linewidths=0,
                       label=f"{target}-Expressing Cells")
            ax.legend(fontsize=7, frameon=False)
            ax.set_title(
                f"Target: {target}, Ligand: {lig}\n(Example {select_examples_criterion.title()} Predicted Effects)",
                fontsize=10,
            )
            self._last_neighborhood_axes = ax
        return adata

    def cell_type_specific_interactions(
        self,
        to_plot: str = "mean",
        plot_type: str = "heatmap",
        group_key: Optional[str] = None,
        ct_subset=None,
        target_subset=None,
        interaction_subset=None,
        lower_threshold: float = 0.3,
        upper_threshold: float = 1.0,
        effect_threshold: Optional[float] = None,
        use_significant: bool = False,
        row_normalize: bool = False,
        col_normalize: bool = False,
        normalize_targets: bool = False,
        hierarchical_cluster_ct: bool = False,
        group_y_cell_type: bool = False,
        fontsize: Optional[int] = None,
        figsize=None,
        center: Optional[float] = None,
        cmap: str = "Reds",
        save_show_or_return: str = "return",
        save_kwargs: Optional[dict] = None,
        save_df: bool = False,
        **kwargs,
    ):
        """Enrichment of interaction effects within cell type groupings
        (reference semantics, MuSIC_downstream.py:3737): one row per
        "{cell type}-{target}" combination, one column per interaction
        feature. For "mean", the entry is the mean effect size among cells
        of that type that EXPRESS the target (masked to 0 when fewer than 2%
        of the type's cells express it), after zeroing effects below a
        per-(cell type, target) 75th-quantile threshold (or the explicit
        `effect_threshold`). For "percentage", the fraction of those cells
        whose effect exceeds the threshold.

        Post-processing mirrors the reference: per-target lower/upper
        thresholds relative to the target-group max, optional
        `normalize_targets` / `row_normalize` / `col_normalize` minmax
        scaling, ward hierarchical clustering of interaction columns
        (heatmap mode; optionally of rows via `hierarchical_cluster_ct`),
        target-major (or cell-type-major via `group_y_cell_type`) row
        sorting, and all-zero row/column pruning.

        `save_show_or_return="return"` returns the metric DataFrame; "axes"
        additionally composes the reference figure (heatmap with right-hand
        group color band + top colorbar, or ≤4-interaction barplot panel
        with rank ordering) and returns (fig, axes, df)."""
        import scipy.cluster.hierarchy as sch

        if to_plot not in ("mean", "percentage"):
            raise ValueError("Unrecognized input for plotting. Options are 'mean' or 'percentage'.")
        if plot_type == "barplot" and interaction_subset is None:
            raise ValueError("Must provide a subset of interactions to visualize if 'plot_type' is 'barplot'.")
        if plot_type == "barplot" and len(np.atleast_1d(interaction_subset)) > 4:
            raise ValueError("Can only visualize up to four interactions at once with 'barplot'.")
        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        group_key = group_key or self.group_key
        if isinstance(ct_subset, str):
            ct_subset = [ct_subset]
        adata = self.adata if ct_subset is None else self.adata[self.adata.obs[group_key].isin(ct_subset)]
        groups_all = pd.Series(np.asarray(self.adata.obs[group_key]).astype(str), index=self.adata.obs_names)
        cell_types = list(pd.unique(np.asarray(adata.obs[group_key]).astype(str)))

        all_targets = list(self.coeffs)
        targets = (
            all_targets
            if target_subset is None
            else [t for t in np.atleast_1d(target_subset) if t in set(all_targets)]
        )
        feat_of = lambda c: c[2:] if c.startswith("b_") else c
        all_features = []
        for t in targets:
            for c in self.coeffs[t].columns:
                n = feat_of(c)
                if not n.endswith("intercept") and n not in all_features:
                    all_features.append(n)
        if isinstance(interaction_subset, str):
            interaction_subset = [interaction_subset]
        feature_names = all_features if interaction_subset is None else list(interaction_subset)

        if use_significant and not getattr(self, "is_significant", None):
            self.compute_coeff_significance()

        names = list(map(str, self.adata.var_names))
        combinations = [f"{ct}-{t}" for ct in cell_types for t in targets]
        df = pd.DataFrame(0.0, index=combinations, columns=feature_names)
        for ct in cell_types:
            ct_names = groups_all.index[groups_all.values == ct]
            for t in targets:
                cdf = self.coeffs[t]
                ct_rows = cdf.index.intersection(ct_names)
                if len(ct_rows) == 0:
                    continue
                coef_ct = cdf.loc[ct_rows, [c for c in cdf.columns if "intercept" not in c]].copy()
                # cells of this type expressing the target
                if t in names:
                    expr = np.asarray(self.adata[ct_rows, t].X.todense()).reshape(-1) if hasattr(
                        self.adata[ct_rows, t].X, "todense"
                    ) else np.asarray(self.adata[ct_rows, t].X).reshape(-1)
                    expressing = pd.Index(ct_rows)[expr > 0]
                elif hasattr(self, "targets_expr") and t in getattr(self, "targets_expr", pd.DataFrame()).columns:
                    te = self.targets_expr.loc[self.targets_expr.index.intersection(ct_rows), t]
                    expressing = te.index[np.asarray(te.values, float) > 0]
                else:
                    expressing = pd.Index(ct_rows)
                if effect_threshold is None:
                    nz = coef_ct.values.flatten()
                    nz = nz[nz != 0]
                    thr = float(pd.Series(nz).quantile(0.75)) if nz.size else 0.0
                else:
                    thr = float(effect_threshold)
                coef_ct = coef_ct.where(coef_ct >= thr, 0.0)
                if use_significant and t in getattr(self, "is_significant", {}):
                    sig = self.is_significant[t]
                    common = [c for c in coef_ct.columns if c in sig.columns]
                    coef_ct[common] = coef_ct[common] * sig.loc[coef_ct.index, common].astype(float)
                sparse_ct = len(expressing) < 0.02 * len(ct_rows)
                for feat in feature_names:
                    col = f"b_{feat}" if f"b_{feat}" in coef_ct.columns else (feat if feat in coef_ct.columns else None)
                    if col is None or sparse_ct:
                        continue
                    vals = coef_ct.loc[coef_ct.index.intersection(expressing), col].values
                    if vals.size == 0:
                        continue
                    df.loc[f"{ct}-{t}", feat] = (
                        float(vals.mean()) if to_plot == "mean" else float((vals > thr).mean())
                    )

        # per-target lower/upper thresholds + optional within-target normalization
        grouping = df.index.map(lambda x: x.split("-")[-1])
        group_max = df.groupby(grouping).max()
        for g in group_max.index:
            rows = df.index[df.index.str.endswith(f"-{g}")]
            df.loc[rows] = df.loc[rows].where(df.loc[rows].ge(lower_threshold * group_max.loc[g]), 0)
            if normalize_targets:
                denom = group_max.loc[g].replace(0, np.nan)
                df.loc[rows] = (df.loc[rows] / denom).fillna(0.0)
        if upper_threshold != 1.0:
            df[df >= upper_threshold * df.max().max()] = df.max().max()
        normalize = row_normalize or col_normalize or normalize_targets
        if row_normalize:
            rmin, rmax = df.min(axis=1).values.reshape(-1, 1), df.max(axis=1).values.reshape(-1, 1)
            df = pd.DataFrame((df.values - rmin) / np.where(rmax - rmin == 0, np.nan, rmax - rmin), index=df.index, columns=df.columns)
        elif col_normalize:
            df = (df - df.min()) / (df.max() - df.min())
        df = df.fillna(0.0)

        def _sort_rows(d):
            idx = pd.MultiIndex.from_tuples([tuple(i.rsplit("-", 1)) for i in d.index], names=["first", "second"])
            d = d.set_axis(idx)
            d = d.sort_index(level=["first", "second"] if group_y_cell_type else ["second", "first"])
            return d.set_axis(d.index.map("-".join))

        if plot_type == "heatmap" and df.shape[1] > 1 and np.isfinite(df.values).all() and df.values.std() > 0:
            order = sch.dendrogram(sch.linkage(df.transpose(), method="ward"), no_plot=True)["leaves"]
            df = df.iloc[:, order]
            if hierarchical_cluster_ct and len(df) > 1:
                rorder = sch.dendrogram(sch.linkage(df, method="ward"), no_plot=True)["leaves"]
                df = df.iloc[rorder, :]
            else:
                df = _sort_rows(df)
        else:
            df = _sort_rows(df)
        df = df.loc[~(df == 0).all(axis=1), ~(df == 0).all(axis=0)]

        if save_df:
            out_folder = os.path.join(os.path.dirname(self.output_path) or ".", "analyses")
            os.makedirs(out_folder, exist_ok=True)
            adata_id = os.path.splitext(os.path.basename(getattr(self, "adata_path", None) or "adata"))[0]
            df.to_csv(os.path.join(out_folder, f"{adata_id}_{to_plot}_enrichment_cell_type.csv"))
        if save_show_or_return == "return":
            return df
        fig, axes = self._compose_ct_interaction_figure(
            df, to_plot, plot_type, interaction_subset, normalize, group_y_cell_type,
            fontsize, figsize, center, cmap, targets, cell_types,
        )
        if save_show_or_return in ("axes", "all"):
            return fig, axes, df
        return axes

    def _compose_ct_interaction_figure(
        self, df, to_plot, plot_type, interaction_subset, normalize, group_y_cell_type,
        fontsize, figsize, center, cmap, targets, cell_types,
    ):
        """Reference figure composition for cell_type_specific_interactions
        (MuSIC_downstream.py:4149-4355): group color band in an appended
        axes, masked-zero heatmap with top colorbar, or per-interaction
        barplot stack with group-averaged rank ordering."""
        import matplotlib as mpl
        import matplotlib.pyplot as plt
        from mpl_toolkits.axes_grid1 import make_axes_locatable

        fontsize = fontsize or float(mpl.rcParams.get("font.size", 10))
        group_labels = [i.split("-")[0] if group_y_cell_type else i.rsplit("-", 1)[-1] for i in df.index]
        tab = mpl.colormaps["tab20"].colors
        pool = set(cell_types) if group_y_cell_type else set(targets)
        color_mapping = {a: tab[i % len(tab)] for i, a in enumerate(sorted(pool))}
        maxlen = max((len(a) for a in color_mapping), default=1)
        ax2_size = "30%" if maxlen > 30 else "20%" if maxlen > 20 else "10%"

        if plot_type == "heatmap":
            if figsize is None:
                figsize = (max(len(df.columns) * 0.25, 3.0), max(len(df) * 0.25, 3.0))
            vmin, vmax = 0.0, (1.0 if normalize else float(df.max().max()) or 1.0)
            fig, ax = plt.subplots(figsize=figsize)
            divider = make_axes_locatable(ax)
            ax2 = divider.append_axes("right", size=ax2_size, pad=0)
            cur, start = None, 0
            for i, a in enumerate(group_labels):
                if a != cur:
                    if cur is not None:
                        ax2.text(0.22, len(df) - ((start + i - 1) / 2) - 1, cur, va="center", ha="left", fontsize=fontsize)
                    cur, start = a, i
                ax2.add_patch(plt.Rectangle((0, len(df) - i - 1), 0.2, 1, color=color_mapping.get(a, "grey")))
            if cur is not None:
                ax2.text(0.22, len(df) - ((start + len(df) - 1) / 2) - 1, cur, va="center", ha="left", fontsize=fontsize)
            ax2.set_ylim(0, len(df)); ax2.axis("off")
            data = np.ma.masked_where(df.values == 0, df.values)
            cm = mpl.colormaps[cmap].copy(); cm.set_bad(color="white")
            norm = mpl.colors.TwoSlopeNorm(vcenter=center, vmin=vmin, vmax=vmax) if center is not None else mpl.colors.Normalize(vmin=vmin, vmax=vmax)
            im = ax.pcolormesh(data[::-1], cmap=cm, norm=norm, edgecolors="grey", linewidth=0.3 * figsize[0] / 10)
            ax.set_xticks(np.arange(len(df.columns)) + 0.5); ax.set_xticklabels(df.columns, rotation=90, fontsize=fontsize)
            ax.set_yticks(np.arange(len(df)) + 0.5); ax.set_yticklabels(df.index[::-1], fontsize=fontsize)
            cax = divider.append_axes("top", size="30%" if len(df) > len(df.columns) else "10%", pad=0.3)
            cbar = fig.colorbar(im, cax=cax, orientation="horizontal")
            cbar.set_label(to_plot.title(), fontsize=fontsize * 1.5, labelpad=10)
            cbar.ax.xaxis.set_ticks_position("top"); cbar.ax.xaxis.set_label_position("top")
            x_label, title = {
                "lr": ("Interaction", "Enrichment of L:R interaction in each cell type"),
                "ligand": ("Neighboring ligand expression", "Enrichment of neighboring ligand expression in each cell type for each target"),
                "receptor": ("Receptor expression", "Enrichment of receptor expression in each cell type"),
            }.get(self.mod_type, ("Interaction", "Enrichment in each cell type"))
            ax.set_xlabel(x_label, fontsize=fontsize * 1.25)
            ax.set_ylabel("Cell Type-Specific Target", fontsize=fontsize * 1.25)
            ax.set_title(title, fontsize=fontsize * 1.5, pad=20)
            return fig, ax
        # barplot mode: ≤4 interactions, ordered by mean within-group rank
        rem = [i for i in np.atleast_1d(interaction_subset) if i in df.columns]
        if figsize is None:
            figsize = (max(len(df) * 0.25, 3.0), 3 * max(len(rem), 1))
        fig, axes = plt.subplots(nrows=max(len(rem), 1), ncols=1, figsize=figsize, squeeze=False)
        axes = axes.ravel()
        fig.subplots_adjust(hspace=0.4)
        colormap = mpl.colormaps[cmap]
        sub = df[rem].copy()
        sub["Group"] = group_labels
        order = sub.groupby("Group").rank(ascending=False).mean().sort_values().index.tolist()
        for i, interaction in enumerate(order[: len(axes)]):
            series = df[interaction]
            vmax = 1.0 if normalize else float(series.max()) or 1.0
            norm = mpl.colors.Normalize(vmin=0, vmax=vmax)
            axes[i].bar(range(len(series)), series.values, color=[colormap(norm(v)) for v in series.values], edgecolor="black", linewidth=1)
            axes[i].set_xticks(range(len(series)))
            axes[i].set_title(interaction, fontsize=fontsize * 1.5)
            axes[i].set_ylabel(to_plot.title(), fontsize=fontsize)
            if i == len(order[: len(axes)]) - 1:
                axes[i].set_xticklabels(series.index, rotation=90, fontsize=fontsize * 0.9)
            else:
                axes[i].tick_params(axis="x", labelbottom=False)
        return fig, list(axes)

    def cell_type_interaction_fold_change(
        self,
        ref_ct: str,
        query_ct: str,
        group_key: Optional[str] = None,
        target_subset=None,
        interaction_subset=None,
        to_plot: str = "mean",
        plot_type: str = "barplot",
        source_data: str = "effect",
        top_n_to_plot: Optional[int] = None,
        significance_cutoff: float = 1.3,
        fold_change_cutoff: float = 1.5,
        fold_change_cutoff_for_labels: float = 3.0,
        plot_query_over_ref: bool = False,
        plot_ref_over_query: bool = False,
        plot_only_significant: bool = False,
        fontsize: Optional[int] = None,
        figsize=None,
        cmap: str = "seismic",
        save_show_or_return: str = "return",
        save_kwargs: Optional[dict] = None,
        save_df: bool = False,
        **kwargs,
    ) -> pd.DataFrame:
        """Fold change in predicted interaction effects between two cell
        types (reference semantics, MuSIC_downstream.py:4378). `source_data`
        selects the per-cell matrix: "interaction" = the design matrix
        columns, "effect" = per-target coefficient arrays concatenated as
        "{interaction}-> target {t}" columns (collagen family members
        collapsed to their mean, as the reference's
        replace_col_with_collagens does), "target" = target gene expression.
        Per-column significance via two-sample t-test (effect/interaction)
        or Mann-Whitney U (target), BH-corrected; fold change =
        log2((query_mean + 1e-3) / (ref_mean + 1e-3)) with "mean" or
        ">0-percentage" aggregation, sorted ascending, optionally truncated
        to `top_n_to_plot`.

        Returns the results DataFrame (columns qval, Significance,
        -log10(qval), Fold Change); "axes" additionally composes the
        reference's FC-colored barplot with significance stars or the
        volcano plot with cutoff lines and up/down coloring, returning
        (fig, ax, results)."""
        from scipy.stats import mannwhitneyu, ttest_ind

        group_key = group_key or self.group_key
        if not getattr(self, "coeffs", None) and source_data == "effect":
            self.load_coeffs()
        targets_avail = (
            list(self.targets_expr.columns) if hasattr(self, "targets_expr") else list(getattr(self, "coeffs", {}))
        )
        target_subset = targets_avail if target_subset is None else list(np.atleast_1d(target_subset))
        interaction_subset = (
            [f for f in getattr(self, "feature_names", []) if "intercept" not in f]
            if interaction_subset is None
            else list(np.atleast_1d(interaction_subset))
        )
        groups = pd.Series(np.asarray(self.adata.obs[group_key]).astype(str), index=self.adata.obs_names)
        ref_names = groups.index[groups.values == ref_ct]
        query_names = groups.index[groups.values == query_ct]

        if source_data == "interaction":
            cols = [c for c in interaction_subset if c in self.X_df.columns]
            ref_data = self.X_df.loc[self.X_df.index.intersection(ref_names), cols]
            query_data = self.X_df.loc[self.X_df.index.intersection(query_names), cols]
        elif source_data == "effect":
            effect_df = None
            for target in target_subset:
                if target not in self.coeffs:
                    raise ValueError(f"Target {target} not found in model.")
                ct = self.coeffs[target].copy()
                ct.columns = [c[2:] if c.startswith("b_") else c for c in ct.columns]
                ct = ct[[c for c in ct.columns if c != "intercept"]]
                ct.columns = [f"{replace_col_with_collagens(c)}-> target {target}" for c in ct.columns]
                dups = ct.columns[ct.columns.duplicated(keep=False)]
                for item in pd.unique(dups):
                    mean_series = ct.loc[:, ct.columns == item].mean(axis=1)
                    ct = ct.loc[:, ct.columns != item]
                    ct[item] = mean_series
                wanted = {f"{replace_col_with_collagens(i)}-> target {target}" for i in interaction_subset}
                keep = [c for c in ct.columns if c in wanted]
                effect_df = ct[keep] if effect_df is None else pd.concat([effect_df, ct[keep]], axis=1)
            ref_data = effect_df.loc[effect_df.index.intersection(ref_names)]
            query_data = effect_df.loc[effect_df.index.intersection(query_names)]
        elif source_data == "target":
            cols = [t for t in target_subset if t in self.targets_expr.columns]
            ref_data = self.targets_expr.loc[self.targets_expr.index.intersection(ref_names), cols]
            query_data = self.targets_expr.loc[self.targets_expr.index.intersection(query_names), cols]
        else:
            raise ValueError(
                f"Unrecognized input for source_data: {source_data}. Options are 'interaction', 'effect', or 'target'."
            )

        pvals = []
        for col in ref_data.columns:
            a, b = np.asarray(ref_data[col], float), np.asarray(query_data[col], float)
            if source_data in ("effect", "interaction"):
                pvals.append(float(ttest_ind(a, b)[1]))
            else:
                pvals.append(float(mannwhitneyu(a, b)[1]) if (a.std() or b.std()) else 1.0)
        pvals = np.nan_to_num(np.asarray(pvals, float), nan=1.0)
        qvals = np.asarray(multitesting_correction(pvals, method="fdr_bh"), float)
        results = pd.DataFrame({"qval": qvals}, index=ref_data.columns)
        results["Significance"] = assign_significance(qvals)
        with np.errstate(divide="ignore"):
            nlq = -np.log10(qvals)
        finite_max = np.nanmax(np.where(np.isinf(nlq), np.nan, nlq)) if np.isfinite(nlq).any() else 0.0
        results["-log10(qval)"] = np.where(np.isinf(nlq), finite_max, nlq)

        if to_plot == "mean":
            r, q = ref_data.mean(axis=0), query_data.mean(axis=0)
        else:
            r, q = (ref_data > 0).mean(axis=0), (query_data > 0).mean(axis=0)
        results["Fold Change"] = np.log2((q + 1e-3) / (r + 1e-3))
        results = results[~results["Fold Change"].isna()].sort_values("Fold Change")
        if top_n_to_plot is not None:
            results = results.iloc[:top_n_to_plot, :]

        if save_df:
            out_folder = os.path.join(os.path.dirname(self.output_path) or ".", "analyses")
            os.makedirs(out_folder, exist_ok=True)
            adata_id = os.path.splitext(os.path.basename(getattr(self, "adata_path", None) or "adata"))[0]
            results.to_csv(os.path.join(out_folder, f"{adata_id}_fold_changes_{source_data}_{ref_ct}_{query_ct}.csv"))
        if save_show_or_return == "return":
            return results
        fig, ax = self._compose_fold_change_figure(
            results, ref_ct, query_ct, source_data, plot_type, significance_cutoff,
            fold_change_cutoff, fold_change_cutoff_for_labels, plot_query_over_ref,
            plot_ref_over_query, plot_only_significant, fontsize, figsize, cmap,
        )
        if save_show_or_return in ("axes", "all"):
            return fig, ax, results
        return ax

    def _compose_fold_change_figure(
        self, results, ref_ct, query_ct, source_data, plot_type, significance_cutoff,
        fold_change_cutoff, fold_change_cutoff_for_labels, plot_query_over_ref,
        plot_ref_over_query, plot_only_significant, fontsize, figsize, cmap,
    ):
        """Reference fold-change figure (MuSIC_downstream.py:4597-4803):
        horizontal FC-colored barplot with significance stars, or volcano
        plot with Reds/Blues_r significant up/down scatters, grey
        non-significant points, dashed cutoff lines, and labels for the
        highest fold changes."""
        import matplotlib as mpl
        import matplotlib.pyplot as plt

        fontsize = fontsize or float(mpl.rcParams.get("font.size", 10))
        if figsize is None:
            figsize = (max(len(results) / 4, 4), max(len(results) / 2, 4)) if plot_type == "barplot" else (8, 7)
        fig, ax = plt.subplots(figsize=figsize)
        colormap = mpl.colormaps[cmap]
        fc = results["Fold Change"]
        max_distance = float(np.abs(fc).max()) or 1.0
        norm = plt.Normalize(-max_distance, max_distance)
        if plot_type == "barplot":
            ax.barh(range(len(results)), fc.values, color=colormap(norm(fc.values)), edgecolor="black", linewidth=1)
            for i, (_, row) in enumerate(results.iterrows()):
                ax.text(row["Fold Change"], i, f"{row['Significance']}", color="black", ha="right", fontsize=fontsize)
            ax.axvline(x=0, color="grey", linestyle="--", linewidth=2)
            ax.set_yticks(range(len(results)))
            ax.set_yticklabels(results.index, fontsize=fontsize)
            ax.set_xlabel(
                f"$\\log_2$(Fold change {source_data} - \n{ref_ct} and {query_ct})", fontsize=fontsize * 1.25
            )
            ax.set_title(f"Fold change {source_data} \n{ref_ct} and {query_ct}", fontsize=fontsize * 1.5)
            return fig, ax
        # volcano
        size = 20 if len(results) > 20 else 40
        if results["-log10(qval)"].max() > 8:
            ax.set_yscale("log", base=2)
        significant = results["-log10(qval)"] > significance_cutoff
        sig_up = fc > fold_change_cutoff
        sig_down = fc < -fold_change_cutoff
        shown = results[significant] if plot_only_significant else results
        if plot_query_over_ref:
            sel = significant & sig_up & (fc > 0)
            ax.scatter(fc[sel], results["-log10(qval)"][sel], c=fc[sel], cmap="Reds", edgecolor="black", s=size * 1.5)
        elif plot_ref_over_query:
            sel = significant & sig_down & (fc < 0)
            ax.scatter(fc[sel], results["-log10(qval)"][sel], c=fc[sel], cmap="Blues_r", edgecolor="black", s=size * 1.5)
        else:
            up, down = significant & sig_up, significant & sig_down
            other = ~(significant & (sig_up | sig_down)) & shown.index.isin(results.index)
            ax.scatter(fc[up], results["-log10(qval)"][up], c=fc[up], cmap="Reds", edgecolor="black", s=size)
            ax.scatter(fc[down], results["-log10(qval)"][down], c=fc[down], cmap="Blues_r", edgecolor="black", s=size)
            ax.scatter(fc[other], results["-log10(qval)"][other], color="grey", edgecolor="black", s=size)
        # label the highest fold changes (halving the cutoff until non-empty)
        cutoff = fold_change_cutoff_for_labels
        high = results[np.abs(fc) > cutoff]
        while high.empty and cutoff > 1e-3:
            cutoff /= 2
            high = results[np.abs(fc) > cutoff]
        high = high.sort_values("Fold Change", ascending=False).iloc[:3]
        for name, row in high.iterrows():
            ax.text(row["Fold Change"], row["-log10(qval)"], str(name), fontsize=fontsize * 0.75, ha="center", va="center")
        ax.axhline(y=significance_cutoff, color="grey", linestyle="--", linewidth=1.5)
        ax.axvline(x=fold_change_cutoff, color="grey", linestyle="--", linewidth=1.5)
        ax.axvline(x=-fold_change_cutoff, color="grey", linestyle="--", linewidth=1.5)
        ax.set_xlabel(
            f"$\\log_2$(Fold change {source_data} \n{ref_ct} and {query_ct})", fontsize=fontsize * 1.25
        )
        ax.set_ylabel(r"$-log_{10}$(qval)", fontsize=fontsize * 1.25)
        ax.set_title(f"Fold change {source_data} \n{ref_ct} and {query_ct}", fontsize=fontsize * 1.5)
        return fig, ax

    def _true_positive_obs(self, target: str) -> pd.Index:
        """Cells expressing `target` that the fitted model also predicts to
        express it (reference MuSIC_downstream.py:4910-4917 uses
        predictions.csv cast to bool). Falls back to the expressing cells
        alone when no predictions are available."""
        from scipy.sparse import issparse

        names = list(map(str, self.adata.var_names))
        if target not in names:
            return pd.Index(self.adata.obs_names)
        col = self.adata[:, target].X
        expr = (col.toarray() if issparse(col) else np.asarray(col)).reshape(-1) > 0
        preds = None
        pred_path = os.path.join(os.path.dirname(self.output_path) or ".", "predictions.csv")
        if os.path.exists(pred_path):
            preds = pd.read_csv(pred_path, index_col=0)
        elif hasattr(self, "X_df") and getattr(self, "coeffs", None):
            try:
                preds = self.predict()
            except Exception:
                preds = None
        if preds is not None and target in preds.columns:
            p = preds[target].reindex(pd.Index(self.adata.obs_names)).fillna(0.0)
            expr = expr & np.asarray(p.values, float).astype(bool)
        return pd.Index(self.adata.obs_names)[expr]

    def summarize_interaction_effects(self, interactions=None, targets=None, effect_size_threshold: float = 0.0) -> pd.DataFrame:
        """Interactions x targets mean-effect table over the true-positive
        cells for each target (reference semantics,
        MuSIC_downstream.py:4993: cells expressing the target AND predicted
        to express it; effects below `effect_size_threshold` dropped to 0)."""
        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        if isinstance(interactions, str):
            interactions = [interactions]
        if isinstance(targets, str):
            targets = [targets]
        tlist = list(self.coeffs) if targets is None else [t for t in targets if t in self.coeffs]
        cols = {}
        for t in tlist:
            cdf = self.coeffs[t]
            feats = {c[2:]: c for c in cdf.columns if c.startswith("b_") and "intercept" not in c}
            keep = list(feats) if interactions is None else [i for i in interactions if i in feats]
            tp = self._true_positive_obs(t).intersection(cdf.index)
            sub = cdf.loc[tp, [feats[f] for f in keep]] if len(tp) else cdf.loc[[], [feats[f] for f in keep]]
            avg = sub.mean(axis=0) if len(sub) else pd.Series(0.0, index=[feats[f] for f in keep])
            avg.index = keep
            cols[t] = avg.where(avg > effect_size_threshold, other=np.nan)
        return pd.DataFrame(cols).replace(np.nan, 0.0)

    def enriched_interactions_barplot(
        self,
        interactions=None,
        targets=None,
        plot_type: str = "average",
        effect_size_threshold: float = 0.0,
        fontsize: Optional[int] = None,
        figsize=None,
        cmap: str = "Reds",
        top_n: Optional[int] = None,
        save_show_or_return: str = "return",
        save_kwargs: Optional[dict] = None,
        **kwargs,
    ):
        """Top predicted effect sizes per interaction on each target
        (reference semantics, MuSIC_downstream.py:4826): "average" = mean
        coefficient over cells expressing the target AND predicted to
        express it; "proportion" = fraction of target-expressing cells with
        a positive coefficient. Filtered by `effect_size_threshold`, sorted
        descending, collagen/HLA family collapsing for ligand models,
        truncated to `top_n`; bars drawn with a sequential-colormap palette
        and black edges. Returns {target: Series} for "return" (a bare
        Series when a single target), {target: (fig, ax, Series)} for
        "axes"."""
        import matplotlib as mpl
        import matplotlib.pyplot as plt

        if plot_type not in ("average", "proportion"):
            raise ValueError(f"Unrecognized input for plot_type: {plot_type}. Options are 'average' or 'proportion'.")
        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        fontsize = fontsize or float(mpl.rcParams.get("font.size", 10))
        if isinstance(interactions, str):
            interactions = [interactions]
        if isinstance(targets, str):
            targets = [targets]
        tlist = list(self.coeffs) if targets is None else [t for t in targets if t in self.coeffs]
        out = {}
        for target in tlist:
            cdf = self.coeffs[target]
            feats = {c[2:]: c for c in cdf.columns if c.startswith("b_") and "intercept" not in c}
            keep = list(feats) if interactions is None else [i for i in interactions if i in feats]
            if plot_type == "average":
                rows = self._true_positive_obs(target).intersection(cdf.index)
                sub = cdf.loc[rows, [feats[f] for f in keep]]
                to_plot = sub.mean(axis=0) if len(sub) else pd.Series(0.0, index=[feats[f] for f in keep])
            else:
                from scipy.sparse import issparse

                names = list(map(str, self.adata.var_names))
                col = self.adata[:, target].X if target in names else None
                expr = ((col.toarray() if issparse(col) else np.asarray(col)).reshape(-1) > 0) if col is not None else np.ones(len(self.adata.obs_names), bool)
                rows = pd.Index(self.adata.obs_names)[expr].intersection(cdf.index)
                sub = cdf.loc[rows, [feats[f] for f in keep]]
                to_plot = (sub > 0).mean(axis=0) if len(sub) else pd.Series(0.0, index=[feats[f] for f in keep])
            to_plot.index = keep
            to_plot = to_plot[to_plot > effect_size_threshold].sort_values(ascending=False)
            if self.mod_type == "ligand":
                to_plot.index = [replace_hla_with_hlas(replace_col_with_collagens(i)) for i in to_plot.index]
            if top_n is not None:
                to_plot = to_plot.iloc[:top_n]
            if save_show_or_return == "return":
                out[target] = to_plot
                continue
            fs = figsize or (max(len(to_plot) / 2, 3), 5)
            fig, ax = plt.subplots(figsize=fs)
            cm = mpl.colormaps[cmap]
            colors = [cm(0.3 + 0.7 * i / max(len(to_plot) - 1, 1)) for i in range(len(to_plot))][::-1]
            ax.bar(range(len(to_plot)), to_plot.values, color=colors, edgecolor="black", linewidth=1)
            ax.set_xticks(range(len(to_plot)))
            ax.set_xticklabels(to_plot.index, rotation=90, fontsize=fontsize)
            ax.set_xlabel("Interaction (ligand(s):receptor(s))", fontsize=fontsize)
            if plot_type == "average":
                ax.set_title(f"Average Predicted Interaction Effects on {target}", fontsize=fontsize)
                ax.set_ylabel("Mean Coefficient \nMagnitude", fontsize=fontsize)
            else:
                ax.set_title(f"Proportion of {target}-Expressing Cells \nPredicted to be Affected by Interaction", fontsize=fontsize)
                ax.set_ylabel("Proportion of Cells", fontsize=fontsize)
            out[target] = (fig, ax, to_plot)
        if len(out) == 1:
            return next(iter(out.values()))
        return out

    def _downstream_model_state(self, target_type: str):
        """Fitted downstream-model pieces for a target type (reference
        MuSIC_downstream.py:5110-5143): (coeffs dict, TF names, predictions
        DataFrame or None). Predictions come from the in-memory fit first,
        then the reference's `cci_deg_detection/{folder}/downstream/
        predictions.csv` on disk."""
        if target_type == "ligand":
            attr, folder = "ligand", "ligand_analysis"
        elif target_type == "receptor":
            attr, folder = "receptor", "receptor_analysis"
        elif target_type == "target_gene":
            attr, folder = "target", "target_gene_analysis"
        else:
            raise ValueError(
                f"Unrecognized input for target_type: {target_type}. Options are 'ligand', 'receptor', "
                f"or 'target_gene'."
            )
        coeffs = getattr(self, f"downstream_model_{attr}_coeffs", None)
        if not coeffs:
            raise ValueError(
                f"No fitted downstream {target_type} model found. Run CCI_deg_detection_setup(...) and "
                f"CCI_deg_detection(fit_all=True) first."
            )
        dm = getattr(self, f"downstream_model_{attr}_design_matrix", None)
        tfs = [c.replace("regulator_", "") for c in dm.columns] if dm is not None else sorted(
            {c[2:] for cdf in coeffs.values() for c in cdf.columns if c.startswith("b_") and "intercept" not in c}
        )
        predictions = getattr(self, f"downstream_model_{attr}_predictions", None)
        if predictions is None:
            pred_path = os.path.join(
                os.path.dirname(self.output_path) or ".", "cci_deg_detection", folder, "downstream", "predictions.csv"
            )
            if os.path.exists(pred_path):
                predictions = pd.read_csv(pred_path, index_col=0)
        return coeffs, tfs, predictions

    def _tf_effects_for_target(self, coeffs: dict, target: str, tfs: List[str]) -> pd.DataFrame:
        """Per-cell TF coefficient table for one downstream target, with
        `b_` stripped and subset to `tfs` (reference :5161-5166)."""
        coef = coeffs[target]
        effects = coef[[c for c in coef.columns if c.startswith("b_") and "intercept" not in c]].copy()
        effects.columns = [c[2:] for c in effects.columns]
        keep = [t for t in tfs if t in effects.columns]
        return effects[keep]

    def _target_true_positive_mask(self, target: str, predictions: Optional[pd.DataFrame]):
        """(expressing, true-positive) boolean masks over obs for a
        downstream target (reference :5168-5174: expression > 0 AND the
        downstream model's prediction cast to bool)."""
        from scipy.sparse import issparse

        names = list(map(str, self.adata.var_names))
        if target in names:
            col = self.adata[:, target].X
            expr = (col.toarray() if issparse(col) else np.asarray(col)).reshape(-1) > 0
        else:
            expr = np.ones(self.adata.n_obs, dtype=bool)
        if predictions is not None and target in predictions.columns:
            p = predictions[target].reindex(pd.Index(self.adata.obs_names)).fillna(0.0)
            tp = expr & np.asarray(p.values, float).astype(bool)
        else:
            tp = expr
        return expr, tp

    def summarize_tf_effects(
        self,
        tfs: Optional[Union[str, List[str]]] = None,
        targets=None,
        target_type: str = "target_gene",
        effect_size_threshold: float = 0.0,
    ) -> pd.DataFrame:
        """TF x target table of average downstream-model effect sizes over
        each target's true-positive cells (reference semantics,
        MuSIC_downstream.py:5248: cells expressing the target AND predicted
        by the downstream model to express it; entries below
        `effect_size_threshold` dropped to 0)."""
        coeffs, all_tfs, predictions = self._downstream_model_state(target_type)
        if isinstance(tfs, str):
            tfs = [tfs]
        tfs = [t.replace("regulator_", "") for t in (tfs if tfs is not None else all_tfs)]
        if isinstance(targets, str):
            targets = [targets]
        targets = list(coeffs) if targets is None else [t for t in targets if t in coeffs]
        effects_df = pd.DataFrame(0.0, index=tfs, columns=targets)
        for target in targets:
            effects = self._tf_effects_for_target(coeffs, target, tfs)
            _, tp = self._target_true_positive_mask(target, predictions)
            rows = pd.Index(self.adata.obs_names)[tp].intersection(effects.index)
            avg = effects.loc[rows].mean(axis=0) if len(rows) else pd.Series(0.0, index=effects.columns)
            effects_df[target] = avg[avg > effect_size_threshold]
        return effects_df.replace(np.nan, 0.0)

    def enriched_tfs_barplot(
        self,
        tfs: Optional[Union[str, List[str]]] = None,
        targets=None,
        target_type: str = "target_gene",
        plot_type: str = "average",
        effect_size_threshold: float = 0.0,
        fontsize: Optional[int] = None,
        figsize=None,
        cmap: str = "Reds",
        top_n: Optional[int] = None,
        save_show_or_return: str = "return",
        save_kwargs: Optional[dict] = None,
        **kwargs,
    ):
        """Top predicted TF effect sizes on downstream-model targets
        (reference semantics, MuSIC_downstream.py:5059). "average" averages
        coefficient magnitude over the target's true-positive cells
        (expressing AND predicted); "proportion" is the fraction of
        expressing cells with a positive coefficient. Returns the plotted
        Series per target for "return"; "axes" composes the barplot and
        returns {target: (fig, ax, series)} (a bare tuple for one target)."""
        import matplotlib as mpl

        coeffs, all_tfs, predictions = self._downstream_model_state(target_type)
        if plot_type not in ("average", "proportion"):
            raise ValueError(f"Unrecognized input for plot_type: {plot_type}. Options are 'average' or 'proportion'.")
        if isinstance(tfs, str):
            tfs = [tfs]
        tfs = [t.replace("regulator_", "") for t in (tfs if tfs is not None else all_tfs)]
        if isinstance(targets, str):
            targets = [targets]
        targets = list(coeffs) if targets is None else [t for t in targets if t in coeffs]
        fontsize = fontsize or float(mpl.rcParams.get("font.size", 10))
        out = {}
        for target in targets:
            effects = self._tf_effects_for_target(coeffs, target, tfs)
            expr, tp = self._target_true_positive_mask(target, predictions)
            obs = pd.Index(self.adata.obs_names)
            if plot_type == "average":
                rows = obs[tp].intersection(effects.index)
                to_plot = effects.loc[rows].mean(axis=0) if len(rows) else pd.Series(0.0, index=effects.columns)
            else:
                rows = obs[expr].intersection(effects.index)
                to_plot = (effects.loc[rows] > 0).mean(axis=0) if len(rows) else pd.Series(0.0, index=effects.columns)
            to_plot = to_plot[to_plot > effect_size_threshold].sort_values(ascending=False)
            if top_n is not None:
                to_plot = to_plot.iloc[:top_n]
            if save_show_or_return == "return":
                out[target] = to_plot
                continue
            import matplotlib.pyplot as plt

            fs = figsize or (max(len(to_plot) / 2, 3), 5)
            fig, ax = plt.subplots(figsize=fs)
            cm = mpl.colormaps[cmap]
            colors = [cm(0.3 + 0.7 * i / max(len(to_plot) - 1, 1)) for i in range(len(to_plot))][::-1]
            ax.bar(range(len(to_plot)), to_plot.values, color=colors, edgecolor="black", linewidth=1)
            ax.set_xticks(range(len(to_plot)))
            ax.set_xticklabels(to_plot.index, rotation=90, fontsize=fontsize)
            ax.set_xlabel("Transcription Factor", fontsize=fontsize)
            if plot_type == "average":
                ax.set_title(f"Average Predicted TF Effects on {target}", fontsize=fontsize)
                ax.set_ylabel("Mean Coefficient \nMagnitude", fontsize=fontsize)
            else:
                ax.set_title(
                    f"Proportion of {target}-Expressing Cells \nPredicted to be Affected by TF", fontsize=fontsize
                )
                ax.set_ylabel("Proportion of Cells", fontsize=fontsize)
            out[target] = (fig, ax, to_plot)
        if len(out) == 1:
            return next(iter(out.values()))
        return out

    # ------------------------------------------------------------------
    # effect potential / directionality (parity: :5336-6020)
    # ------------------------------------------------------------------
    def _spatial_weights(self, n_neighbors: int = 10) -> "np.ndarray":
        from scipy.sparse import csr_matrix
        from scipy.spatial import cKDTree

        coords = np.asarray(self.adata.obsm[self.coords_key], float)[:, :2]
        tree = cKDTree(coords)
        d, idx = tree.query(coords, k=min(n_neighbors + 1, len(coords)))
        d, idx = d[:, 1:], idx[:, 1:]
        bw = np.median(d[:, -1]) + 1e-12
        w = np.exp(-((d / bw) ** 2))
        rows = np.repeat(np.arange(len(coords)), idx.shape[1])
        return csr_matrix((w.ravel(), (rows, idx.ravel())), shape=(len(coords), len(coords)))

    def get_effect_potential_matrix(self, target: str, interaction: str, spatial_weights=None):
        """[n, n] sender->receiver effect potential:
        potential[j, i] = lig_expr[j] * W[i, j] * coeff_i (parity:
        MuSIC_downstream.py:5336 get_effect_potential's matrix form)."""
        from scipy.sparse import issparse

        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        cdf = self.coeffs[target]
        col = interaction if interaction in cdf.columns else f"b_{interaction}"
        if col not in cdf.columns:
            raise KeyError(f"interaction `{interaction}` not among fitted features: {list(cdf.columns)}")
        W = spatial_weights if spatial_weights is not None else self._spatial_weights()
        lig = interaction.split(":")[0].split("/")[0]
        names = list(map(str, self.adata.var_names))
        X = self.adata.X.toarray() if issparse(self.adata.X) else np.asarray(self.adata.X)
        lig_expr = X[:, names.index(lig)] if lig in names else np.ones(self.adata.n_obs)
        beta = np.zeros(self.adata.n_obs)
        pos = {str(n): k for k, n in enumerate(self.adata.obs_names)}
        for ci, cell in enumerate(cdf.index):
            k = pos.get(str(cell))
            if k is not None:
                beta[k] = cdf[col].values[ci]
        # rows = senders j, cols = receivers i: lig[j] * W[i, j] * beta[i]
        P = W.T.multiply(lig_expr[:, None]).multiply(np.abs(beta)[None, :]).tocsr()
        sent = np.asarray(P.sum(axis=1)).ravel()
        received = np.asarray(P.sum(axis=0)).ravel()
        norm_sent = sent / max(sent.max(), 1e-12)
        norm_received = received / max(received.max(), 1e-12)
        return P, norm_sent, norm_received

    def get_pathway_potential(self, pathway: Optional[str] = None, target: Optional[str] = None, spatial_weights_secreted=None, spatial_weights_membrane_bound=None, store_summed_potential: bool = True):
        """Aggregate effect potential over all fitted interactions whose
        ligand belongs to `pathway` in the L-R database (parity: :5618)."""
        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        if target is None:
            target = next(iter(self.coeffs))
        db = self.lr_db
        members = set(db[db["pathway"] == pathway]["from"].astype(str)) if pathway else set()
        cdf = self.coeffs[target]
        W = self._spatial_weights()
        total = None
        used = []
        for col in cdf.columns:
            name = col[2:] if col.startswith("b_") else col
            if name.endswith("intercept"):
                continue
            lig = name.split(":")[0].split("/")[0]
            if pathway and lig not in members:
                continue
            P, _, _ = self.get_effect_potential_matrix(target, name, spatial_weights=W)
            total = P if total is None else total + P
            used.append(name)
        if total is None:
            raise ValueError(f"no fitted interactions belong to pathway `{pathway}`")
        if getattr(self, "mod_type", "ligand") == "lr" and len(used) < 3:
            # reference guard (:5683): pathway analysis needs >=3 fitted
            # ligand-receptor pairs in an lr model
            raise ValueError(
                f"Pathway effect potential computation for pathway {pathway} is unsuitable for this model, "
                f"since there are fewer than three valid ligand-receptor pairs in the pathway that were "
                f"incorporated in the initial model."
            )
        sent = np.asarray(total.sum(axis=1)).ravel()
        received = np.asarray(total.sum(axis=0)).ravel()

        def _minmax(v):
            rng_ = np.max(v) - np.min(v)
            return (v - np.min(v)) / rng_ if rng_ > 0 else np.zeros_like(v)

        norm_sent, norm_received = _minmax(sent), _minmax(received)
        if store_summed_potential:
            # reference obs naming (:5741-5750)
            suffix = "lr" if getattr(self, "mod_type", "ligand") == "lr" else "ligands"
            self.adata.obs[f"norm_sum_sent_effect_potential_{pathway}_{suffix}_for_{target}"] = norm_sent
            self.adata.obs[f"norm_sum_received_effect_potential_{pathway}_{suffix}_for_{target}"] = norm_received
        lm.main_info(f"pathway `{pathway}`: aggregated {len(used)} interactions")
        return total, norm_sent, norm_received

    def define_effect_vf(
        self,
        effect_potential,
        normalized_effect_potential_sum_sender,
        normalized_effect_potential_sum_receiver,
        sig: str,
        target: str,
        max_val: float = 0.05,
    ):
        """Sender/receiver vector fields from the potential matrix: each
        cell's sender vector points at the weighted centroid of its
        receivers (parity: :5894). Stored in
        .obsm['spatial_effect_sender_vf_{sig}_{target}'] (and receiver)."""
        from scipy.sparse import issparse

        coords = np.asarray(self.adata.obsm[self.coords_key], float)[:, :2]
        P = effect_potential.tocsr() if issparse(effect_potential) else np.asarray(effect_potential)
        n = coords.shape[0]
        sender_vf = np.zeros((n, 2))
        receiver_vf = np.zeros((n, 2))
        if issparse(effect_potential):
            Pd = np.asarray(P.todense())
        else:
            Pd = P
        row_sum = Pd.sum(1, keepdims=True)
        col_sum = Pd.sum(0, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            # sender j: toward weighted centroid of receivers
            cent_r = (Pd @ coords) / np.maximum(row_sum, 1e-12)
            sender_vf = (cent_r - coords) * normalized_effect_potential_sum_sender[:, None]
            # receiver i: from weighted centroid of senders
            cent_s = (Pd.T @ coords) / np.maximum(col_sum.T, 1e-12)
            receiver_vf = (coords - cent_s) * normalized_effect_potential_sum_receiver[:, None]
        norm = np.linalg.norm(sender_vf, axis=1, keepdims=True)
        span = float(np.ptp(coords, axis=0).max())
        cap = max_val * span
        sender_vf = np.where(norm > cap, sender_vf / np.maximum(norm, 1e-12) * cap, sender_vf)
        norm = np.linalg.norm(receiver_vf, axis=1, keepdims=True)
        receiver_vf = np.where(norm > cap, receiver_vf / np.maximum(norm, 1e-12) * cap, receiver_vf)
        self.adata.obsm[f"spatial_effect_sender_vf_{sig}_{target}"] = sender_vf
        self.adata.obsm[f"spatial_effect_receiver_vf_{sig}_{target}"] = receiver_vf
        return sender_vf, receiver_vf

    def inferred_effect_direction(self, targets=None, compute_pathway_effect: bool = False):
        """Sender/receiver effect vector fields for every fitted interaction
        (or pathway) on the given targets (reference semantics,
        MuSIC_downstream.py:5758). With `compute_pathway_effect`, queries
        are the L:R-database pathways represented by at least three of the
        fitted interactions (the reference's Counter >= 3 rule) and each
        field aggregates the member interactions' potentials via
        `get_pathway_potential`; otherwise one field per fitted
        interaction. Only defined for ligand-carrying models."""
        if self.mod_type not in ("ligand", "lr"):
            raise ValueError(
                "Direction of effect can only be inferred if ligand expression is used as part of the model."
            )
        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        targets = list(self.coeffs) if targets is None else list(np.atleast_1d(targets))
        W = self._spatial_weights()
        if compute_pathway_effect:
            from collections import Counter

            if getattr(self, "lr_db", None) is None:
                raise ValueError("Pathway aggregation requires the L:R database (lr_db).")
            db = self.lr_db
            pathways = []
            fitted = set()
            for t in targets:
                for col in self.coeffs[t].columns:
                    name = col[2:] if col.startswith("b_") else col
                    if not name.endswith("intercept"):
                        fitted.add(name)
            for query in fitted:
                if ":" in query:
                    lig, rec = query.split(":", 1)
                    rows = db.loc[(db["from"] == lig) & (db["to"] == rec), "pathway"]
                else:
                    rows = db.loc[db["from"] == query, "pathway"]
                pathways.extend(set(rows.values))
            counts = Counter(pathways)
            queries = [p for p, c in counts.items() if c >= 3]
            for t in targets:
                for pathway in queries:
                    P, ns, nr = self.get_pathway_potential(pathway=pathway, target=t, store_summed_potential=True)
                    self.define_effect_vf(P, ns, nr, pathway, t)
            return self.adata
        for t in targets:
            for col in self.coeffs[t].columns:
                name = col[2:] if col.startswith("b_") else col
                if name.endswith("intercept"):
                    continue
                P, ns, nr = self.get_effect_potential_matrix(t, name, spatial_weights=W)
                self.define_effect_vf(P, ns, nr, name, t)
        return self.adata

    def visualize_effect_vf_3D(
        self,
        interaction: str,
        target: str,
        vf_key: Optional[str] = None,
        vector_magnitude_lower_bound: float = 0.0,
        manual_vector_scale_factor: Optional[float] = None,
        bin_size=None,
        plot_cells: bool = True,
        cell_size: float = 1.0,
        alpha: float = 0.3,
        no_color_coding: bool = False,
        only_view_effect_region: bool = False,
        add_group_label: Optional[str] = None,
        group_label_obs_key: Optional[str] = None,
        save_path: Optional[str] = None,
        **kwargs,
    ):
        """Directionality of the interaction's effect overlaid on the 3D
        scatter (reference semantics, MuSIC_downstream.py:6020): vectors
        come from `.obsm[vf_key or "spatial_effect_sender_vf_{interaction}_
        {target}"]`; vectors shorter than `vector_magnitude_lower_bound` ×
        the max magnitude are dropped; `bin_size` de-clutters by keeping one
        averaged vector per 3D bin; `manual_vector_scale_factor` rescales
        lengths; cells are colored by the effect coefficient unless
        `no_color_coding`, `add_group_label` highlights one cell group in
        orange, and `only_view_effect_region` crops the axes to the bounding
        box of nonzero effects. Rendered with mplot3d quiver (pyvista/plotly
        absent from this image, PARITY.md). Returns (fig, ax)."""
        import matplotlib.pyplot as plt

        key = vf_key or f"spatial_effect_sender_vf_{interaction}_{target}"
        if key not in self.adata.obsm:
            raise KeyError(
                f"Vector field `{key}` not found in .obsm — run get_effect_potential_matrix + define_effect_vf first."
            )
        vf = np.asarray(self.adata.obsm[key], float)
        coords = self._coords3d()
        if vf.shape[1] == 2:
            vf = np.concatenate([vf, np.zeros((len(vf), 1))], axis=1)
        mags = np.linalg.norm(vf, axis=1)
        keep = mags >= vector_magnitude_lower_bound * max(mags.max(), 1e-12)
        vc, vv = coords[keep], vf[keep]
        if bin_size is not None:
            sizes = np.broadcast_to(np.atleast_1d(np.asarray(bin_size, float)), (3,))
            bins = np.floor(vc / sizes).astype(np.int64)
            _, inv = np.unique(bins, axis=0, return_inverse=True)
            nb = inv.max() + 1 if len(inv) else 0
            pos_sum = np.zeros((nb, 3))
            vec_sum = np.zeros((nb, 3))
            cnt = np.zeros(nb)
            np.add.at(pos_sum, inv, vc)
            np.add.at(vec_sum, inv, vv)
            np.add.at(cnt, inv, 1.0)
            vc = pos_sum / np.maximum(cnt[:, None], 1)
            vv = vec_sum / np.maximum(cnt[:, None], 1)
        if manual_vector_scale_factor is not None:
            vv = vv * float(manual_vector_scale_factor)
        if not getattr(self, "coeffs", None):
            self.load_coeffs()
        coef = None
        if target in getattr(self, "coeffs", {}):
            cdf = self.coeffs[target]
            col = f"b_{interaction}" if f"b_{interaction}" in cdf.columns else interaction
            if col in cdf.columns:
                coef = cdf[col].reindex(pd.Index(self.adata.obs_names)).fillna(0.0).values
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(projection="3d")
        if plot_cells:
            if coef is not None and not no_color_coding:
                affected = coef != 0
                ax.scatter(
                    coords[~affected, 0], coords[~affected, 1], coords[~affected, 2],
                    c="#D3D3D3", s=cell_size**2, alpha=alpha,
                )
                sc = ax.scatter(
                    coords[affected, 0], coords[affected, 1], coords[affected, 2],
                    c=coef[affected], cmap="Reds", s=cell_size**2,
                )
                fig.colorbar(sc, ax=ax, shrink=0.5, pad=0.1)
            else:
                ax.scatter(coords[:, 0], coords[:, 1], coords[:, 2], c="#D3D3D3", s=cell_size**2, alpha=alpha)
        if add_group_label is not None:
            gk = group_label_obs_key or self.group_key
            gmask = np.asarray(self.adata.obs[gk].astype(str) == str(add_group_label))
            ax.scatter(
                coords[gmask, 0], coords[gmask, 1], coords[gmask, 2], c="#FFA500", s=cell_size**2, label=str(add_group_label)
            )
            ax.legend(loc="upper right", fontsize=7)
        ax.quiver(vc[:, 0], vc[:, 1], vc[:, 2], vv[:, 0], vv[:, 1], vv[:, 2], color="tab:red", length=1.0)
        if only_view_effect_region and coef is not None and (coef != 0).any():
            region = coords[coef != 0]
            pad = 0.05 * np.ptp(region, axis=0).max()
            ax.set_xlim(region[:, 0].min() - pad, region[:, 0].max() + pad)
            ax.set_ylim(region[:, 1].min() - pad, region[:, 1].max() + pad)
            ax.set_zlim(region[:, 2].min() - pad, region[:, 2].max() + pad)
        ax.set_title(f"{interaction.title()} Effect on {target.title()}")
        if save_path:
            fig.savefig(
                save_path if not str(save_path).endswith(".html") else str(save_path)[:-5] + ".png",
                dpi=150, bbox_inches="tight",
            )
        return fig, ax

    # ------------------------------------------------------------------
    # CCI DEG detection + summaries (parity: :6607-7941)
    # ------------------------------------------------------------------
    @staticmethod
    def _intersection_ratio_top_regulators(signal_df: pd.DataFrame, regulator_df: pd.DataFrame, k: int = 20):
        """For each signal column, rank regulators by
        |nonzero(signal) ∩ nonzero(regulator)| / |nonzero(regulator)| and
        keep the top `k` (reference MuSIC_downstream.py:6954-6976)."""
        sig_nz = signal_df.values != 0
        reg_nz = regulator_df.values != 0
        # [n_signals, n_regs] intersection counts in one matmul
        inter = sig_nz.T.astype(float) @ reg_nz.astype(float)
        reg_counts = reg_nz.sum(axis=0).astype(float)
        ratios = np.divide(inter, reg_counts[None, :], out=np.zeros_like(inter), where=reg_counts[None, :] > 0)
        top = {}
        for si, sc in enumerate(signal_df.columns):
            order = np.argsort(-ratios[si])[:k]
            top[sc] = [regulator_df.columns[j] for j in order]
        return top

    def _select_grn_regulators(self, expr: pd.DataFrame, signal_df: pd.DataFrame, custom_tfs=None, n_obs=None):
        """Reference TF selection (MuSIC_downstream.py:6907-6981): primary
        TFs = GRN columns measured and nonzero in >= target_expr_threshold
        of cells; secondary TFs = GRN-bound partners of the primaries kept
        at half that threshold; the union is then pruned to the top-20
        coexpressed regulators per signal column by intersection ratio.
        The binary TF-TF binding matrix stands in for the reference's GRN
        file (which ships only as an LFS pointer)."""
        n_obs = n_obs if n_obs is not None else len(expr)
        sp = getattr(self, "species", "human")
        grn = getattr(self, "grn", None)
        if grn is None:
            from .MuSIC import _read_db_csv
            import os as _os

            grn = _read_db_csv(_os.path.join(self.cci_dir, f"{sp}_TF_TF_db.csv"))
        if grn is None:
            grn = pd.DataFrame()
        grn = grn[[c for c in grn.columns if c in expr.columns]]

        thr = getattr(self, "target_expr_threshold", 0.05)
        n_cells_threshold = int(thr * n_obs)
        all_TFs = list(grn.columns)
        if all_TFs:
            nnz = (expr[all_TFs].values != 0).sum(axis=0)
            all_TFs = [tf for tf, c in zip(all_TFs, nnz) if c >= n_cells_threshold]
        if custom_tfs is not None:
            all_TFs.extend([t for t in custom_tfs if t in expr.columns])

        # secondary TFs: binding partners of the primaries, at half threshold
        check_TFs = [tf for tf in all_TFs if tf in grn.index]
        secondary_TFs: List[str] = []
        if check_TFs:
            primary_rows = grn.loc[check_TFs]
            secondary_TFs = primary_rows.columns[(primary_rows == 1).any()].tolist()
            nnz = (expr[secondary_TFs].values != 0).sum(axis=0)
            secondary_TFs = [tf for tf, c in zip(secondary_TFs, nnz) if c >= int(0.5 * n_cells_threshold)]
            secondary_TFs = [tf for tf in secondary_TFs if tf not in all_TFs]
        regulator_features = all_TFs + secondary_TFs

        # fallback pool when the binding matrix covers nothing measured
        if not regulator_features:
            pool = set()
            if getattr(self, "r_tf_db", None) is not None:
                pool |= set(map(str, self.r_tf_db["tf"]))
            if getattr(self, "tf_target_db", None) is not None:
                pool |= set(map(str, self.tf_target_db["TF"]))
            regulator_features = [t for t in sorted(pool) if t in expr.columns]
            nnz = (expr[regulator_features].values != 0).sum(axis=0) if regulator_features else []
            regulator_features = [t for t, c in zip(regulator_features, nnz) if c >= int(0.5 * n_cells_threshold)]

        if regulator_features:
            top = self._intersection_ratio_top_regulators(signal_df, expr[regulator_features], k=20)
            regulator_features = list(set(r for regs in top.values() for r in regs))
        if custom_tfs is not None:
            regulator_features = list(set(regulator_features) | {t for t in custom_tfs if t in expr.columns})
        return regulator_features

    @staticmethod
    def _split_complex_columns(sig_df: pd.DataFrame, expr: pd.DataFrame) -> pd.DataFrame:
        """Replace complex columns ('A_B') by their measured components
        (reference MuSIC_downstream.py:6743-6751)."""
        sig_df = sig_df.copy()
        for col in list(sig_df.columns):
            if "_" in str(col):
                sig_df = sig_df.drop(col, axis=1)
                for part in str(col).split("_"):
                    if part in expr.columns:
                        sig_df[part] = expr[part].values
        return sig_df

    def CCI_deg_detection_setup(
        self,
        group_key: Optional[str] = None,
        custom_tfs: Optional[List[str]] = None,
        sender_receiver_or_target_degs: str = "sender",
        use_ligands: bool = True,
        use_receptors: bool = False,
        use_pathways: bool = False,
        use_targets: bool = False,
        use_cell_types: bool = False,
        compute_dim_reduction: bool = False,
        **kwargs,
    ):
        """Build the downstream GLM design for CCI DEG detection (parity:
        reference MuSIC_downstream.py:6607 — same signature and pipeline).

        The dependent 'signal' is the model's ligands (non-lagged),
        receptors, pathway-aggregated ligands/receptors, or targets
        (complex columns split into components, then filtered to >1%
        nonzero cells); regulators are chosen by the GRN primary/secondary
        + intersection-ratio procedure. With ``use_cell_types`` one design
        is built per cell type (stored in ``self._cci_deg_by_cell_type``).
        Alongside the design this stores the reference's X_jaccard array
        (binary signal profile, the downstream model's neighbor space) and
        optionally a PCA representation (`compute_dim_reduction`)."""
        from scipy.sparse import issparse

        if use_pathways and getattr(self, "species", "human") != "human":
            raise ValueError("Pathway analysis is only available for human samples.")
        if sender_receiver_or_target_degs == "target" and use_pathways:
            raise ValueError("`sender_receiver_or_target_degs` cannot be 'target' if 'use_pathways' is True.")
        if not hasattr(self, "lr_db") or self.lr_db is None:
            self._load_db()
        names = list(map(str, self.adata.var_names))
        X = self.adata.X.toarray() if issparse(self.adata.X) else np.asarray(self.adata.X, dtype=float)
        expr = pd.DataFrame(X, index=self.adata.obs_names, columns=names)

        def _molecule_pool(kind: str) -> List[str]:
            if kind == "ligand":
                pool = list(self.ligands_expr_nonlag.columns) if hasattr(self, "ligands_expr_nonlag") else list(self.custom_ligands or [])
            elif kind == "receptor":
                pool = list(self.receptors_expr.columns) if hasattr(self, "receptors_expr") else list(self.custom_receptors or [])
            else:
                pool = list(self.targets_expr.columns) if hasattr(self, "targets_expr") else list(self.custom_targets or [])
            return pool

        def _signal_source(kind: str) -> pd.DataFrame:
            """The molecule-expression frame: the model's own expression
            table when fitted (it carries complex columns the reference
            splits), else raw expression of the custom molecule list."""
            if kind == "ligand" and hasattr(self, "ligands_expr_nonlag"):
                return self.ligands_expr_nonlag.copy()
            if kind == "receptor" and hasattr(self, "receptors_expr"):
                return self.receptors_expr.copy()
            if kind == "target" and hasattr(self, "targets_expr"):
                return self.targets_expr.copy()
            return expr[[m for m in _molecule_pool(kind) if m in names]]

        signal: dict = {}
        subsets: dict = {}
        if use_ligands:
            sig_df = self._split_complex_columns(_signal_source("ligand"), expr)
            nonzero_pct = (sig_df != 0).sum() / len(sig_df) * 100
            signal["all"] = sig_df.loc[:, nonzero_pct > 1]
            subsets["all"] = self.adata
            self._cci_deg_mode = "ligand"
        elif use_receptors:
            sig_df = self._split_complex_columns(_signal_source("receptor"), expr)
            nonzero_pct = (sig_df != 0).sum() / len(sig_df) * 100
            signal["all"] = sig_df.loc[:, nonzero_pct > 1]
            subsets["all"] = self.adata
            self._cci_deg_mode = "receptor"
        elif use_pathways:
            # aggregate ligand (sender) or receptor (receiver) expression by
            # pathway membership (reference :6816-6839)
            side = "from" if sender_receiver_or_target_degs == "sender" else "to"
            mapping = self.lr_db.set_index(side)["pathway"].drop_duplicates()
            mapping = mapping[~mapping.index.duplicated()].to_dict()
            base = _signal_source("ligand" if side == "from" else "receptor")
            mapped = base.copy()
            mapped.columns = base.columns.map(mapping)
            mapped = mapped.loc[:, mapped.columns.notna()]
            signal["all"] = mapped.T.groupby(level=0).sum().T
            subsets["all"] = self.adata
            self._cci_deg_mode = "ligand" if side == "from" else "receptor"
        elif use_targets:
            signal["all"] = expr[[m for m in _molecule_pool("target") if m in names]]
            subsets["all"] = self.adata
            self._cci_deg_mode = "target"
        elif use_cell_types:
            kind = {"sender": "ligand", "receiver": "receptor", "target": "target"}[sender_receiver_or_target_degs]
            # expand complexes to their measured components
            mols: List[str] = []
            for m in _molecule_pool(kind):
                for part in str(m).split("_"):
                    if part in names and part not in mols:
                        mols.append(part)
            gk = group_key or self.group_key
            thr = getattr(self, "target_expr_threshold", 0.05)
            for cell_type in pd.unique(self.adata.obs[gk]):
                mask = np.asarray(self.adata.obs[gk] == cell_type)
                ct_expr = expr.loc[mask, [m for m in mols if m in names]]
                pct = (ct_expr != 0).sum() / max(mask.sum(), 1) * 100
                keep = [m for m in ct_expr.columns if pct[m] > thr * 100]
                if not keep:
                    continue
                signal[str(cell_type)] = expr[keep]
                subsets[str(cell_type)] = self.adata
            self._cci_deg_mode = kind
        else:
            raise ValueError(
                "All of 'use_ligands', 'use_receptors', 'use_pathways', 'use_targets' and 'use_cell_types' are "
                "False. Please set at least one to True."
            )

        self._cci_deg_by_cell_type = {}
        for subset_key, sig_df in signal.items():
            if sig_df.shape[1] == 0:
                continue
            tfs = self._select_grn_regulators(expr, sig_df, custom_tfs=custom_tfs)
            # a dependent molecule must not regress on itself
            tfs = sorted(t for t in tfs if t not in set(sig_df.columns))
            if not tfs:
                raise ValueError("No measured transcription factors found for the downstream design.")
            design = expr[tfs]
            jaccard = (sig_df.values > 0).astype(int)
            entry = {"design": design, "targets": sig_df, "X_jaccard": jaccard}
            if compute_dim_reduction:
                from ..dimensionality_reduction import find_optimal_pca_components, pca_fit

                std = np.log1p(sig_df)
                std = (std - std.mean()) / (std.std() + 1e-12)
                ncomp = find_optimal_pca_components(std.values, device=self.device)
                _, X_pca = pca_fit(std.values, n_components=ncomp, device=self.device)
                entry["X_pca"] = np.asarray(X_pca)
            if subset_key == "all":
                self._cci_deg_design = design
                self._cci_deg_targets = sig_df
                self._cci_deg_jaccard = jaccard
                if "X_pca" in entry:
                    self._cci_deg_pca = entry["X_pca"]
            else:
                self._cci_deg_by_cell_type[subset_key] = entry
            lm.main_info(
                f"CCI DEG design [{subset_key}]: {len(tfs)} TFs explaining {sig_df.shape[1]} molecules."
            )
        if "all" in signal:
            return self._cci_deg_design, self._cci_deg_targets
        return self._cci_deg_by_cell_type

    def CCI_deg_detection(
        self,
        target: Optional[str] = None,
        distr: str = "poisson",
        bw: Optional[float] = None,
        significance_threshold: float = 0.05,
        n_top: int = 25,
        fit_all: bool = False,
        cell_type: Optional[str] = None,
        use_dim_reduction: bool = False,
        **kwargs,
    ) -> pd.DataFrame:
        """Spatially-weighted GLM of molecule expression on TF expression —
        the reference's downstream-model DEG detection (reference
        MuSIC_downstream.py:7087 fits a secondary 'downstream' MuSIC; here
        the same regression runs through the batched IWLS kernel with
        bisquare spatial weights and Wald tests on the coefficients).

        Like the reference's fitted downstream model, each fit's per-cell
        coefficients, the TF design matrix, and the focal predictions are
        stored on `self.downstream_model_{ligand|receptor|target}_coeffs` /
        `_design_matrix` / `_predictions` (the attributes
        `enriched_tfs_barplot`, `summarize_tf_effects`, `deg_effect_barplot`
        and `deg_effect_heatmap(target_type=...)` consume), and predictions
        are written to `cci_deg_detection/{analysis}/downstream/
        predictions.csv` under the model's output directory (reference path
        contract, MuSIC_downstream.py:5142).

        Set `fit_all=True` to fit every dependent molecule from the setup
        (the reference always fits the whole downstream model). Returns the
        per-TF mean coefficient, standard error, Wald p/q values for the
        chosen (or first/last) dependent molecule, sorted by |coefficient|.
        """
        if cell_type is not None:
            # per-cell-type downstream model (reference :7261-7271): swap in
            # the design built by CCI_deg_detection_setup(use_cell_types=True)
            if not getattr(self, "_cci_deg_by_cell_type", None):
                self.CCI_deg_detection_setup(use_ligands=False, use_cell_types=True, **kwargs)
            if cell_type not in self._cci_deg_by_cell_type:
                raise KeyError(
                    f"`{cell_type}` has no downstream design; available: {list(self._cci_deg_by_cell_type)}"
                )
            entry = self._cci_deg_by_cell_type[cell_type]
            self._cci_deg_design = entry["design"]
            self._cci_deg_targets = entry["targets"]
            self._cci_deg_jaccard = entry["X_jaccard"]
            if "X_pca" in entry:
                self._cci_deg_pca = entry["X_pca"]
        if not hasattr(self, "_cci_deg_design"):
            self.CCI_deg_detection_setup(**kwargs)
        self._cci_deg_use_pca = bool(use_dim_reduction)
        if use_dim_reduction and not hasattr(self, "_cci_deg_pca"):
            raise ValueError(
                "`use_dim_reduction=True` requires CCI_deg_detection_setup(compute_dim_reduction=True) first."
            )
        y_df = self._cci_deg_targets
        if fit_all:
            mols = list(y_df.columns)
            if target is not None and target not in mols:
                raise KeyError(f"`{target}` not among the downstream molecules: {mols}")
        else:
            if target is None:
                target = y_df.columns[0]
            if target not in y_df.columns:
                raise KeyError(f"`{target}` not among the downstream molecules: {list(y_df.columns)}")
            mols = [target]
        out = None
        for mol in mols:
            out = self._fit_downstream_molecule(mol, distr=distr, bw=bw, significance_threshold=significance_threshold)
        self._cci_deg_results = out
        self._save_downstream_predictions()
        return out.head(n_top)

    def _fit_downstream_molecule(
        self, molecule: str, distr: str = "poisson", bw: Optional[float] = None, significance_threshold: float = 0.05
    ) -> pd.DataFrame:
        """Fit one downstream molecule ~ TFs GWR-GLM and record the fitted
        model state under the reference's attribute names."""
        y_df = self._cci_deg_targets
        if not hasattr(self, "coords"):
            self.coords = np.asarray(self.adata.obsm[self.coords_key], float)[:, :2]
            self.n_samples = self.adata.n_obs
        # the downstream model's neighbor space is signaling space, not
        # physical space: X_pca when requested, else the binary Jaccard
        # profile (reference CCI_deg_detection coords_key = "X_pca" /
        # "X_jaccard", MuSIC_downstream.py:7160)
        if getattr(self, "_cci_deg_use_pca", False) and hasattr(self, "_cci_deg_pca"):
            nbr_coords = np.asarray(self._cci_deg_pca, float)
        elif hasattr(self, "_cci_deg_jaccard"):
            nbr_coords = np.asarray(self._cci_deg_jaccard, float)
        else:
            nbr_coords = self.coords
        n = len(nbr_coords)
        Xtf = np.asarray(self._cci_deg_design.values, float)
        Xd = np.c_[np.ones(n), np.log1p(Xtf)]
        y = np.asarray(y_df[molecule].values, float)
        # reference downstream bandwidth default: 0.5% of n, adaptive (:3511)
        bw = bw if bw is not None else max(int(0.005 * n), 10)
        # a low-dimensional binary profile can be degenerate (fewer distinct
        # rows than the bandwidth -> zero kNN radius -> NaN weights); fall
        # back to physical coordinates in that case
        if nbr_coords is not self.coords:
            distinct = np.unique(nbr_coords, axis=0).shape[0]
            if distinct <= bw + 1:
                nbr_coords = self.coords
        W = self._downstream_weights(nbr_coords, bw)
        distr = distr if distr in ("gaussian", "poisson", "nb") else "poisson"
        betas, hats, inv_diag, preds = iwls_batch_full(
            y, Xd, W, distr=distr,
            ridge_lambda=getattr(self, "ridge_lambda", 0.3) or 0.3,
            clip=float(np.percentile(np.log(np.abs(y) + 1e-6), 99.7)) if distr != "gaussian" else float(np.percentile(y, 99.7)),
            device=self.device,
        )
        se = np.sqrt(np.maximum(inv_diag, 1e-12))
        mean_beta = betas[:, 1:].mean(axis=0)
        mean_se = se[:, 1:].mean(axis=0) / np.sqrt(max(n, 1))
        pv = wald_test(mean_beta, np.maximum(mean_se, 1e-8))
        qv = multitesting_correction(pv)
        out = pd.DataFrame(
            {
                "coefficient": mean_beta,
                "se": mean_se,
                "pvalue": pv,
                "qvalue": qv,
                "significant": qv < significance_threshold,
            },
            index=list(self._cci_deg_design.columns),
        )
        out = out.reindex(out["coefficient"].abs().sort_values(ascending=False).index)

        # --- record the fitted downstream model (reference attribute names)
        mode = getattr(self, "_cci_deg_mode", "target")
        obs = pd.Index(self.adata.obs_names)
        tfs = list(self._cci_deg_design.columns)
        coeff_df = pd.DataFrame(
            np.asarray(betas), index=obs, columns=["b_intercept"] + [f"b_{t}" for t in tfs]
        )
        design_df = pd.DataFrame(np.log1p(Xtf), index=obs, columns=[f"regulator_{t}" for t in tfs])
        coeffs_attr = f"downstream_model_{mode}_coeffs"
        store = getattr(self, coeffs_attr, None)
        if store is None:
            store = {}
            setattr(self, coeffs_attr, store)
        store[molecule] = coeff_df
        setattr(self, f"downstream_model_{mode}_design_matrix", design_df)
        # focal fitted means become the model's expression predictions; the
        # same clamp `predict` applies (response - 1, floored at 0) so weak
        # predictions cast to False downstream
        pred_vals = np.maximum(np.asarray(preds, float) - 1.0, 0.0) if distr != "gaussian" else np.asarray(preds, float)
        preds_attr = f"downstream_model_{mode}_predictions"
        pred_df = getattr(self, preds_attr, None)
        if pred_df is None:
            pred_df = pd.DataFrame(index=obs)
            setattr(self, preds_attr, pred_df)
        pred_df[molecule] = pred_vals
        return out

    def _downstream_weights(self, nbr_coords: np.ndarray, bw) -> torch.Tensor:
        """The downstream model's adaptive bisquare weights [n, n] on the
        device. They depend on the neighbour space and the bandwidth, not on
        the molecule, so the last ones built are kept (keyed by `bw` and a
        digest of the space) and reused by the next molecule of the design."""
        space = np.ascontiguousarray(nbr_coords, dtype=np.float32)
        key = (bw, space.shape, hashlib.sha1(space.tobytes()).hexdigest())
        cached = getattr(self, "_cci_deg_weights", None)
        if cached is None or cached[0] != key:
            W = get_wi_batch_tensor(space, bw, fixed_bw=False, exclude_self=False, kernel="bisquare", device=self.device)
            self._cci_deg_weights = cached = (key, W)
        return cached[1]

    def _save_downstream_predictions(self) -> None:
        """Persist downstream-model predictions to the reference's path:
        `{output_dir}/cci_deg_detection/{folder}/downstream/predictions.csv`
        (MuSIC_downstream.py:5142)."""
        mode = getattr(self, "_cci_deg_mode", "target")
        pred_df = getattr(self, f"downstream_model_{mode}_predictions", None)
        if pred_df is None or pred_df.empty:
            return
        folder = {"ligand": "ligand_analysis", "receptor": "receptor_analysis", "target": "target_gene_analysis"}[mode]
        out_dir = os.path.join(os.path.dirname(self.output_path) or ".", "cci_deg_detection", folder, "downstream")
        os.makedirs(out_dir, exist_ok=True)
        pred_df.to_csv(os.path.join(out_dir, "predictions.csv"))

    @staticmethod
    def intersection_ratio(df1: pd.DataFrame, df2: pd.DataFrame) -> float:
        """Jaccard-style overlap of two DEG index sets (parity: :6807)."""
        s1, s2 = set(map(str, df1.index)), set(map(str, df2.index))
        return len(s1 & s2) / max(len(s1 | s2), 1)

    _SEQUENTIAL_CMAPS = (
        "Greys Purples Blues Greens Oranges Reds YlOrBr YlOrRd OrRd PuRd RdPu BuPu GnBu PuBu YlGnBu PuBuGn "
        "BuGn YlGn binary gist_yarg gist_gray gray bone pink spring summer autumn winter cool Wistia hot "
        "afmhot gist_heat copper viridis plasma inferno magma cividis"
    ).split()

    def deg_effect_barplot(
        self,
        target: str,
        interaction_subset: Optional[List[str]] = None,
        top_n_interactions: Optional[int] = None,
        fontsize: Optional[int] = None,
        figsize=None,
        cmap: str = "Blues",
        save_show_or_return: str = "return",
        save_kwargs: Optional[dict] = None,
        **kwargs,
    ):
        """Proportion of `target`-expressing cells predicted to be affected
        by each regulator (reference semantics, MuSIC_downstream.py:7310).
        The target is looked up across the upstream model and all three
        fitted downstream models (ligand -> receptor -> target-gene order,
        :7394-7414); proportions are the fraction of expressing cells with
        a nonzero coefficient, sorted descending. Requires a sequential
        colormap. Returns the Series for "return"; "axes" returns
        (fig, ax, series)."""
        import matplotlib as mpl

        if cmap not in self._SEQUENTIAL_CMAPS and cmap not in [f"{c}_r" for c in self._SEQUENTIAL_CMAPS]:
            raise ValueError(f"Colormap {cmap} is not a sequential colormap.")
        all_coeffs = feature_names = None
        if getattr(self, "coeffs", None) and target in self.coeffs:
            all_coeffs = self.coeffs[target]
            dm = getattr(self, "X_df", None)
            feature_names = list(dm.columns) if dm is not None else None
        else:
            for attr in ("ligand", "receptor", "target"):
                store = getattr(self, f"downstream_model_{attr}_coeffs", None)
                if store and target in store:
                    all_coeffs = store[target]
                    dm = getattr(self, f"downstream_model_{attr}_design_matrix", None)
                    feature_names = [c.replace("regulator_", "") for c in dm.columns] if dm is not None else None
                    break
        if all_coeffs is None:
            raise ValueError(f"Information for target {target} not found. {target} may not have been a model target.")
        effects = all_coeffs.copy()
        effects.columns = [c.replace("b_", "") for c in effects.columns]
        if feature_names is None:
            feature_names = [c for c in effects.columns if "intercept" not in c]
        if interaction_subset is not None:
            feature_names = [f for f in feature_names if f in set(np.atleast_1d(interaction_subset))]
        feature_names = [f for f in feature_names if f in effects.columns and "intercept" not in f]
        effects = effects[feature_names]
        from scipy.sparse import issparse

        names = list(map(str, self.adata.var_names))
        if target in names:
            col = self.adata[:, target].X
            expr = (col.toarray() if issparse(col) else np.asarray(col)).reshape(-1) > 0
            rows = pd.Index(self.adata.obs_names)[expr].intersection(effects.index)
        else:
            rows = effects.index
        proportions = (effects.loc[rows] != 0).mean() if len(rows) else pd.Series(0.0, index=effects.columns)
        proportions = proportions.sort_values(ascending=False)
        if top_n_interactions is not None:
            proportions = proportions.iloc[:top_n_interactions]
        if save_show_or_return == "return":
            return proportions
        import matplotlib.pyplot as plt

        fontsize = fontsize or float(mpl.rcParams.get("font.size", 10))
        fig, ax = plt.subplots(figsize=figsize or (max(len(proportions) / 2, 3), 4))
        cm = mpl.colormaps[cmap]
        colors = [cm(0.3 + 0.7 * i / max(len(proportions) - 1, 1)) for i in range(len(proportions))][::-1]
        ax.bar(range(len(proportions)), proportions.values, color=colors, edgecolor="black")
        ax.set_xticks(range(len(proportions)))
        ax.set_xticklabels(proportions.index, rotation=90, fontsize=fontsize)
        ax.set_xlabel("Transcription factor", fontsize=fontsize * 1.1)
        ax.set_ylabel("Proportion", fontsize=fontsize * 1.1)
        ax.set_title(
            f"Proportion of cells expressing {target} predicted \nto be affected by transcription factors",
            fontsize=fontsize * 1.25,
        )
        if save_show_or_return in ("axes", "all"):
            return fig, ax, proportions
        return ax

    def deg_effect_heatmap(
        self,
        target_subset: Optional[List[str]] = None,
        target_type: str = "target_gene",
        to_plot: str = "proportion",
        interaction_subset: Optional[List[str]] = None,
        fontsize: Optional[int] = None,
        figsize=None,
        cmap: str = "magma",
        lower_proportion_threshold: float = 0.1,
        order_interactions: bool = False,
        order_targets: bool = False,
        remove_rows_and_cols_threshold: Optional[int] = None,
        save_show_or_return: str = "return",
        save_kwargs: Optional[dict] = None,
        save_df: bool = False,
        **kwargs,
    ):
        """Interactions x targets heatmap of predicted-effect coverage
        (reference semantics, MuSIC_downstream.py:7472). "proportion" =
        fraction of target-expressing cells with a nonzero coefficient for
        the interaction; "specificity" = fraction of the cells where the
        interaction feature is active (design-matrix value > 0) whose
        coefficient on the target is nonzero. `target_type` selects the
        upstream target-gene models ("target_gene") or the downstream
        ligand/receptor/TF-target models fitted by CCI_deg_detection.
        Collagen/HLA family collapsing on the interaction axis, optional
        ward ordering of rows/columns, sparse-row/column pruning via
        `remove_rows_and_cols_threshold`, and values below
        `lower_proportion_threshold` masked white in the figure. Returns
        the DataFrame for "return"; "axes" composes the masked heatmap
        with top colorbar and returns (fig, ax, df)."""
        from scipy.sparse import issparse

        if to_plot not in ("proportion", "specificity"):
            raise ValueError(f"Unrecognized input for to_plot: {to_plot}. Options: 'proportion', 'specificity'.")
        if target_type == "ligand":
            all_coeffs = getattr(self, "downstream_model_ligand_coeffs", None)
            dm = getattr(self, "downstream_model_ligand_design_matrix", None)
        elif target_type == "receptor":
            all_coeffs = getattr(self, "downstream_model_receptor_coeffs", None)
            dm = getattr(self, "downstream_model_receptor_design_matrix", None)
        elif target_type == "tf_target":
            all_coeffs = getattr(self, "downstream_model_target_coeffs", None)
            dm = getattr(self, "downstream_model_target_design_matrix", None)
        elif target_type == "target_gene":
            if not getattr(self, "coeffs", None):
                self.load_coeffs()
            all_coeffs = self.coeffs
            dm = getattr(self, "X_df", None)
        else:
            raise ValueError(
                f"Target type {target_type} not recognized. Must be one of 'ligand', 'receptor', 'target_gene', 'tf_target'."
            )
        if not all_coeffs:
            raise ValueError(f"No fitted coefficients found for target_type '{target_type}'.")
        if target_subset is not None:
            all_coeffs = {k: v for k, v in all_coeffs.items() if k in set(np.atleast_1d(target_subset))}
        names = list(map(str, self.adata.var_names))
        values = pd.DataFrame()
        for target, cdf in all_coeffs.items():
            eff = cdf.copy()
            eff.columns = [c.replace("b_", "") for c in eff.columns]
            feats = [c for c in eff.columns if "intercept" not in c]
            if interaction_subset is not None:
                feats = [f for f in feats if f in set(np.atleast_1d(interaction_subset))]
            if to_plot == "proportion":
                if target in names:
                    col = self.adata[:, target].X
                    expr = (col.toarray() if issparse(col) else np.asarray(col)).reshape(-1) > 0
                    rows = pd.Index(self.adata.obs_names)[expr].intersection(eff.index)
                else:
                    rows = eff.index
                for f in feats:
                    values.loc[f, target] = float((eff.loc[rows, f] != 0).mean()) if len(rows) else 0.0
            else:
                if dm is None:
                    raise ValueError("specificity mode requires the design matrix (X_df / downstream design matrix).")
                for f in feats:
                    dcol = f"regulator_{f}" if f"regulator_{f}" in dm.columns else (f if f in dm.columns else None)
                    if dcol is None:
                        values.loc[f, target] = 0.0
                        continue
                    active = dm.index[np.asarray(dm[dcol].values, float) > 0]
                    active = pd.Index(active).intersection(eff.index)
                    values.loc[f, target] = float((eff.loc[active, f] != 0).mean()) if len(active) else 0.0
        values.index = [replace_hla_with_hlas(replace_col_with_collagens(f)) for f in values.index]
        values = values.fillna(0.0)
        if order_interactions and len(values) > 1:
            from scipy.cluster.hierarchy import leaves_list, linkage
            from scipy.spatial.distance import pdist

            values = values.iloc[leaves_list(linkage(pdist(values.values), method="ward"))]
        if order_targets and values.shape[1] > 1:
            from scipy.cluster.hierarchy import leaves_list, linkage
            from scipy.spatial.distance import pdist

            order = leaves_list(linkage(pdist(values.T.values), method="ward"))
            values = values.T.iloc[order].T
        if remove_rows_and_cols_threshold is not None:
            keep_r = (values > lower_proportion_threshold).sum(axis=1) >= remove_rows_and_cols_threshold
            keep_c = (values > lower_proportion_threshold).sum(axis=0) >= remove_rows_and_cols_threshold
            values = values.loc[keep_r, keep_c]
        if save_df:
            out_folder = os.path.join(os.path.dirname(self.output_path) or ".", "analyses")
            os.makedirs(out_folder, exist_ok=True)
            adata_id = os.path.splitext(os.path.basename(getattr(self, "adata_path", None) or "adata"))[0]
            values.to_csv(os.path.join(out_folder, f"heatmap_{adata_id}_proportion_affected_by_interaction.csv"))
        if save_show_or_return == "return":
            return values
        import matplotlib as mpl
        import matplotlib.pyplot as plt
        from mpl_toolkits.axes_grid1 import make_axes_locatable

        fontsize = fontsize or float(mpl.rcParams.get("font.size", 10))
        figsize = figsize or (max(values.shape[1] * 0.35, 4), max(values.shape[0] * 0.35, 4))
        fig, ax = plt.subplots(figsize=figsize)
        data = np.ma.masked_where(np.abs(values.values) < lower_proportion_threshold, values.values)
        cm = mpl.colormaps[cmap].copy(); cm.set_bad(color="white")
        im = ax.pcolormesh(
            data[::-1], cmap=cm, vmin=0, vmax=float(values.values.max()) or 1.0,
            edgecolors="grey", linewidth=0.5 * figsize[0] / 10,
        )
        ax.set_xticks(np.arange(values.shape[1]) + 0.5); ax.set_xticklabels(values.columns, rotation=90, fontsize=fontsize)
        ax.set_yticks(np.arange(values.shape[0]) + 0.5); ax.set_yticklabels(values.index[::-1], fontsize=fontsize)
        divider = make_axes_locatable(ax)
        cax = divider.append_axes("top", size="30%", pad=0.3)
        cbar = fig.colorbar(im, cax=cax, orientation="horizontal")
        cbar.set_label(to_plot.title(), fontsize=fontsize * 1.5, labelpad=10)
        cbar.ax.xaxis.set_ticks_position("top"); cbar.ax.xaxis.set_label_position("top")
        x_label = {"ligand": "Ligand", "receptor": "Receptor"}.get(target_type, "Target Gene")
        idname = "L:R interaction" if target_type == "target_gene" else "TF"
        ax.set_xlabel(x_label, fontsize=fontsize * 2)
        ax.set_ylabel("L:R interaction" if target_type == "target_gene" else "Transcription factor", fontsize=fontsize * 2)
        title = (
            f"Proportion of target-expressing cells \naffected by each {idname}"
            if to_plot == "proportion"
            else f"Specificity of each {idname}"
        )
        ax.set_title(title, fontsize=fontsize * 2, pad=20)
        if save_show_or_return in ("axes", "all"):
            return fig, ax, values
        return ax

    def top_target_barplot(
        self,
        interaction: str,
        target_subset: Optional[List[str]] = None,
        use_ligand_targets: bool = False,
        use_receptor_targets: bool = False,
        use_target_gene_targets: bool = True,
        top_n_targets: Optional[int] = None,
        n_top: Optional[int] = None,
        fontsize: Optional[int] = None,
        figsize=None,
        cmap: str = "Blues",
        save_show_or_return: str = "return",
        save_kwargs: Optional[dict] = None,
        **kwargs,
    ):
        """Proportion of cells expressing each target that are predicted to
        be affected by `interaction` (reference semantics,
        MuSIC_downstream.py:7769: per target, the fraction of
        target-expressing cells whose b_{interaction} coefficient is
        nonzero, sorted descending). `use_ligand_targets` /
        `use_receptor_targets` select the downstream ligand/receptor models
        fitted by CCI_deg_detection (stored as
        `downstream_model_{ligand,receptor}_coeffs`); the default targets
        the upstream target-gene models. Requires a sequential colormap, as
        the reference does. Returns the Series for "return", (fig, ax,
        Series) for "axes"."""
        import matplotlib as mpl
        import matplotlib.pyplot as plt
        from scipy.sparse import issparse

        top_n_targets = top_n_targets if top_n_targets is not None else n_top
        fontsize = fontsize or float(mpl.rcParams.get("font.size", 10))
        try:
            mpl.colormaps[cmap]
        except KeyError:
            raise ValueError(f"Colormap {cmap} is not a valid colormap.")
        if cmap.replace("_r", "") in {"seismic", "coolwarm", "bwr", "RdBu", "PiYG", "PRGn", "Spectral", "tab10", "tab20"}:
            raise ValueError(f"Colormap {cmap} is not a sequential colormap.")
        if use_ligand_targets:
            all_coeffs = getattr(self, "downstream_model_ligand_coeffs", None)
        elif use_receptor_targets:
            all_coeffs = getattr(self, "downstream_model_receptor_coeffs", None)
        else:
            if not getattr(self, "coeffs", None):
                self.load_coeffs()
            all_coeffs = self.coeffs
        if not all_coeffs:
            raise ValueError("No fitted coefficient tables available for the chosen target family.")
        if target_subset is not None:
            all_coeffs = {k: v for k, v in all_coeffs.items() if k in set(np.atleast_1d(target_subset))}
        found = any(
            interaction in {c.replace("b_", "") for c in df.columns} for df in all_coeffs.values()
        )
        if not found:
            raise KeyError(f"interaction `{interaction}` not among fitted features")
        names = list(map(str, self.adata.var_names))
        prop_effects = {}
        for target, df in all_coeffs.items():
            feats = [f.replace("b_", "") for f in df.columns]
            if interaction not in feats:
                continue
            if target in names:
                col = self.adata[:, target].X
                expr = (col.toarray() if issparse(col) else np.asarray(col)).reshape(-1) > 0
                nz = pd.Index(self.adata.obs_names)[expr].intersection(df.index)
            else:
                nz = df.index
            prop_effects[target] = float((df.loc[nz, f"b_{interaction}"] != 0).mean()) if len(nz) else 0.0
        prop_effects = pd.Series(prop_effects).sort_values(ascending=False)
        if top_n_targets is not None:
            prop_effects = prop_effects.iloc[:top_n_targets]
        if save_show_or_return == "return":
            return prop_effects
        fig, ax = plt.subplots(figsize=figsize or (max(len(prop_effects) / 2, 3), 4))
        cm = mpl.colormaps[cmap]
        colors = [cm(0.3 + 0.7 * i / max(len(prop_effects) - 1, 1)) for i in range(len(prop_effects))][::-1]
        ax.bar(range(len(prop_effects)), prop_effects.values, color=colors, edgecolor="black", linewidth=1)
        ax.set_xticks(range(len(prop_effects)))
        ax.set_xticklabels(prop_effects.index, rotation=90, fontsize=fontsize)
        ax.set_xlabel("Target Gene", fontsize=fontsize * 1.1)
        ax.set_ylabel("Proportion", fontsize=fontsize * 1.1)
        ax.set_title(f"Proportion of cells expressing target \naffected by {interaction}", fontsize=fontsize * 1.25)
        if save_show_or_return in ("axes", "all"):
            return fig, ax, prop_effects
        return ax

    def eval_permutation_test(self, gene_or_df, alpha: float = 0.05) -> pd.DataFrame:
        """Evaluate a permutation test (reference semantics,
        MuSIC_downstream.py:8080). Given a gene name, compares true and
        predicted expression for the nonpermuted fit and every permutation
        cached by `permutation_test`: Pearson / Spearman / F1 / AUROC /
        RMSE over all cells and over the expressing subset (all-cell
        metrics omitted when only nonzeros were permuted, as the reference
        does), then one-sample t-tests of each permuted-metric column
        against the nonpermuted value, appending t-statistic / p-value /
        significant rows. A DataFrame input keeps the legacy effect-size
        summary (significance at `alpha`)."""
        if isinstance(gene_or_df, pd.DataFrame):
            out = gene_or_df.copy()
            out["significant"] = out["perm_pvalue"] < alpha
            return out.sort_values("perm_pvalue")
        gene = str(gene_or_df)
        preds = getattr(self, "_perm_predictions", {}).get(gene)
        truth = getattr(self, "_perm_truth", {}).get(gene)
        if preds is None or truth is None:
            raise ValueError(f"run permutation_test('{gene}') before eval_permutation_test")
        from scipy.stats import pearsonr, spearmanr, ttest_1samp

        def f1(yb, pb):
            tp = np.sum(yb & pb)
            prec = tp / max(np.sum(pb), 1)
            rec = tp / max(np.sum(yb), 1)
            return 2 * prec * rec / max(prec + rec, 1e-12)

        def auroc(yb, score):
            pos, neg = score[yb], score[~yb]
            if len(pos) == 0 or len(neg) == 0:
                return np.nan
            # Mann-Whitney formulation of AUROC
            order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
            ranks = np.empty(len(order)); ranks[order] = np.arange(1, len(order) + 1)
            return (ranks[: len(pos)].sum() - len(pos) * (len(pos) + 1) / 2) / (len(pos) * len(neg))

        def corr(f, a, b):
            if len(a) < 2 or np.std(a) == 0 or np.std(b) == 0:
                return 0.0
            return float(f(a, b)[0])

        nonzeros_only = bool(getattr(self, "permuted_nonzeros_only", False))
        rows = {}
        for col in preds.columns:
            y = np.asarray(truth[col].values, float)
            p = np.asarray(preds[col].values, float)
            yb, pb = y > 0, p > 0
            nz = y != 0
            r = {
                "Pearson correlation (expressing subset)": corr(pearsonr, y[nz], p[nz]),
                "Spearman correlation (expressing subset)": corr(spearmanr, y[nz], p[nz]),
                "F1 score (expressing subset)": f1(yb[nz], pb[nz]),
                "AUROC (expressing subset)": auroc(yb[nz], p[nz]),
                "RMSE (expressing subset)": float(np.sqrt(((y[nz] - p[nz]) ** 2).mean())) if nz.any() else 0.0,
            }
            if not nonzeros_only:
                r.update({
                    "Pearson correlation": corr(pearsonr, y, p),
                    "Spearman correlation": corr(spearmanr, y, p),
                    "F1 score": f1(yb, pb),
                    "AUROC": auroc(yb, p),
                    "RMSE": float(np.sqrt(((y - p) ** 2).mean())),
                })
            rows[col] = r
        results = pd.DataFrame(rows).T
        permuted = results.loc[[r for r in results.index if r != "nonpermuted"]]
        nonperm = results.loc["nonpermuted"]
        t_statistics, pvals, significance = {}, {}, {}
        for col in permuted.columns:
            data = permuted[col].dropna()
            if len(data) < 2 or np.isnan(nonperm[col]):
                t_statistics[col], pvals[col], significance[col] = np.nan, np.nan, "no"
                continue
            t_stat, pval = ttest_1samp(data, nonperm[col])
            t_statistics[col], pvals[col] = float(t_stat), float(pval)
            significance[col] = "yes" if pval < 0.05 else "no"
        results.loc["t-statistic"] = t_statistics
        results.loc["p-value"] = pvals
        results.loc["significant"] = significance
        return results


def replace_col_with_collagens(col: str) -> str:
    """Collapse individual collagen gene names to the 'Collagens' family
    label in a feature name (parity: reference MuSIC_downstream.py
    replace_col_with_collagens)."""
    parts = col.split(":")
    out = []
    for p in parts:
        subs = p.split("/")
        subs = ["Collagens" if s.upper().startswith("COL") else s for s in subs]
        dedup = list(dict.fromkeys(subs))
        out.append("/".join(dedup))
    return ":".join(out)


def replace_hla_with_hlas(col: str) -> str:
    """Collapse individual HLA gene names to the 'HLAs' family label
    (parity: reference MuSIC_downstream.py replace_hla_with_hlas)."""
    parts = col.split(":")
    out = []
    for p in parts:
        subs = p.split("/")
        subs = ["HLAs" if s.upper().startswith("HLA") else s for s in subs]
        dedup = list(dict.fromkeys(subs))
        out.append("/".join(dedup))
    return ":".join(out)
