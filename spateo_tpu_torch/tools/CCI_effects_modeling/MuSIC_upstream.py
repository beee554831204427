"""Target/ligand/receptor selection for MuSIC models (counterpart of
`spateo_tpu.tools.CCI_effects_modeling.MuSIC_upstream`; reference
spateo/tools/CCI_effects_modeling/MuSIC_upstream.py:21
`MuSIC_Molecule_Selector.find_targets`:95). Host pandas around the port's
`MuSIC`, whose `define_sig_inputs` builds the spatial weights on its
``device``."""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

import numpy as np
import pandas as pd
from scipy.sparse import issparse

from ...logging import logger_manager as lm
from .MuSIC import MuSIC

# Housekeeping / essential-gene prefixes excluded from target search
# (reference MuSIC_upstream.py:267-368 — a constant screening table:
# actins, tubulins, ribosomal subunits, glycolysis/TCA enzymes, histones,
# heat-shock proteins, elongation/initiation factors, mitochondrial genes,
# and other ubiquitously-expressed machinery).
_HOUSEKEEPING_PREFIXES = [
    "ACT", "TUB", "RPL", "RPS", "UB", "GAPDH", "HK", "PFK", "PLK", "CS",
    "ACO", "IDH", "SDH", "OGD", "FH", "MDH", "ACA", "FAS", "CPT", "GLU",
    "GOT", "SHMT", "RRM", "DHF", "SNR", "HNRN", "LDHA", "HSP", "H2", "H3",
    "H4", "HMGB", "EEF", "EIF", "ATP", "COX", "RAN", "GNAI", "MALAT",
    "PPIA", "MT-", "YWH", "ELO", "PTM", "TMS", "MARCK", "NEDD", "FAU",
]


def _species_prefixes(species: str) -> List[str]:
    if species == "mouse":
        # mouse symbols are capitalized-lowercase; MT- becomes mt-
        return [("mt-" if p == "MT-" else p.capitalize()) for p in _HOUSEKEEPING_PREFIXES]
    return _HOUSEKEEPING_PREFIXES


class MuSIC_Molecule_Selector(MuSIC):
    """Select initial targets/predictors for intercellular analyses
    (parity surface: reference MuSIC_upstream.py:21)."""

    def __init__(self, parser=None, args_list: Optional[List[str]] = None, **kwargs):
        super().__init__(parser=parser, args_list=args_list, verbose=False, **kwargs)
        if getattr(self, "adata", None) is not None or self.adata_path is not None:
            self.load_and_process(upstream=True)

    def find_targets(
        self,
        save_id: Optional[str] = None,
        bw_membrane_bound: float = 8,
        bw_secreted: float = 25,
        kernel: str = "bisquare",
        **kwargs,
    ) -> pd.DataFrame:
        """Find candidate targets, ligands and receptors (parity: reference
        MuSIC_upstream.py:95 `find_targets`):

        1. receptors = custom list or every database receptor whose
           components are all measured; ligands = custom list or the
           cognate ligands of those receptors;
        2. build (or load) the signaling design matrix with those
           ligands/receptors;
        3. candidate targets = genes expressed in at least
           `target_expr_threshold` of the cells predicted to participate in
           an interaction (nonzero design row), minus housekeeping genes
           and the receptors themselves;
        4. write ligands/receptors/targets .txt selections.
        """
        if not hasattr(self, "coords"):
            self.load_and_process(upstream=True)
        if self.mod_type not in ("receptor", "lr"):
            raise ValueError(
                "Unsupervised target finding can only be done using receptor and ligand/receptor-based models."
            )
        self._load_db()
        lig_id = f"ligands_{save_id}" if save_id else "ligands"
        rec_id = f"receptors_{save_id}" if save_id else "receptors"
        targets_id = f"targets_{save_id}" if save_id else "targets"
        out_dir = os.path.splitext(self.output_path)[0]
        Path(out_dir).mkdir(parents=True, exist_ok=True)

        var_names = set(map(str, self.adata.var_names))
        X = self.adata.X.toarray() if issparse(self.adata.X) else np.asarray(self.adata.X, dtype=float)
        expressed = X.sum(axis=0) > 0
        expressed_names = set(np.asarray(self.adata.var_names)[expressed])

        if self.custom_receptors is None:
            receptors = sorted(
                {
                    r
                    for r in set(self.lr_db["to"])
                    if all(part in expressed_names for part in str(r).split("_"))
                }
            )
        else:
            receptors = list(self.custom_receptors)
        if self.custom_ligands is None:
            cognate = set(self.lr_db[self.lr_db["to"].isin(receptors)]["from"])
            ligands = sorted({l for l in cognate if all(p in var_names for p in str(l).split("_"))})
        else:
            ligands = list(self.custom_ligands)
        if not receptors:
            raise ValueError("No measured receptors found in the L:R database.")

        for name, items in ((lig_id, ligands), (rec_id, receptors)):
            with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
                f.write("\n".join(map(str, items)))

        # design matrix: load the checkpoint or build it with these
        # ligands/receptors (the reference spins up a second MuSIC from
        # paths; in-memory construction does the same work directly)
        dm_path = os.path.join(out_dir, "design_matrix", "design_matrix.csv")
        if os.path.exists(dm_path):
            X_df = pd.read_csv(dm_path, index_col=0)
            lm.main_info("Loaded existing design matrix.")
        else:
            self.custom_ligands = [l for l in ligands]
            self.custom_receptors = [r for r in receptors]
            self.custom_targets = [str(receptors[0])]  # placeholder target, per reference :228
            self.distance_membrane_bound = kwargs.get("distance_membrane_bound", self.distance_membrane_bound)
            self.distance_secreted = kwargs.get("distance_secreted", self.distance_secreted)
            self.n_neighbors_membrane_bound = int(bw_membrane_bound)
            self.n_neighbors_secreted = int(bw_secreted)
            self.kernel = kernel
            X_df = self.define_sig_inputs()

        # genes expressed in >= threshold of interaction-predicted cells
        feature_cols = [c for c in X_df.columns if c != "intercept"]
        interacting = np.asarray((X_df[feature_cols] != 0).any(axis=1))
        n_int = int(interacting.sum())
        threshold_n = int(self.target_expr_threshold * max(n_int, 1))
        lm.main_info(f"Finding genes expressed in at least {threshold_n} of {n_int} interacting cells.")
        sub = X[interacting]
        genes_expressed = np.count_nonzero(sub, axis=0) >= threshold_n

        genes = np.asarray(self.adata.var_names)[genes_expressed]
        prefixes = _species_prefixes(self.species)
        mask = ~pd.Index(genes).str.contains("|".join(prefixes))
        genes = genes[mask]
        rec_parts = {p for r in receptors for p in str(r).split("_")}
        genes = [g for g in genes if g not in rec_parts and g not in set(receptors)]
        lm.main_info(f"Size of final set of candidate targets: {len(genes)}")

        with open(os.path.join(out_dir, f"{targets_id}.txt"), "w") as f:
            f.write("\n".join(map(str, genes)))

        self.targets = list(genes)
        self.ligands = list(ligands)
        self.receptors = list(receptors)
        self.selection = pd.DataFrame(
            {
                "gene": list(genes) + list(ligands) + list(receptors),
                "role": ["target"] * len(genes) + ["ligand"] * len(ligands) + ["receptor"] * len(receptors),
            }
        )
        lm.main_info(f"Selected {len(genes)} targets, {len(ligands)} ligands, {len(receptors)} receptors.")
        return self.selection
