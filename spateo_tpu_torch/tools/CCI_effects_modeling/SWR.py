"""MuSIC flag system — an argparse parser that doubles as CLI and programmatic
config (capability parity: reference spateo/tools/CCI_effects_modeling/SWR.py:17,
parser construction :496-830).

A copy of `spateo_tpu.tools.CCI_effects_modeling.SWR`: the same flags, so a
parser built here configures the port's `MuSIC` as it does the JAX one."""

from __future__ import annotations

import argparse
from typing import Optional, Tuple


def define_spateo_argparse(**kwargs) -> Tuple[argparse.ArgumentParser, list]:
    """Build the MuSIC argument parser.

    Any keyword argument matching a flag name is converted into an args-list
    entry, so the same function serves programmatic configuration:

        parser, args_list = define_spateo_argparse(adata_path="a.h5ad",
                                                   mod_type="lr")
        model = MuSIC(parser, args_list)
    """
    parser = argparse.ArgumentParser(description="Spatially-weighted regression (MuSIC)")
    add = parser.add_argument
    add("-np", "--n_processes", default=1, type=int, help="number of processes (compat; device-parallel here)")
    add("-run_upstream", action="store_true")
    add("-adata_path", type=str)
    add("-csv_path", type=str)
    add("-n_spatial_dim_csv", default=2, type=int)
    add("-spatial_subsample", action="store_true")
    add("-mod_type", type=str, default="niche", choices=["niche", "lr", "ligand", "receptor", "downstream"])
    add("-include_unpaired_lr", action="store_true")
    add("-cci_dir", type=str)
    add("-species", type=str, default="human")
    add("-output_path", default="./output/stgwr_results.csv", type=str)
    add("-custom_lig_path", type=str)
    add("-ligand", nargs="+", type=str, dest="custom_ligands")
    add("-custom_rec_path", type=str)
    add("-receptor", nargs="+", type=str, dest="custom_receptors")
    add("-custom_pathways_path", type=str)
    add("-pathway", nargs="+", type=str, dest="custom_pathways")
    add("-targets_path", type=str)
    add("-target", nargs="+", type=str, dest="custom_targets")
    add("-init_betas_path", type=str)
    add("-normalize", action="store_true")
    add("-smooth", action="store_true")
    add("-log_transform", action="store_true")
    add("-normalize_signaling", action="store_true")
    add("-target_expr_threshold", default=0.05, type=float)
    add("-multicollinear_threshold", type=float)
    add("-coords_key", default="spatial", type=str)
    add("-group_key", default="cell_type", type=str)
    add("-group_subset", nargs="+", type=str)
    add("-covariate_keys", nargs="+", type=str)
    add("-total_counts_key", default="total_counts", type=str)
    add("-total_counts_threshold", default=0.0, type=float)
    add("-bw", type=float)
    add("-minbw", type=float)
    add("-maxbw", type=float)
    add("-bw_fixed", action="store_true")
    add("-exclude_self", action="store_true")
    add("-kernel", default="bisquare", type=str)
    add("-distance_membrane_bound", type=float)
    add("-distance_secreted", type=float)
    add("-n_neighbors_membrane_bound", default=8, type=int)
    add("-n_neighbors_secreted", default=25, type=int)
    add("-n_neighbors", default=10, type=int)
    add("-use_expression_neighbors", action="store_true")
    add("-distr", default="gaussian", type=str, choices=["gaussian", "poisson", "nb"])
    add("-fit_intercept", action="store_true")
    add("-no_hurdle", action="store_true")
    add("-tolerance", default=1e-3, type=float)
    add("-max_iter", default=500, type=int)
    add("-patience", default=5, type=int)
    add("-ridge_lambda", default=0.3, type=float)
    add("-subsample", action="store_true")
    add("-subsample_size", default=5000, type=int)
    add("-seed", default=888, type=int)
    # downstream-analysis flags
    add("-filter_targets", action="store_true")
    add("-filter_target_threshold", default=0.65, type=float)
    add("-ligand_for_downstream", type=str)
    add("-receptor_for_downstream", type=str)
    add("-pathway_for_downstream", type=str)
    add("-target_for_downstream", nargs="+", type=str)
    add("-sender_ct_for_downstream", type=str)
    add("-receiver_ct_for_downstream", type=str)
    add("-n_components", default=20, type=int)
    add("-cci_degs_model_interactions", action="store_true")
    add("-no_cell_type_markers", action="store_true")
    add("-compute_pathway_effect", action="store_true")
    add("-diff_sending_or_receiving", default="sending", type=str)

    # kwargs -> args list
    args_list = []
    store_true_flags = {
        a.dest for a in parser._actions if isinstance(a, argparse._StoreTrueAction)
    }
    dest_to_flag = {}
    for a in parser._actions:
        if a.option_strings:
            dest_to_flag[a.dest] = a.option_strings[0]
    for key, value in kwargs.items():
        flag = dest_to_flag.get(key, f"-{key}")
        if key in store_true_flags:
            if value:
                args_list.append(flag)
        elif isinstance(value, (list, tuple)):
            args_list.append(flag)
            args_list.extend(str(v) for v in value)
        elif value is not None:
            args_list.extend([flag, str(value)])
    return parser, args_list
