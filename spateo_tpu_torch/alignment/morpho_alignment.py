"""Serial-slice Morpho alignment entry points: host-side loops over
`Morpho_pairwise` (counterpart of `spateo_tpu.alignment.morpho_alignment`;
reference spateo/alignment/morpho_alignment.py:22-470). `device` is passed
on to every pairwise solve and field evaluation."""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from ..core.anndata import AnnData, read_h5ad
from .methods.morpho import Morpho_pairwise
from .transform import BA_transform
from .utils import _iteration, downsampling, solve_RT_by_correspondence


def morpho_align(
    models: List[AnnData],
    rep_layer: Union[str, List[str]] = "X",
    rep_field: Union[str, List[str]] = "layer",
    genes: Optional[List[str]] = None,
    spatial_key: str = "spatial",
    key_added: str = "align_spatial",
    iter_key_added: Optional[str] = "iter_spatial",
    vecfld_key_added: str = "VecFld_morpho",
    mode: str = "SN-S",
    dissimilarity: Union[str, List[str]] = "kl",
    max_iter: int = 200,
    dtype: str = "float32",
    device: str = "cuda",
    verbose: bool = True,
    **kwargs,
) -> Tuple[List[AnnData], list]:
    """Continuous serial-slice alignment (parity: reference
    morpho_alignment.py:22). Mode 'SN-S' returns the rigid result (the
    non-rigid fit refines the mapping); 'SN-N' returns the non-rigid one.
    The returned assignments are device tensors [B, NA] (P transposed)."""
    align_models = [model.copy() for model in models]
    for m in align_models:
        m.obsm[key_added] = np.asarray(m.obsm[spatial_key]).copy()
        m.obsm[f"{key_added}_rigid"] = np.asarray(m.obsm[spatial_key]).copy()
        m.obsm[f"{key_added}_nonrigid"] = np.asarray(m.obsm[spatial_key]).copy()

    pis = []
    progress_name = f"Models alignment based on morpho, mode: {mode}."
    for i in _iteration(n=len(align_models) - 1, progress_name=progress_name, verbose=verbose):
        modelA = align_models[i]
        modelB = align_models[i + 1]
        morpho_model = Morpho_pairwise(
            sampleA=modelB,  # reverse: B is aligned onto A
            sampleB=modelA,
            rep_layer=rep_layer,
            rep_field=rep_field,
            dissimilarity=dissimilarity,
            genes=genes,
            spatial_key=key_added,
            key_added=key_added,
            iter_key_added=iter_key_added,
            vecfld_key_added=vecfld_key_added,
            max_iter=max_iter,
            device=device,
            verbose=verbose,
            **kwargs,
        )
        P = morpho_model.run()
        modelB.obsm[f"{key_added}_rigid"] = morpho_model.optimal_RnA.copy()
        modelB.obsm[f"{key_added}_nonrigid"] = morpho_model.XAHat.copy()
        if mode == "SN-S":
            modelB.obsm[key_added] = modelB.obsm[f"{key_added}_rigid"]
        elif mode == "SN-N":
            modelB.obsm[key_added] = modelB.obsm[f"{key_added}_nonrigid"]
        if vecfld_key_added is not None:
            modelB.uns[vecfld_key_added] = morpho_model.vecfld
        pis.append(P.T)
    return align_models, pis


def morpho_align_ref(
    models: List[AnnData],
    models_ref: Optional[List[AnnData]] = None,
    n_sampling: int = 2000,
    sampling_method: str = "random",
    rep_layer: Union[str, List[str]] = "X",
    rep_field: Union[str, List[str]] = "layer",
    genes: Optional[List[str]] = None,
    spatial_key: str = "spatial",
    key_added: str = "align_spatial",
    iter_key_added: Optional[str] = "iter_spatial",
    vecfld_key_added: str = "VecFld_morpho",
    mode: str = "SN-S",
    dissimilarity: Union[str, List[str]] = "kl",
    max_iter: int = 200,
    dtype: str = "float32",
    device: str = "cuda",
    verbose: bool = True,
    **kwargs,
) -> Tuple[List[AnnData], List[AnnData], list, list]:
    """Align downsampled reference slices, then warp the full slices with the
    learned field through `BA_transform` (parity: reference
    morpho_alignment.py:318). Returns (aligned models, aligned reference
    models, assignments, reference assignments); the assignments are device
    tensors [NA_ref, B] as `Morpho_pairwise.run` returns them."""
    if models_ref is None:
        models_sampling = [model.copy() for model in models]
        models_ref = downsampling(
            models=models_sampling, n_sampling=n_sampling, sampling_method=sampling_method, spatial_key=spatial_key,
            device=device,
        )

    pis, pis_ref = [], []
    align_models = [model.copy() for model in models]
    align_models_ref = [model.copy() for model in models_ref]
    for group in (align_models, align_models_ref):
        for model in group:
            model.obsm[key_added] = np.asarray(model.obsm[spatial_key]).copy()
            model.obsm[f"{key_added}_rigid"] = np.asarray(model.obsm[spatial_key]).copy()
            model.obsm[f"{key_added}_nonrigid"] = np.asarray(model.obsm[spatial_key]).copy()

    progress_name = f"Models alignment with ref-models based on morpho, mode: {mode}."
    for i in _iteration(n=len(align_models) - 1, progress_name=progress_name, verbose=verbose):
        modelA_ref = align_models_ref[i]
        modelB_ref = align_models_ref[i + 1]
        morpho_model = Morpho_pairwise(
            sampleA=modelB_ref,
            sampleB=modelA_ref,
            rep_layer=rep_layer,
            rep_field=rep_field,
            dissimilarity=dissimilarity,
            genes=genes,
            spatial_key=key_added,
            key_added=key_added,
            iter_key_added=iter_key_added,
            vecfld_key_added=vecfld_key_added,
            max_iter=max_iter,
            device=device,
            verbose=verbose,
            **kwargs,
        )
        P = morpho_model.run()
        modelB_ref.obsm[f"{key_added}_rigid"] = morpho_model.optimal_RnA.copy()
        modelB_ref.obsm[f"{key_added}_nonrigid"] = morpho_model.XAHat.copy()
        modelB_ref.obsm[key_added] = modelB_ref.obsm[f"{key_added}_rigid" if mode == "SN-S" else f"{key_added}_nonrigid"]
        align_models_ref[i + 1] = modelB_ref
        pis_ref.append(P)

        modelB = align_models[i + 1]
        vecfld = morpho_model.vecfld
        if vecfld_key_added is not None:
            modelB_ref.uns[vecfld_key_added] = vecfld
            modelB.uns[vecfld_key_added] = vecfld
        nonrigid, _, rigid = BA_transform(vecfld=vecfld, quary_points=modelB.obsm[key_added], device=device)
        modelB.obsm[f"{key_added}_nonrigid"] = nonrigid
        modelB.obsm[f"{key_added}_rigid"] = rigid
        modelB.obsm[key_added] = modelB.obsm[f"{key_added}_rigid" if mode == "SN-S" else f"{key_added}_nonrigid"]
        pis.append(P)
    return align_models, align_models_ref, pis, pis_ref


def morpho_align_transformation(
    models: List[Union[AnnData, str]],
    models_path: Optional[str] = None,
    save_transformation: bool = False,
    transformation_path: str = "./Spateo_transformation",
    resume: bool = False,
    rep_layer: Union[str, List[str]] = "X",
    rep_field: Union[str, List[str]] = "layer",
    genes: Optional[List[str]] = None,
    spatial_key: str = "spatial",
    key_added: str = "align_spatial",
    iter_key_added: Optional[str] = "iter_spatial",
    vecfld_key_added: str = "VecFld_morpho",
    dissimilarity: Union[str, List[str]] = "kl",
    max_iter: int = 200,
    dtype: str = "float32",
    device: str = "cuda",
    verbose: bool = True,
    **kwargs,
) -> List[dict]:
    """Compute (and optionally checkpoint/resume) the per-pair rigid
    transformations of a slice chain (parity: reference
    morpho_alignment.py:114, resume logic :160-177)."""
    if models_path is not None:
        if not all(isinstance(m, str) for m in models):
            raise ValueError("models should be file names if models_path is given.")
        if not all(os.path.exists(os.path.join(models_path, m)) for m in models):
            raise FileNotFoundError("Some files do not exist.")
    elif not all(isinstance(m, AnnData) for m in models):
        raise ValueError("models should be AnnData if models_path is not given.")

    iteration = 0
    transformation: List[dict] = []
    if save_transformation:
        Path(transformation_path).mkdir(parents=True, exist_ok=True)
        if resume:
            for i in range(len(models) - 1):
                f = os.path.join(transformation_path, f"transformation_{i}.npy")
                if os.path.exists(f):
                    iteration = i + 1
                    transformation.append(np.load(f, allow_pickle=True).item())
        else:
            for f in os.listdir(transformation_path):
                os.unlink(os.path.join(transformation_path, f))

    def _load(i):
        if models_path is not None:
            return read_h5ad(os.path.join(models_path, models[i]))
        return models[i]

    progress_name = "Models alignment based on morpho (transformation-only)."
    for i in _iteration(start_n=iteration, n=len(models) - 1, progress_name=progress_name, verbose=verbose):
        modelA = _load(i)
        modelB = _load(i + 1)
        morpho_model = Morpho_pairwise(
            sampleA=modelB,
            sampleB=modelA,
            rep_layer=rep_layer,
            rep_field=rep_field,
            dissimilarity=dissimilarity,
            genes=genes,
            spatial_key=spatial_key,
            key_added=key_added,
            iter_key_added=iter_key_added,
            vecfld_key_added=vecfld_key_added,
            max_iter=max_iter,
            device=device,
            verbose=verbose,
            **kwargs,
        )
        morpho_model.run()
        optimal_R, optimal_t = solve_RT_by_correspondence(
            morpho_model.optimal_RnA[:, :2], np.asarray(modelB.obsm[spatial_key])[:, :2]
        )
        cur = {"Rotation": optimal_R, "Translation": optimal_t}
        transformation.append(cur)
        if save_transformation:
            np.save(os.path.join(transformation_path, f"transformation_{i}.npy"), cur)
    return transformation


def morpho_align_apply_transformation(
    models: List[Union[AnnData, str]],
    models_path: Optional[str] = None,
    transformation: Optional[List[dict]] = None,
    transformation_path: str = "./Spateo_transformation",
    spatial_key: str = "spatial",
    key_added: str = "align_spatial",
    save_models_path: Optional[str] = None,
    verbose: bool = True,
) -> Optional[List[AnnData]]:
    """Apply a saved chain of rigid transformations, composing R/t down the
    stack (parity: reference morpho_alignment.py:221, composition :300-303).
    Host-side numpy."""
    if models_path is not None:
        if not all(isinstance(m, str) for m in models):
            raise ValueError("models should be file names if models_path is given.")
    elif not all(isinstance(m, AnnData) for m in models):
        raise ValueError("models should be AnnData if models_path is not given.")

    if transformation is None:
        if not os.path.exists(transformation_path):
            raise FileNotFoundError("transformation_path does not exist.")
        transformation = [
            np.load(os.path.join(transformation_path, f"transformation_{i}.npy"), allow_pickle=True).item()
            for i in range(len(models) - 1)
        ]
    if len(transformation) != len(models) - 1:
        raise ValueError("len(transformation) should be len(models) - 1.")

    if save_models_path is not None:
        Path(save_models_path).mkdir(parents=True, exist_ok=True)

    def _load(i):
        if models_path is not None:
            return read_h5ad(os.path.join(models_path, models[i]))
        return models[i]

    align_models = []
    cur_model = _load(0).copy()
    cur_model.obsm[key_added] = np.asarray(cur_model.obsm[spatial_key]).copy()
    if save_models_path is not None:
        cur_model.write_h5ad(os.path.join(save_models_path, str(models[0])))
    align_models.append(cur_model)

    cur_R = np.eye(2)
    cur_t = np.zeros(2)
    progress_name = "Models alignment based on morpho, applying transformation."
    for i in _iteration(n=len(models) - 1, progress_name=progress_name, verbose=verbose):
        cur_model = _load(i + 1).copy()
        # compose the chain: x -> R_i (x) + t_i applied after the previous ones
        R_i = transformation[i]["Rotation"]
        t_i = transformation[i]["Translation"]
        cur_t = R_i @ cur_t + t_i if i > 0 else t_i
        cur_R = R_i @ cur_R if i > 0 else R_i
        coords = np.asarray(cur_model.obsm[spatial_key])[:, :2]
        cur_model.obsm[key_added] = coords @ cur_R.T + cur_t
        if save_models_path is not None:
            cur_model.write_h5ad(os.path.join(save_models_path, str(models[i + 1])))
        align_models.append(cur_model)
    if save_models_path is None:
        return align_models


def remove_all_files_in_directory(directory: str) -> None:
    """Clear a transformation-checkpoint directory (parity: reference
    morpho_alignment.py remove_all_files_in_directory)."""
    import os

    if not os.path.isdir(directory):
        return
    for f in os.listdir(directory):
        p = os.path.join(directory, f)
        if os.path.isfile(p):
            os.remove(p)
