"""PASTE (FGW-OT) slice alignment drivers (counterpart of
`spateo_tpu.alignment.paste_alignment`; reference
spateo/alignment/paste_alignment.py:14,97). Each pair's FGW runs on `device`
(default ``"cuda"``); the Procrustes fit and the transforms are host numpy."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..configuration import SKM
from ..core.anndata import AnnData
from .methods.paste import generalized_procrustes_analysis, paste_pairwise_align
from .transform import paste_transform
from .utils import _iteration, downsampling


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE, "models")
def paste_align(
    models: List[AnnData],
    layer: str = "X",
    genes: Optional[List[str]] = None,
    spatial_key: str = "spatial",
    key_added: str = "align_spatial",
    mapping_key_added: str = "models_align",
    alpha: float = 0.1,
    numItermax: int = 200,
    dtype: str = "float32",
    device="cuda",
    verbose: bool = True,
    **kwargs,
) -> Tuple[List[AnnData], List[np.ndarray]]:
    """Serial PASTE alignment (parity: reference paste_alignment.py:14)."""
    for m in models:
        m.obsm[key_added] = np.asarray(m.obsm[spatial_key])

    pis = []
    align_models = [model.copy() for model in models]
    for i in _iteration(n=len(align_models) - 1, progress_name="Models alignment", verbose=verbose):
        modelA = align_models[i]
        modelB = align_models[i + 1]
        pi, _ = paste_pairwise_align(
            sampleA=modelA.copy(),
            sampleB=modelB.copy(),
            layer=layer,
            genes=genes,
            spatial_key=key_added,
            alpha=alpha,
            numItermax=numItermax,
            device=device,
            verbose=verbose,
            **kwargs,
        )
        pis.append(pi)
        modelA_coords, modelB_coords, mapping_dict = generalized_procrustes_analysis(
            X=np.asarray(modelA.obsm[key_added]), Y=np.asarray(modelB.obsm[key_added]), pi=pi
        )
        if i == 0:
            modelA.obsm[key_added] = modelA_coords
            modelA.uns[mapping_key_added] = mapping_dict
        modelB.obsm[key_added] = modelB_coords
        modelB.uns[mapping_key_added] = mapping_dict
    return align_models, pis


@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE, "models")
@SKM.check_adata_is_type(SKM.ADATA_UMI_TYPE, "models_ref", optional=True)
def paste_align_ref(
    models: List[AnnData],
    models_ref: Optional[List[AnnData]] = None,
    n_sampling: Optional[int] = 2000,
    sampling_method: str = "trn",
    layer: str = "X",
    genes: Optional[List[str]] = None,
    spatial_key: str = "spatial",
    key_added: str = "align_spatial",
    mapping_key_added: str = "models_align",
    alpha: float = 0.1,
    numItermax: int = 200,
    dtype: str = "float32",
    device="cuda",
    verbose: bool = True,
    **kwargs,
) -> Tuple[List[AnnData], List[AnnData], List[np.ndarray]]:
    """PASTE on downsampled refs, then transform the full models with the
    stored mapping (parity: reference paste_alignment.py:97)."""
    if models_ref is None:
        models_sampling = [model.copy() for model in models]
        models_ref = downsampling(
            models=models_sampling, n_sampling=n_sampling, sampling_method=sampling_method, spatial_key=spatial_key,
            device=device,
        )

    align_models_ref, pis = paste_align(
        models=models_ref,
        layer=layer,
        genes=genes,
        spatial_key=spatial_key,
        key_added=key_added,
        mapping_key_added=mapping_key_added,
        alpha=alpha,
        numItermax=numItermax,
        device=device,
        verbose=verbose,
        **kwargs,
    )
    align_models = []
    for i, model in enumerate(models):
        model = model.copy()
        if i == 0:
            model.obsm[key_added] = np.asarray(model.obsm[spatial_key])
        else:
            model = paste_transform(
                adata=model,
                adata_ref=align_models_ref[i],
                spatial_key=spatial_key,
                key_added=key_added,
                mapping_key=mapping_key_added,
            )
        align_models.append(model)
    return align_models, align_models_ref, pis
