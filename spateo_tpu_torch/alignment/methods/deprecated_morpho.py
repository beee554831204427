"""Back-compat shims for the reference's deprecated functional alignment API.

The reference keeps 5,347 LoC of superseded solver code
(reference spateo/alignment/methods/deprecated_morpho.py `BA_align`,
deprecated_morpho_sparse.py `BA_align_sparse`) purely so old scripts keep
running; its own `methods/__init__.py:1-2` no longer exports them (the
imports are commented out), so the only reachable entry points are direct
module imports. This module provides those entry points as thin shims onto
the maintained `Morpho_pairwise` solver: same signatures, same AnnData
side effects (`{key_added}_nonrigid` / `{key_added}_rigid` in
`sampleB.obsm`, vecfld dict in `sampleB.uns`), same
`((sampleA, sampleB), P.T)` return — re-solved by the current EM rather
than the frozen old code path (deprecated_morpho.py:560-652). A copy of
`spateo_tpu.alignment.methods.deprecated_morpho` on the port's
`Morpho_pairwise` (`device` defaults to "cuda"); P comes back to the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
from scipy.sparse import issparse

from ...core.anndata import AnnData
from ...logging import logger_manager as lm
from .morpho import Morpho_pairwise, _np

__all__ = ["BA_align", "BA_align_sparse"]


def BA_align(
    sampleA: AnnData,
    sampleB: AnnData,
    rep_layer: Union[str, List[str]] = "X",
    rep_field: Union[str, List[str]] = "layer",
    genes: Optional[List[str]] = None,
    spatial_key: str = "spatial",
    key_added: str = "align_spatial",
    iter_key_added: Optional[str] = None,
    save_concrete_iter: bool = False,
    vecfld_key_added: Optional[str] = None,
    dissimilarity: Union[str, List[str]] = "kl",
    probability_type: Union[str, List[str]] = "gauss",
    probability_parameters: Optional[Union[float, List[float]]] = None,
    label_transfer_dict: Optional[Union[dict, List[dict]]] = None,
    nn_init: bool = True,
    allow_flip: bool = False,
    init_layer: str = "X",
    init_field: str = "layer",
    max_iter: int = 200,
    SVI_mode: bool = True,
    batch_size: int = 1000,
    pre_compute_dist: bool = True,
    sparse_calculation_mode: bool = False,
    lambdaVF: Union[int, float] = 1e2,
    beta: Union[int, float] = 0.01,
    K: Union[int, float] = 15,
    sigma2_init_scale: Optional[Union[int, float]] = 0.1,
    partial_robust_level: float = 25,
    normalize_c: bool = True,
    normalize_g: bool = True,
    dtype: str = "float32",
    device: str = "cuda",
    verbose: bool = True,
    guidance_pair: Optional[Union[List[np.ndarray], np.ndarray]] = None,
    guidance_effect: Optional[Union[bool, str]] = False,
    guidance_epsilon: float = 1,
) -> Tuple[Tuple[AnnData, AnnData], np.ndarray]:
    """Deprecated-API shim (signature parity: reference
    deprecated_morpho.py:221). Delegates to `Morpho_pairwise`; the old
    solver's numerics are superseded, the contract is preserved."""
    lm.main_warning(
        "BA_align is the reference's deprecated entry point; it now delegates "
        "to Morpho_pairwise. Prefer spateo_tpu_torch.alignment.morpho_align / "
        "Morpho_pairwise directly."
    )
    model = Morpho_pairwise(
        sampleA=sampleA,
        sampleB=sampleB,
        rep_layer=rep_layer,
        rep_field=rep_field,
        genes=genes,
        spatial_key=spatial_key,
        key_added=key_added,
        iter_key_added=iter_key_added,
        save_concrete_iter=save_concrete_iter,
        vecfld_key_added=vecfld_key_added,
        dissimilarity=dissimilarity,
        probability_type=probability_type,
        probability_parameters=probability_parameters,
        label_transfer_dict=label_transfer_dict,
        nn_init=nn_init,
        allow_flip=allow_flip,
        init_layer=init_layer,
        init_field=init_field,
        max_iter=max_iter,
        SVI_mode=SVI_mode,
        batch_size=batch_size,
        pre_compute_dist=pre_compute_dist,
        sparse_calculation_mode=sparse_calculation_mode,
        lambdaVF=lambdaVF,
        beta=beta,
        K=int(K),
        sigma2_init_scale=sigma2_init_scale if sigma2_init_scale is not None else 0.1,
        partial_robust_level=partial_robust_level,
        normalize_c=normalize_c,
        normalize_g=normalize_g,
        dtype=dtype,
        device=device,
        verbose=verbose,
        guidance_pair=guidance_pair,
        guidance_effect=guidance_effect,
        guidance_weight=guidance_epsilon,
    )
    P = model.run()
    # side effects mirror deprecated_morpho.py:620-622 exactly
    sampleB.obsm[f"{key_added}_nonrigid"] = np.asarray(model.XAHat).copy()
    sampleB.obsm[f"{key_added}_rigid"] = np.asarray(model.optimal_RnA).copy()
    if vecfld_key_added is not None:
        sampleB.uns[vecfld_key_added] = model.vecfld
    return (sampleA, sampleB), (P.T if issparse(P) else _np(P).T)


def BA_align_sparse(*args, **kwargs) -> Tuple[Tuple[AnnData, AnnData], np.ndarray]:
    """Deprecated-API shim (signature parity: reference
    deprecated_morpho_sparse.py:147): `BA_align` with the top-k sparse
    assignment mode forced on."""
    kwargs["sparse_calculation_mode"] = True
    return BA_align(*args, **kwargs)
