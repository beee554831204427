"""Identify cell-occupied pixels (Starro stage 1): the EM+BP fast path.

Counterpart of `spateo_tpu.segmentation.icell.score_and_mask_pixels` on its
fused EM+BP path, with the same mapping of `em_kwargs` and `bp_kwargs` onto
`starro_em_bp`. The staged methods and options that leave that path are not
ported yet and raise `NotImplementedError` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ..configuration import SKM
from ..core.anndata import AnnData
from ..logging import logger_manager as lm
from .starro import starro_em_bp

_STAGED = "the staged scoring methods, ROADMAP Queue 1 item 9"
_EM_KEYS = (("downsample", "downsample"), ("max_iter", "em_max_iter"), ("precision", "em_precision"), ("seed", "seed"))
_BP_KEYS = (
    ("k", "bp_k"), ("square", "bp_square"), ("p", "bp_p"), ("q", "bp_q"),
    ("precision", "bp_precision"), ("max_iter", "bp_max_iter"),
)


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def score_and_mask_pixels(
    adata: AnnData,
    layer: str,
    k: int,
    method: str,
    moran_kwargs: Optional[dict] = None,
    em_kwargs: Optional[dict] = None,
    vi_kwargs: Optional[dict] = None,
    bp_kwargs: Optional[dict] = None,
    threshold: Optional[float] = None,
    use_knee: Optional[bool] = False,
    mk: Optional[int] = None,
    bins_layer: Optional[Union[bool, str]] = None,
    certain_layer: Optional[str] = None,
    scores_layer: Optional[str] = None,
    mask_layer: Optional[str] = None,
    mesh=None,
    device="cuda",
):
    """Score pixels by how likely a cell occupies them and mask them, on
    `device`; writes the ``{layer}_scores`` and ``{layer}_mask`` layers (or
    `scores_layer` / `mask_layer`) as host arrays."""
    method = method.lower()
    if method != "em+bp":
        raise NotImplementedError(f"method {method!r}: only 'EM+BP' is ported; see {_STAGED}")
    bins_key = bins_layer or SKM.gen_new_layer_key(layer, SKM.BINS_SUFFIX)
    # options that leave the fused path, each with the ROADMAP item that ports it
    unported = (
        ("density bins", bins_layer is not False and bins_key in adata.layers, _STAGED),
        ("certain_layer", certain_layer is not None, _STAGED),
        ("threshold", threshold is not None, _STAGED),
        ("use_knee", bool(use_knee), _STAGED),
        ("moran_kwargs / vi_kwargs", bool(moran_kwargs or vi_kwargs), _STAGED),
        ("mesh", mesh is not None, "the multi-device paths, ROADMAP Queue 1 item 13"),
    )
    for what, present, item in unported:
        if present:
            raise NotImplementedError(f"{what}: not ported yet; see {item}")
    lm.main_info(f"Scoring pixels with {method} method.")

    X = SKM.select_layer_data(adata, layer, make_dense=True)
    fused_kwargs = {}
    for kwargs, keys in ((em_kwargs or {}, _EM_KEYS), (bp_kwargs or {}, _BP_KEYS)):
        for src, dst in keys:
            if src in kwargs:
                fused_kwargs[dst] = kwargs[src]
    scores, mask = starro_em_bp(np.asarray(X), k=k, mk=mk or k + 2, device=device, **fused_kwargs)
    SKM.set_layer_data(adata, scores_layer or SKM.gen_new_layer_key(layer, SKM.SCORES_SUFFIX), scores.cpu().numpy())
    SKM.set_layer_data(adata, mask_layer or SKM.gen_new_layer_key(layer, SKM.MASK_SUFFIX), mask.cpu().numpy())
