"""Identify cell-occupied pixels (Starro stage 1).

Counterpart of `spateo_tpu.segmentation.icell`:

- `score_and_mask_pixels` takes the fused EM+BP program (`starro_em_bp`)
  under the JAX package's exact condition (EM+BP with no bins, certain mask,
  threshold, knee, Moran or VI options), else the staged path: `_score_pixels`
  (gauss, moran, em, em+gauss, em+bp, vi+gauss, vi+bp, with bins and a
  certain mask), then an Otsu threshold, a given one, or the knee, and close
  and open. With ``mesh=`` (a `torch.distributed` device mesh) the fused
  path runs sharded, the raster's rows split over the mesh's ranks
  (`starro.starro_em_bp_sharded`); the staged path ignores it, as in the
  JAX package.
- `mask_cells_from_stain` and `mask_nuclei_from_stain` threshold a stain
  image with multi-Otsu (and a local Gaussian surface) and close and open it.

The stages chain device tensors on ``device=``; the density raster comes to
the host once, where the NB fits draw their downsample with numpy. The AnnData
layers written are host arrays. The JAX package's `vi+gauss` reads an EM
result it never made (it raises `UnboundLocalError`); here it takes the VI
mixture's own posterior.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from scipy.sparse import issparse, spmatrix

from ..configuration import SKM
from ..core.anndata import AnnData
from ..core.bridge import _to_device
from ..errors import SegmentationError
from ..logging import logger_manager as lm
from ..ops import em
from ..ops.bp import _run_bp_t
from ..ops.image import _as_tensor, conv2d, mclose_mopen, scale_to_01
from ..ops.threshold import threshold_local, threshold_multiotsu, threshold_otsu
from . import vi
from .moran import _run_moran
from .starro import starro_em_bp
from .utils import _apply_threshold

_METHODS = ("gauss", "moran", "em", "em+gauss", "em+bp", "vi+gauss", "vi+bp")
_EM_KEYS = (("downsample", "downsample"), ("max_iter", "em_max_iter"), ("precision", "em_precision"), ("seed", "seed"))
_BP_KEYS = (
    ("k", "bp_k"), ("square", "bp_square"), ("p", "bp_p"), ("q", "bp_q"),
    ("precision", "bp_precision"), ("max_iter", "bp_max_iter"),
)


def _mask_cells_from_stain(X, otsu_classes: int = 3, otsu_index: int = 0, mk: int = 7, device="cuda") -> torch.Tensor:
    """Multi-Otsu global threshold, then close and open."""
    X = _as_tensor(X, device)
    thresholds = threshold_multiotsu(X, classes=otsu_classes)
    return mclose_mopen(X >= float(thresholds[otsu_index]), mk)


def _mask_nuclei_from_stain(
    X, otsu_classes: int = 3, otsu_index: int = 0, local_k: int = 55, offset: int = -5, mk: int = 5, device="cuda",
) -> torch.Tensor:
    """Global multi-Otsu background and an adaptive local foreground."""
    X = _as_tensor(X, device)
    thresholds = threshold_multiotsu(X, classes=otsu_classes)
    background_mask = X < float(thresholds[otsu_index])
    local_surface = threshold_local(X, local_k, method="gaussian", offset=offset)
    return mclose_mopen((X.to(torch.float32) > local_surface) & ~background_mask, mk)


def _stain(adata: AnnData, layer: str):
    if layer not in adata.layers:
        raise SegmentationError(
            f'Layer "{layer}" does not exist in AnnData. '
            "Please import nuclei staining results either manually or "
            "with the `stain_path` argument to `st.io.read_bgi_agg`."
        )
    return SKM.select_layer_data(adata, layer, make_dense=True)


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def mask_cells_from_stain(
    adata: AnnData,
    otsu_classes: int = 3,
    otsu_index: int = 0,
    mk: int = 7,
    layer: str = SKM.STAIN_LAYER_KEY,
    out_layer: Optional[str] = None,
    device="cuda",
):
    """Boolean cell mask from a staining image."""
    X = _stain(adata, layer)
    lm.main_info("Constructing cell mask from staining image.")
    mask = _mask_cells_from_stain(X, otsu_classes, otsu_index, mk, device)
    SKM.set_layer_data(adata, out_layer or SKM.gen_new_layer_key(layer, SKM.MASK_SUFFIX), mask.cpu().numpy())


@SKM.check_adata_is_type(SKM.ADATA_AGG_TYPE)
def mask_nuclei_from_stain(
    adata: AnnData,
    otsu_classes: int = 3,
    otsu_index: int = 0,
    local_k: int = 55,
    offset: int = 5,
    mk: int = 5,
    layer: str = SKM.STAIN_LAYER_KEY,
    out_layer: Optional[str] = None,
    device="cuda",
):
    """Boolean nuclei mask from a staining image."""
    X = _stain(adata, layer)
    lm.main_info("Constructing nuclei mask from staining image.")
    mask = _mask_nuclei_from_stain(X, otsu_classes, otsu_index, local_k, -offset, mk, device)
    SKM.set_layer_data(adata, out_layer or SKM.gen_new_layer_key(layer, SKM.MASK_SUFFIX), mask.cpu().numpy())


def _initial_nb_params(
    X, bins=None
) -> Union[Dict[str, Tuple[float, float]], Dict[int, Dict[str, Tuple[float, float]]]]:
    """Otsu-split initial estimates for the NB mixture, per bin with `bins`,
    on the host as in the JAX package. `X` and `bins` may be tensors or host
    arrays."""
    Xh = em._host(X)
    samples = {0: Xh.ravel()} if bins is None else em._split_by_bin(Xh, em._host(bins))

    params = {}
    for label, _samples in samples.items():
        threshold = max(threshold_otsu(_samples, device="cpu"), 1)
        mask = _samples > threshold
        background_values = _samples[~mask]
        foreground_values = _samples[mask]
        w = np.array([_samples.size - mask.sum(), mask.sum()]) / _samples.size
        mu = np.array([background_values.mean(), foreground_values.mean() if mask.any() else threshold * 2.0])
        var = np.array([background_values.var(), foreground_values.var() if mask.any() else threshold * 4.0])
        for i, name in ((0, "background"), (1, "foreground")):
            if var[i] <= mu[i]:
                lm.main_warning(
                    f"Bin {label} estimated variance of {name} ({var[i]:.2e}) is less than the mean ({mu[i]:.2e}). "
                    "Initial variance will be arbitrarily set to 1.1x of the mean."
                )
                var[i] = mu[i] * 1.1
        params[label] = dict(w=tuple(w), mu=tuple(mu), var=tuple(var))
    return params[0] if bins is None else params


def _score_pixels(
    X: Union[spmatrix, np.ndarray],
    k: int,
    method: str,
    moran_kwargs: Optional[dict] = None,
    em_kwargs: Optional[dict] = None,
    vi_kwargs: Optional[dict] = None,
    bp_kwargs: Optional[dict] = None,
    certain_mask: Optional[np.ndarray] = None,
    bins: Optional[np.ndarray] = None,
    device="cuda",
) -> torch.Tensor:
    """Score each pixel's likelihood of being a cell in [0, 1]: an f32
    tensor on `device`."""
    if method.lower() not in _METHODS:
        raise SegmentationError(f"Unknown method `{method}`")
    if certain_mask is not None and X.shape != certain_mask.shape:
        raise SegmentationError("`certain_mask` does not have the same shape as `X`")
    if bins is not None and X.shape != bins.shape:
        raise SegmentationError("`bins` does not have the same shape as `X`")

    method = method.lower()
    moran_kwargs, em_kwargs, vi_kwargs, bp_kwargs = (d or {} for d in (moran_kwargs, em_kwargs, vi_kwargs, bp_kwargs))
    for kwargs, name in ((moran_kwargs, "moran"), (em_kwargs, "em"), (vi_kwargs, "vi"), (bp_kwargs, "bp")):
        if kwargs and name not in method:
            lm.main_warning(f"`{name}_kwargs` will be ignored.")

    if issparse(X):
        X = X.toarray()
    Xd = _to_device(np.asarray(X, dtype=np.float32), device)
    bins_d = None if bins is None else _to_device(np.asarray(bins), device)
    res = conv2d(Xd, k, mode="gauss" if method in ("gauss", "moran") else "circle", bins=bins_d)

    if method == "gauss":
        return scale_to_01(res)
    if method == "moran":
        res = _run_moran(res, mask=None if bins is None else bins_d > 0, **moran_kwargs)
        return res / res.max()

    # the NB fits draw their downsample on the host, from one copy of res
    res_h = res.cpu().numpy()
    params = _initial_nb_params(res_h, bins)
    if "em" in method:
        em_results = em.run_em(res_h, bins=bins, device=device, **dict(dict(params=params), **em_kwargs))
        cond = lambda: em.conditionals(res, em_results, bins_d)
        posterior = lambda: em.confidence(res, em_results, bins_d)
    else:
        vi_results = vi.run_vi(res_h, bins=bins, device=device, **dict(dict(params=params), **vi_kwargs))
        cond = lambda: vi._conditionals_t(res, vi_results, bins_d)
        posterior = lambda: vi._confidence_t(res, vi_results, bins_d)
    certain = None if certain_mask is None else _to_device(np.asarray(certain_mask, bool), device)

    if "bp" in method:
        background_cond, cell_cond = cond()
        if certain is not None:
            background_cond = torch.where(certain, 1e-2, background_cond)
            cell_cond = torch.where(certain, 1 - 1e-2, cell_cond)
        res = _run_bp_t(background_cond, cell_cond, **bp_kwargs)
    else:
        res = posterior()
        if certain is not None:
            res = torch.clamp(res + certain, 0, 1)
    if "gauss" in method:
        res = conv2d(res, k, mode="gauss", bins=bins_d)
    return res


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
    `scores_layer` / `mask_layer`) as host arrays.

    ``mesh``: a `torch.distributed.device_mesh.DeviceMesh`; the fused EM+BP
    path then runs sharded over its ranks, each rank calling this with the
    same AnnData and writing the same layers. It sets where the ranks run: a
    `device` of another type raises. The staged path ignores it."""
    if mesh is not None:
        from ..parallel._collectives import check_device

        check_device(mesh, device)
    X = SKM.select_layer_data(adata, layer, make_dense=True)
    certain_mask = None
    if certain_layer:
        certain_mask = np.asarray(SKM.select_layer_data(adata, certain_layer)).astype(bool)
    bins = None
    if bins_layer is not False:
        bins_layer = bins_layer or SKM.gen_new_layer_key(layer, SKM.BINS_SUFFIX)
        if bins_layer in adata.layers:
            bins = np.asarray(SKM.select_layer_data(adata, bins_layer))
    method = method.lower()
    lm.main_info(f"Scoring pixels with {method} method.")
    scores_layer = scores_layer or SKM.gen_new_layer_key(layer, SKM.SCORES_SUFFIX)
    mask_layer = mask_layer or SKM.gen_new_layer_key(layer, SKM.MASK_SUFFIX)

    if (
        method == "em+bp"
        and bins is None
        and certain_mask is None
        and threshold is None
        and not use_knee
        and not (moran_kwargs or vi_kwargs)
    ):
        fused_kwargs = {}
        for kwargs, keys in ((em_kwargs or {}, _EM_KEYS), (bp_kwargs or {}, _BP_KEYS)):
            for src, dst in keys:
                if src in kwargs:
                    fused_kwargs[dst] = kwargs[src]
        if mesh is not None:
            from .starro import starro_em_bp_sharded

            scores, mask = starro_em_bp_sharded(np.asarray(X), mesh=mesh, k=k, mk=mk or k + 2, **fused_kwargs)
        else:
            scores, mask = starro_em_bp(np.asarray(X), k=k, mk=mk or k + 2, device=device, **fused_kwargs)
            scores, mask = scores.cpu().numpy(), mask.cpu().numpy()
        SKM.set_layer_data(adata, scores_layer, scores)
        SKM.set_layer_data(adata, mask_layer, mask)
        return

    scores = _score_pixels(X, k, method, moran_kwargs, em_kwargs, vi_kwargs, bp_kwargs, certain_mask, bins, device)
    SKM.set_layer_data(adata, scores_layer, scores.cpu().numpy())
    if not threshold and not use_knee:
        threshold = threshold_otsu(scores)
        lm.main_info(f"Applying threshold {threshold}.")
    mk = mk or (k + 2 if any(m in method for m in ("em", "vi")) else max(k - 2, 3))
    if use_knee:
        threshold = None
    mask = _apply_threshold(scores, mk, threshold)
    if certain_layer:
        mask = mask | _to_device(certain_mask, mask.device)
    SKM.set_layer_data(adata, mask_layer, mask.cpu().numpy())
