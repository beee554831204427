"""The AnnData schema registry (SKM) that the slice uses.

Counterpart of the SKM half of `spateo_tpu.configuration`: the same key
vocabulary (``__type``, ``AGG``/``UMI``, layer suffixes), so layers written by
either package carry the same names. The JAX package's device mesh, x64 switch
and compilation cache have no counterpart here.
"""

from __future__ import annotations

import functools
import inspect
from typing import Optional, Tuple, Union

import numpy as np
from scipy import sparse

from .core.anndata import AnnData
from .errors import ConfigurationError
from .logging import logger_manager as lm


class SpateoAdataKeyManager:
    """Every AnnData key the slice reads or writes."""

    ADATA_TYPE_KEY = "__type"
    ADATA_DEFAULT_TYPE = None
    ADATA_AGG_TYPE = "AGG"  # aggregated UMI counts on a pixel raster
    ADATA_UMI_TYPE = "UMI"  # obs x genes (canonical)

    UNS_PP_KEY = "pp"
    UNS_SPATIAL_KEY = "spatial"
    UNS_SPATIAL_BINSIZE_KEY = "binsize"
    UNS_SPATIAL_SCALE_KEY = "scale"
    UNS_SPATIAL_SCALE_UNIT_KEY = "scale_unit"
    UNS_SPATIAL_ALIGNMENT_KEY = "alignment"
    UNS_SPATIAL_QC_KEY = "qc"

    SPLICED_LAYER_KEY = "spliced"
    UNSPLICED_LAYER_KEY = "unspliced"
    STAIN_LAYER_KEY = "stain"
    LABELS_LAYER_KEY = "labels"
    MASK_SUFFIX = "mask"
    MARKERS_SUFFIX = "markers"
    DISTANCES_SUFFIX = "distances"
    BINS_SUFFIX = "bins"
    LABELS_SUFFIX = "labels"
    SCORES_SUFFIX = "scores"
    EXPANDED_SUFFIX = "expanded"
    AUGMENTED_SUFFIX = "augmented"
    BOUNDARY_SUFFIX = "boundary"

    X_LAYER = "X"

    @staticmethod
    def gen_new_layer_key(layer_name: str, key: str, sep: str = "_") -> str:
        if layer_name == "":
            return key
        if layer_name[-1] == sep:
            return layer_name + key
        return sep.join([layer_name, key])

    @staticmethod
    def select_layer_data(
        adata: AnnData, layer: Optional[str], copy: bool = False, make_dense: bool = False
    ) -> Union[np.ndarray, sparse.spmatrix]:
        if layer is None:
            layer = SpateoAdataKeyManager.X_LAYER
        if layer == SpateoAdataKeyManager.X_LAYER:
            res_data = adata.X
        else:
            res_data = adata.layers[layer]
        if make_dense and sparse.issparse(res_data):
            return res_data.toarray()
        if copy:
            return res_data.copy()
        return res_data

    @staticmethod
    def set_layer_data(
        adata: AnnData,
        layer: str,
        vals: np.ndarray,
        var_indices: Optional[np.ndarray] = None,
        replace: bool = False,
    ):
        lm.main_info_insert_adata_layer(layer)
        vals = np.asarray(vals) if not sparse.issparse(vals) else vals
        if replace:
            adata.layers[layer] = vals
            return
        if var_indices is None:
            var_indices = slice(None)
        if layer == SpateoAdataKeyManager.X_LAYER:
            adata.X[:, var_indices] = vals
        elif layer in adata.layers:
            target = adata.layers[layer]
            if isinstance(target, np.ndarray) and not target.flags.writeable:
                target = target.copy()
                adata.layers[layer] = target
            target[:, var_indices] = vals
        else:
            adata.layers[layer] = vals

    @staticmethod
    def get_adata_type(adata: AnnData) -> str:
        return adata.uns[SpateoAdataKeyManager.ADATA_TYPE_KEY]

    @staticmethod
    def adata_is_type(adata: AnnData, t: str) -> bool:
        return SpateoAdataKeyManager.get_adata_type(adata) == t

    @staticmethod
    def check_adata_is_type(t: str, argname: str = "adata", optional: bool = False):
        def decorator(func):
            @functools.wraps(func)
            def wrapper(*args, **kwargs):
                unwrapped = inspect.unwrap(func)
                call_args = inspect.getcallargs(unwrapped, *args, **kwargs)
                adata = call_args[argname]
                if isinstance(adata, (list, tuple)):
                    passing = all(SpateoAdataKeyManager.adata_is_type(a, t) for a in adata)
                elif isinstance(adata, AnnData):
                    passing = SpateoAdataKeyManager.adata_is_type(adata, t)
                else:
                    passing = False
                if (not optional or adata is not None) and not passing:
                    if isinstance(adata, (list, tuple)):
                        raise ConfigurationError(
                            f"AnnDatas provided to `{argname}` must be of `{t}` type, but some are not."
                        )
                    elif isinstance(adata, AnnData):
                        raise ConfigurationError(
                            f"AnnData provided to `{argname}` must be of `{t}` type, but received "
                            f"`{SpateoAdataKeyManager.get_adata_type(adata)}` type."
                        )
                    raise ConfigurationError(f"`{argname}` is not an AnnData object, but {type(adata)}.")
                return func(*args, **kwargs)

            return wrapper

        return decorator

    @staticmethod
    def init_adata_type(adata: AnnData, t: Optional[str] = None):
        if t is None:
            t = SpateoAdataKeyManager.ADATA_DEFAULT_TYPE
        adata.uns[SpateoAdataKeyManager.ADATA_TYPE_KEY] = t

    @staticmethod
    def init_uns_pp_namespace(adata: AnnData):
        adata.uns.setdefault(SpateoAdataKeyManager.UNS_PP_KEY, {})

    @staticmethod
    def init_uns_spatial_namespace(adata: AnnData):
        adata.uns.setdefault(SpateoAdataKeyManager.UNS_SPATIAL_KEY, {})

    @staticmethod
    def set_uns_spatial_attribute(adata: AnnData, key: str, value: object):
        SpateoAdataKeyManager.init_uns_spatial_namespace(adata)
        adata.uns[SpateoAdataKeyManager.UNS_SPATIAL_KEY][key] = value

    @staticmethod
    def get_uns_spatial_attribute(adata: AnnData, key: str) -> object:
        return adata.uns[SpateoAdataKeyManager.UNS_SPATIAL_KEY][key]

    @staticmethod
    def get_agg_bounds(adata: AnnData) -> Tuple[int, int, int, int]:
        """(xmin, xmax, ymin, ymax) for AGG-type AnnDatas."""
        atype = SpateoAdataKeyManager.get_adata_type(adata)
        if atype != SpateoAdataKeyManager.ADATA_AGG_TYPE:
            raise ConfigurationError(f"AnnData has incorrect type: {atype}")
        return (
            int(adata.obs_names[0]),
            int(adata.obs_names[-1]),
            int(adata.var_names[0]),
            int(adata.var_names[-1]),
        )


SKM = SpateoAdataKeyManager
