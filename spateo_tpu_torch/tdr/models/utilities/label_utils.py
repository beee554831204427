"""Model label/color utilities (capability parity: reference
spateo/tdr/models/utilities/label_utils.py). A copy of
`spateo_tpu.tdr.models.utilities.label_utils` whose colors resolve through
`colors.py` (matplotlib's rules, without matplotlib: the GPU machine has
none); matplotlib is imported only to sample a colormap."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from .colors import COLORMAP_NAMES, colormap_hex, to_hex, to_rgba


def add_model_labels(
    model,
    labels: np.ndarray,
    key_added: str = "groups",
    where: str = "point_data",
    colormap: Union[str, list, dict, np.ndarray, None] = "rainbow",
    alphamap: Union[float, list, dict, np.ndarray, None] = 1.0,
    mask_color: str = "gainsboro",
    mask_alpha: float = 0.0,
    inplace: bool = False,
) -> Tuple[Optional[object], Optional[str]]:
    """Attach labels (and, for categorical labels, a resolved RGBA column
    f'{key_added}_rgba') to a model.

    Reference contract (label_utils.py:13-107): categorical labels resolve to
    RGBA here — a matplotlib colormap NAME spreads over the sorted unique
    labels, any other string is a uniform color, dict/list map per label, and
    'mask' entries get mask_color/mask_alpha — with plot_cmap None; NUMERIC
    labels are stored as-is and the colormap is handed back as plot_cmap for
    the plotting layer to resolve. Returns (model or None-if-inplace,
    plot_cmap)."""
    m = model if inplace else model.copy()
    labels = np.asarray(labels).flatten()

    if not np.issubdtype(labels.dtype, np.number):
        cu_arr = np.sort(np.unique(labels), axis=0).astype(object)
        raw_hex = labels.copy().astype(object)
        raw_alpha = labels.copy().astype(object)
        raw_hex[raw_hex == "mask"] = to_hex(mask_color)
        raw_alpha[raw_alpha == "mask"] = mask_alpha

        if isinstance(colormap, str):
            if colormap in COLORMAP_NAMES:
                hex_list = colormap_hex(colormap, len(cu_arr))
                for label, color in zip(cu_arr, hex_list):
                    raw_hex[raw_hex == label] = color
            else:
                raw_hex[raw_hex != to_hex(mask_color)] = to_hex(colormap)
        elif isinstance(colormap, dict):
            for label, color in colormap.items():
                raw_hex[raw_hex == label] = to_hex(color)
        elif isinstance(colormap, (list, np.ndarray)):
            hex_list = np.array([to_hex(color) for color in colormap]).astype(object)
            for label, color in zip(cu_arr, hex_list):
                raw_hex[raw_hex == label] = color
        else:
            raise ValueError("`colormap` value is wrong.\nAvailable `colormap` types are: `str`, `list` and `dict`.")

        if isinstance(alphamap, (int, float)):
            raw_alpha[raw_alpha != mask_alpha] = alphamap
        elif isinstance(alphamap, dict):
            for label, alpha in alphamap.items():
                raw_alpha[raw_alpha == label] = alpha
        elif isinstance(alphamap, (list, np.ndarray)):
            for label, alpha in zip(cu_arr, np.asarray(alphamap)):
                raw_alpha[raw_alpha == label] = alpha
        else:
            raise ValueError("`alphamap` value is wrong.\nAvailable `alphamap` types are: `float`, `list` and `dict`.")

        rgba = np.array(
            [to_rgba(c, alpha=float(a)) for c, a in zip(raw_hex, raw_alpha)], dtype=np.float32
        )
        getattr(m, where)[f"{key_added}_rgba"] = rgba
        plot_cmap = None
    else:
        plot_cmap = colormap

    getattr(m, where)[key_added] = labels
    return (m if not inplace else None), plot_cmap
