"""Morphometric-field 3D plots (counterpart of
`spateo_tpu.plotting.three_d_plot.morphometrics_plots`; reference
spateo/plotting/static/three_d_plot/morphometrics_plots.py:55-886 — jacobian
/ feature / torsion / acceleration / curvature / curl / divergence, each
reading the differential-geometry result stashed by the
`st.tdr.morphofield_*` functions and coloring the model by it).

Host code, copied; matplotlib is imported inside the functions that draw,
since the GPU machine has none.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from .three_dims_plots import three_d_multi_plot, three_d_plot


def _model_obs_rows(adata, model) -> np.ndarray:
    """Row indices of `adata` for each model point (parity:
    morphometrics_plots.py:17 `_check_index_in_adata` — models built by
    st.tdr.construct_pc carry the source obs names in
    point_data['obs_index']; without it, rows map 1:1 or by nearest
    cell for resampled/voxelized models)."""
    if "obs_index" in model.point_data:
        import pandas as pd

        lookup = pd.Series(range(adata.n_obs), index=adata.obs.index)
        return lookup.loc[np.asarray(model.point_data["obs_index"])].values
    if len(model.points) == adata.n_obs:
        return np.arange(adata.n_obs)
    pts = np.asarray(adata.obsm.get("align_spatial", adata.obsm.get("spatial")))[:, :3]
    d2 = ((model.points[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return np.argmin(d2, axis=1)


def _attach_scalar(adata, model, key: str, where: str = "obs"):
    """Copy a per-cell scalar from adata onto the model's point_data,
    matched through obs_index (parity: morphometrics_plots.py:326-338)."""
    if where == "obs":
        if key not in adata.obs.columns:
            raise KeyError(f"`{key}` not found in .obs; run the matching st.tdr.morphofield_* function first.")
        vals = np.asarray(adata.obs[key], dtype=float)
    else:
        if key not in adata.obsm:
            raise KeyError(f"`{key}` not found in .obsm; run the matching st.tdr.morphofield_* function first.")
        vals = np.linalg.norm(np.asarray(adata.obsm[key], dtype=float), axis=1)
    models = model if isinstance(model, (list, tuple)) else [model]
    out = []
    for m in models:
        mc = m.copy()
        mc.point_data[key] = vals[_model_obs_rows(adata, mc)]
        out.append(mc)
    return out if isinstance(model, (list, tuple)) else out[0]


def _field_plot(adata, model, key, where, filename, jupyter, colormap, ambient, opacity, model_style, model_size, **kwargs):
    m = _attach_scalar(adata, model, key, where)
    cmap = "rainbow" if colormap in (None, "default_cmap") else colormap
    if isinstance(m, (list, tuple)):
        return three_d_multi_plot(m, key=key, filename=filename, jupyter=jupyter, colormap=cmap,
                                  ambient=ambient, opacity=opacity, model_style=model_style, model_size=model_size, **kwargs)
    return three_d_plot(m, key=key, filename=filename, jupyter=jupyter, colormap=cmap,
                        ambient=ambient, opacity=opacity, model_style=model_style, model_size=model_size, **kwargs)


def jacobian(
    adata,
    model,
    jacobian_key: str = "jacobian",
    filename: Optional[str] = None,
    jupyter: Union[bool, str] = False,
    colormap: Union[str, list, None] = "default_cmap",
    ambient: Union[float, list] = 0.2,
    opacity: Union[float, list] = 1.0,
    model_style: Union[str, list] = "points",
    model_size: Union[float, list] = 3.0,
    **kwargs,
):
    """3x3 panel of Jacobian components (parity: morphometrics_plots.py:55).
    Reads `.uns[jacobian_key]` ([N, D, D]) written by
    st.tdr.morphofield_jacobian."""
    J = np.asarray(adata.uns[jacobian_key]["jacobian"] if isinstance(adata.uns.get(jacobian_key), dict) else adata.uns[jacobian_key])
    if J.ndim == 3 and J.shape[1] == J.shape[0] and J.shape[0] != len(adata.obs):
        # reference layout: [D, D, N] (morphometrics_plots.py:183)
        J = np.moveaxis(J, -1, 0)
    D = J.shape[1]
    models, texts = [], []
    base = model[0] if isinstance(model, (list, tuple)) else model
    rows = _model_obs_rows(adata, base)
    f_names = ["fx", "fy", "fz"][:D]
    i_names = ["x", "y", "z"][:D]
    for i in range(D):
        for j in range(D):
            mc = base.copy()
            mc.point_data["jacobian"] = J[rows, i, j]
            models.append(mc)
            texts.append(f"∂{f_names[i]}/∂{i_names[j]}")
    cmap = "coolwarm" if colormap in (None, "default_cmap") else colormap
    return three_d_multi_plot(models, key="jacobian", filename=filename, jupyter=jupyter,
                              shape=(D, D), colormap=cmap, ambient=ambient, opacity=opacity,
                              model_style=model_style, model_size=model_size, text=texts, **kwargs)


def feature(
    adata,
    model,
    feature_key: str,
    filename: Optional[str] = None,
    jupyter: Union[bool, str] = False,
    colormap: Union[str, list, None] = "default_cmap",
    ambient: Union[float, list] = 0.2,
    opacity: Union[float, list] = 1.0,
    model_style: Union[str, list] = "points",
    model_size: Union[float, list] = 3.0,
    **kwargs,
):
    """Generic obs-scalar 3D plot (parity: morphometrics_plots.py:219)."""
    return _field_plot(adata, model, feature_key, "obs", filename, jupyter, colormap, ambient, opacity, model_style, model_size, **kwargs)


def torsion(adata, model, torsion_key: str = "torsion", **kwargs):
    """Torsion field plot (parity: morphometrics_plots.py:363)."""
    return feature(adata, model, torsion_key, **kwargs)


def acceleration(adata, model, acceleration_key: str = "acceleration", **kwargs):
    """Acceleration field plot (parity: morphometrics_plots.py:467)."""
    return feature(adata, model, acceleration_key, **kwargs)


def curvature(adata, model, curvature_key: str = "curvature", **kwargs):
    """Curvature field plot (parity: morphometrics_plots.py:572)."""
    return feature(adata, model, curvature_key, **kwargs)


def curl(adata, model, curl_key: str = "curl", **kwargs):
    """Curl field plot (parity: morphometrics_plots.py:677)."""
    return feature(adata, model, curl_key, **kwargs)


def divergence(adata, model, divergence_key: str = "divergence", **kwargs):
    """Divergence field plot (parity: morphometrics_plots.py:782)."""
    return feature(adata, model, divergence_key, **kwargs)
