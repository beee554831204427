"""Vector-field visualization models (capability parity: reference
spateo/tdr/models/models_migration/morphofield_model.py:18,71). The
counterpart of `spateo_tpu.tdr.models.models_migration.morphofield_model`:
`construct_field_streams` integrates every stream at once on `device`
(default ``"cuda"``) and reads the paths once, at the end."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch.func import vmap

from ....core.anndata import AnnData
from ....core.bridge import _to_device
from ....logging import logger_manager as lm
from .primitives import LineModel, construct_arrows


def construct_field(
    model,
    vf_key: str = "VecFld_morpho",
    arrows_scale_key: Optional[str] = None,
    n_sampling: Optional[int] = None,
    sampling_method: str = "random",
    factor: float = 1.0,
    key_added: str = "v_arrows",
    label: Union[str, list, np.ndarray] = "vector field",
    color: Union[str, list, dict] = "gainsboro",
    alpha: float = 1.0,
) -> Tuple[LineModel, Optional[str]]:
    """Arrow model of the morphofield (parity: morphofield_model.py:18).
    `model` may be an AnnData (uses .uns[vf_key]['X'/'V']) or an object with
    .points and a 'V' point_data entry."""
    if isinstance(model, AnnData):
        vf = model.uns[vf_key]
        X = np.asarray(vf["X"], dtype=float)
        V = np.asarray(vf["V"], dtype=float)
    else:
        X = np.asarray(model.points, dtype=float)
        V = np.asarray(model.point_data["V"], dtype=float)
    scale = None
    if arrows_scale_key is not None and isinstance(model, AnnData) and arrows_scale_key in model.uns.get(vf_key, {}):
        scale = np.linalg.norm(np.asarray(model.uns[vf_key][arrows_scale_key], float), axis=1)
    arrows, plot_cmap = construct_arrows(
        X, V, arrows_scale=scale, n_sampling=n_sampling, sampling_method=sampling_method,
        factor=factor, key_added=key_added, label=label, color=color, alpha=alpha,
    )
    return arrows, plot_cmap


def construct_field_streams(
    model,
    vf_key: str = "VecFld_morpho",
    source_center: Optional[np.ndarray] = None,
    source_radius: Optional[float] = None,
    tip_factor: Union[int, float] = 10,
    tip_radius: float = 0.2,
    key_added: str = "v_streams",
    label: str = "stream lines",
    stream_color: str = "gainsboro",
    tip_color: str = "orangered",
    alpha: float = 1.0,
    stream_kwargs: Optional[dict] = None,
    n_streams: int = 100,
    n_steps: int = 100,
    step_size: Optional[float] = None,
    seed: int = 0,
    device="cuda",
) -> Tuple[LineModel, Optional[str]]:
    """Streamlines through the field (parity: morphofield_model.py:71-142):
    RK2 integration from sampled seed points; stream points labeled `label`
    with `stream_color`, the final integration tips labeled
    f'{label} tips' with `tip_color` (the reference's separate tip model)."""
    from ...morphometrics.morphofield_dg.GPVectorField import _field_fn_from_dict

    vf = model.uns[vf_key] if isinstance(model, AnnData) else model
    fn = vmap(_field_fn_from_dict(dict(vf), device))
    X = np.asarray(vf["X"], dtype=np.float32)
    rng = np.random.default_rng(seed)
    seeds = X[rng.choice(len(X), min(n_streams, len(X)), replace=False)]
    if step_size is None:
        V = np.asarray(vf["V"])
        step_size = float(np.linalg.norm(X.max(0) - X.min(0)) / (np.median(np.linalg.norm(V, axis=1)) + 1e-12) / n_steps)

    cur = _to_device(seeds, device)
    pts = [cur]
    for _ in range(n_steps):
        k1 = fn(cur)
        k2 = fn(cur + step_size / 2 * k1)
        cur = cur + step_size * k2
        pts.append(cur)
    traj = torch.stack(pts).cpu().numpy()  # [T+1, S, D]
    all_pts = traj.transpose(1, 0, 2).reshape(-1, traj.shape[2])
    T = traj.shape[0]
    lines = []
    for s in range(traj.shape[1]):
        base = s * T
        lines.append(np.stack([np.arange(base, base + T - 1), np.arange(base + 1, base + T)], axis=1))
    model_out = LineModel(all_pts, np.concatenate(lines))
    # stream points vs integration tips, colored separately like the
    # reference's streamlines + tips pair
    labels = np.full(len(all_pts), label, dtype=object)
    tip_rows = np.arange(traj.shape[1]) * T + (T - 1)
    labels[tip_rows] = f"{label} tips"
    from ..utilities.label_utils import add_model_labels

    _, plot_cmap = add_model_labels(
        model_out, labels=labels, key_added=key_added, where="point_data",
        colormap={label: stream_color, f"{label} tips": tip_color}, alphamap=alpha, inplace=True,
    )
    return model_out, plot_cmap


def construct_field_plain(
    model,
    vf_key: str = "VecFld_morpho",
    key_added: str = "v_arrows",
    label: str = "vector field",
    **kwargs,
):
    """Plain (unscaled) vector-field arrow model (parity: reference
    morphofield_model.py construct_field_plain — construct_field without
    magnitude scaling)."""
    return construct_field(model, vf_key=vf_key, key_added=key_added, label=label, factor=1.0, **kwargs)
