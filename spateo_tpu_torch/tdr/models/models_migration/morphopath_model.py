"""Trajectory / genesis (time-lapse) models (capability parity: reference
spateo/tdr/models/models_migration/morphopath_model.py:84,274). A copy of
`spateo_tpu.tdr.models.models_migration.morphopath_model`; the sampling of
`construct_trajectory` is the port's `sample_indices`, whose k-means runs on
`device` (default ``"cuda"``)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np

from ....core.anndata import AnnData
from ....logging import logger_manager as lm
from ..mesh_core import PointCloud
from .primitives import LineModel


def construct_trajectory_X(
    cells_states: Union[np.ndarray, List[np.ndarray]],
    init_states: Optional[np.ndarray] = None,
    n_sampling: Optional[int] = None,
    sampling_method: str = "random",
    key_added: str = "trajectory",
    label: Optional[Union[str, list, np.ndarray]] = None,
    tip_factor: Union[int, float] = 5,
    tip_radius: float = 0.2,
    trajectory_color: Union[str, list, dict] = "gainsboro",
    tip_color: Union[str, list, dict] = "orangered",
    alpha: Union[float, list, dict] = 1.0,
) -> Tuple[LineModel, Optional[str]]:
    """Trajectory polylines from per-cell state sequences (parity:
    morphopath_model.py:157-271): per-trajectory index stored under
    f'{key_added}_id'; labels under `key_added` mark path points `label`
    (default 'trajectory') and the final states f'{label} tips', colored
    `trajectory_color` / `tip_color` with opacity `alpha` — the
    reference's streamline + tip-cone pair."""
    if isinstance(cells_states, np.ndarray):
        cells_states = [cells_states[:, i, :] if cells_states.ndim == 3 else cells_states for i in range(1)]
    base_label = label if isinstance(label, str) else "trajectory"
    all_pts, all_lines, traj_id, labels = [], [], [], []
    offset = 0
    for i, states in enumerate(cells_states):
        states = np.asarray(states, dtype=float)
        if states.ndim == 2 and states.shape[0] >= 2:
            T = states.shape[0]
            all_pts.append(states)
            all_lines.append(np.stack([np.arange(offset, offset + T - 1), np.arange(offset + 1, offset + T)], axis=1))
            traj_id.extend([i] * T)
            labels.extend([base_label] * (T - 1) + [f"{base_label} tips"])
            offset += T
    model = LineModel(np.concatenate(all_pts), np.concatenate(all_lines))
    model.point_data[f"{key_added}_id"] = np.asarray(traj_id)
    from ..utilities.label_utils import add_model_labels

    _, plot_cmap = add_model_labels(
        model, labels=np.asarray(labels, object), key_added=key_added, where="point_data",
        colormap={base_label: trajectory_color, f"{base_label} tips": tip_color},
        alphamap=alpha, inplace=True,
    )
    return model, plot_cmap


def construct_trajectory(
    adata: AnnData,
    fate_key: str = "fate_develop",
    n_sampling: Optional[int] = None,
    sampling_method: str = "random",
    key_added: str = "trajectory",
    label: Optional[Union[str, list, np.ndarray]] = None,
    tip_factor: Union[int, float] = 5,
    tip_radius: float = 0.2,
    trajectory_color: Union[str, list, dict] = "gainsboro",
    tip_color: Union[str, list, dict] = "orangered",
    alpha: float = 1.0,
    device="cuda",
) -> Tuple[LineModel, Optional[str]]:
    """Trajectory model from `st.tdr.morphopath` output (parity:
    morphopath_model.py:274-340)."""
    fate = adata.uns[fate_key]
    trajs = [np.asarray(p).T for p in fate["prediction"]]  # each [T, D]
    if n_sampling:
        from ....alignment.methods.sampling import sample_indices

        starts = np.stack([t[0] for t in trajs])
        idx = sample_indices(starts, n_sampling, method=sampling_method, device=device)
        trajs = [trajs[i] for i in idx]
    return construct_trajectory_X(
        trajs, key_added=key_added, label=label, tip_factor=tip_factor, tip_radius=tip_radius,
        trajectory_color=trajectory_color, tip_color=tip_color, alpha=alpha,
    )


def construct_genesis_X(
    stages_X: List[np.ndarray],
    n_spacing: Optional[int] = None,
    key_added: str = "genesis",
    label: Optional[list] = None,
    color: Union[str, list, dict] = "skyblue",
    alpha: Union[float, list, dict] = 1.0,
) -> Tuple[List[PointCloud], Optional[str]]:
    """Time-lapse point-cloud series (parity: morphopath_model.py:24-81 —
    per-stage labels resolved to RGBA via the same color/alpha contract as
    every other model constructor)."""
    from ..utilities.label_utils import add_model_labels

    models = []
    plot_cmap = None
    for i, X in enumerate(stages_X):
        pc = PointCloud(np.asarray(X, dtype=float))
        labels = np.full(len(X), label[i] if label else f"stage_{i}")
        _, plot_cmap = add_model_labels(
            pc, labels, key_added=key_added, colormap=color, alphamap=alpha, inplace=True
        )
        models.append(pc)
    return models, plot_cmap


def construct_genesis(
    adata: AnnData,
    fate_key: str = "fate_morpho",
    n_steps: int = 100,
    logspace: bool = False,
    t_end: Optional[float] = None,
    key_added: str = "genesis",
    label: Optional[list] = None,
    color: Union[str, list, dict] = "skyblue",
    alpha: Union[float, list, dict] = 1.0,
) -> Tuple[List[PointCloud], Optional[str]]:
    """Time-lapse of the developmental process from trajectories (parity:
    morphopath_model.py:84-114, incl. the color/alpha model-paint
    options)."""
    fate = adata.uns[fate_key]
    trajs = np.stack([np.asarray(p).T for p in fate["prediction"]])  # [N, T, D]
    T = trajs.shape[1]
    if logspace:
        steps = np.unique(np.geomspace(1, T, n_steps).astype(int) - 1)
    else:
        steps = np.linspace(0, T - 1, n_steps).astype(int)
    stages = [trajs[:, s, :] for s in steps]
    return construct_genesis_X(stages, key_added=key_added, label=label, color=color, alpha=alpha)
