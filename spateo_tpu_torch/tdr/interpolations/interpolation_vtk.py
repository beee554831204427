"""Shepard / Gaussian-kernel / linear interpolation of expression onto target
points (capability parity: reference
spateo/tdr/interpolations/interpolation_vtk.py:18, which wraps VTK's
vtkPointInterpolator; counterpart of
`spateo_tpu.tdr.interpolations.interpolation_vtk`).

`_interp_block` is one [query, source] weighted gather on the device, in
float32 with the JAX package's matmul-form distances; a target with no
source within the radius takes its nearest source's values. The default
radius (twice the median distance to the n-th neighbour) comes from the
host cKDTree, as in the JAX package. Blocks of targets fill one device array,
copied to the host once at the end.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import pandas as pd
import torch
from scipy.sparse import issparse

from ...core.anndata import AnnData
from ...core.bridge import _to_device


def _interp_block(query: torch.Tensor, source: torch.Tensor, values: torch.Tensor, radius: torch.Tensor,
                  kernel: str = "shepard", sharpness: float = 2.0, power: float = 2.0) -> torch.Tensor:
    """[Q, V] interpolated values of the `query` points from `source` and its
    `values`, on their device (the JAX package's `_interp_block`)."""
    d2 = (query**2).sum(1)[:, None] + (source**2).sum(1)[None, :] - 2 * (query @ source.T)
    d2 = torch.clamp(d2, min=0.0)
    if kernel == "shepard":
        w = 1.0 / torch.clamp(d2 ** (power / 2), min=1e-12)
    elif kernel == "gaussian":
        w = torch.exp(-((sharpness * torch.sqrt(d2) / radius) ** 2))
    elif kernel == "linear":
        w = torch.clamp(1.0 - torch.sqrt(d2) / radius, min=0.0)
    else:
        raise ValueError(f"Unsupported kernel {kernel}")
    w = torch.where(d2 <= radius**2, w, 0.0)
    wsum = w.sum(1, keepdim=True)
    nearest = torch.argmin(d2, dim=1)
    return torch.where(wsum > 0, (w @ values) / torch.clamp(wsum, min=1e-12), values[nearest])


def vtk_interpolation(
    source_adata: AnnData,
    target_points: Optional[np.ndarray] = None,
    keys: Union[str, list, None] = None,
    spatial_key: str = "spatial",
    layer: str = "X",
    radius: Optional[float] = None,
    n_points: Optional[int] = None,
    kernel: str = "shepard",
    null_strategy: int = 1,
    null_value: float = 0.0,
    block: int = 4096,
    device="cuda",
) -> AnnData:
    """Interpolate expression (and numeric obs columns) from source cells
    onto target points on `device` (parity: interpolation_vtk.py:18)."""
    source = np.asarray(source_adata.obsm[spatial_key], dtype=np.float32)
    if keys is None:
        keys = list(source_adata.var_names)
    keys = [keys] if isinstance(keys, str) else list(keys)
    obs_keys = [k for k in keys if k in source_adata.obs.columns]
    var_keys = [k for k in keys if k in source_adata.var_names]
    vals = []
    if var_keys:
        V = source_adata[:, np.asarray(var_keys)].X if layer == "X" else source_adata[:, np.asarray(var_keys)].layers[layer]
        vals.append(V.toarray() if issparse(V) else np.asarray(V, dtype=np.float32))
    for k in obs_keys:
        vals.append(np.asarray(source_adata.obs[k], dtype=np.float32).reshape(-1, 1))
    values = np.concatenate(vals, axis=1).astype(np.float32)

    target_points = np.asarray(target_points, dtype=np.float32)
    if radius is None:
        from scipy.spatial import cKDTree

        tree = cKDTree(source)
        k_n = n_points or 8
        radius = float(np.median(tree.query(source, k=min(k_n + 1, len(source)))[0][:, -1]) * 2)

    src_d = _to_device(source, device)
    val_d = _to_device(values, device)
    tgt_d = _to_device(target_points, device)
    rad_d = torch.tensor(radius, dtype=torch.float32, device=src_d.device)
    out_d = torch.empty((len(target_points), values.shape[1]), dtype=torch.float32, device=src_d.device)
    for s in range(0, len(target_points), block):
        out_d[s : s + block] = _interp_block(tgt_d[s : s + block], src_d, val_d, rad_d, kernel)
    out = out_d.cpu().numpy()

    interp_adata = AnnData(
        X=out[:, : len(var_keys)] if var_keys else np.zeros((len(target_points), 0)),
        obs=pd.DataFrame(index=[f"target_{i}" for i in range(len(target_points))]),
        var=pd.DataFrame(index=var_keys),
    )
    interp_adata.obsm[spatial_key] = target_points
    for i, k in enumerate(obs_keys):
        interp_adata.obs[k] = out[:, len(var_keys) + i]
    interp_adata.uns["__type"] = "UMI"
    return interp_adata
