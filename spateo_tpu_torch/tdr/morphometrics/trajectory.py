"""Cell-fate trajectory integration through the morphofield (counterpart of
`spateo_tpu.tdr.morphometrics.trajectory`; reference
spateo/tdr/morphometrics/morphofield/trajectory.py:11): fixed-step RK4 for
all cells at once on the device, one host copy of the whole trajectory."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import vmap

from ...core.anndata import AnnData
from ...core.bridge import _to_device
from .morphofield_dg.GPVectorField import _field_fn_from_dict


def _rk4_integrate(fn, X0: torch.Tensor, dt: float, n_steps: int) -> torch.Tensor:
    """[n_steps, N, D] positions after each of `n_steps` RK4 steps of `dt`."""
    vf = vmap(fn)
    traj = torch.empty((n_steps,) + tuple(X0.shape), dtype=X0.dtype, device=X0.device)
    x = X0
    for k in range(n_steps):
        k1 = vf(x)
        k2 = vf(x + dt / 2 * k1)
        k3 = vf(x + dt / 2 * k2)
        k4 = vf(x + dt * k3)
        x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        traj[k] = x
    return traj


def morphopath(
    adata: AnnData,
    vf_key: str = "VecFld_morpho",
    key_added: str = "fate_morpho",
    layer: str = "X",
    direction: str = "forward",
    interpolation_num: int = 250,
    t_end: Optional[float] = None,
    average: bool = False,
    cores: int = 1,
    inplace: bool = True,
    device="cuda",
    **kwargs,
) -> Optional[AnnData]:
    """Integrate trajectories of all cells through the learned field on
    `device` (parity: trajectory.py:11)."""
    adata = adata if inplace else adata.copy()
    vf_dict = adata.uns[vf_key]
    fn = _field_fn_from_dict(dict(vf_dict), device)
    X0 = np.asarray(vf_dict["X"], dtype=np.float32)
    if t_end is None:
        # heuristic: traverse the data diameter at the median speed
        V = np.asarray(vf_dict["V"])
        speed = np.median(np.linalg.norm(V, axis=1)) + 1e-12
        diameter = np.linalg.norm(X0.max(0) - X0.min(0))
        t_end = float(diameter / speed)
    dt = t_end / interpolation_num
    sign = -1.0 if direction == "backward" else 1.0
    traj = _rk4_integrate(fn, _to_device(X0, device), sign * dt, interpolation_num).cpu().numpy()
    traj = np.concatenate([X0[None], traj], axis=0)  # [T+1, N, D]
    t = np.linspace(0, t_end, interpolation_num + 1)
    adata.uns[key_added] = {
        "t": t,
        "prediction": [traj[:, i, :].T for i in range(traj.shape[1])],
        "X": X0,
        "direction": direction,
    }
    if average:
        adata.uns[key_added]["average"] = traj.mean(axis=1)
    return None if inplace else adata
