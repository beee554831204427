"""AnnData-level differential-geometry wrappers (counterpart of
`spateo_tpu.tdr.morphometrics.morphofield_dg.differential_geometry`;
reference spateo/tdr/morphometrics/morphofield_dg/differential_geometry.py:42-341).

Every wrapper takes the reference's ``method`` ('analytical': forward-mode
autodiff; 'numerical': central finite differences) and ``nonrigid_only``
(differentiate only the deformation of a Morpho-learned field), and computes
on `device`."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ....core.anndata import AnnData
from .GPVectorField import GPVectorField


def _get_vf(adata: AnnData, vf_key: str, nonrigid_only: bool, device) -> GPVectorField:
    vf = GPVectorField(device=device)
    vf.from_adata(adata, vf_key=vf_key, nonrigid_only=nonrigid_only)
    return vf


def morphofield_velocity(
    adata: AnnData,
    vf_key: str = "VecFld_morpho",
    key_added: str = "velocity",
    nonrigid_only: bool = False,
    inplace: bool = True,
    device="cuda",
) -> Optional[AnnData]:
    """Velocities at the cells' positions (parity: differential_geometry.py:42)."""
    adata = adata if inplace else adata.copy()
    vf = _get_vf(adata, vf_key, nonrigid_only, device)
    adata.obsm[key_added] = vf.compute_velocity(vf.get_X())
    return None if inplace else adata


def morphofield_acceleration(
    adata: AnnData,
    vf_key: str = "VecFld_morpho",
    key_added: str = "acceleration",
    method: str = "analytical",
    nonrigid_only: bool = False,
    inplace: bool = True,
    device="cuda",
) -> Optional[AnnData]:
    """J v acceleration (parity: differential_geometry.py:73)."""
    adata = adata if inplace else adata.copy()
    vf = _get_vf(adata, vf_key, nonrigid_only, device)
    acc, acc_norm = vf.compute_acceleration(method=method, return_all=True)
    adata.obsm[key_added] = acc
    adata.obs[key_added] = acc_norm
    return None if inplace else adata


def morphofield_curvature(
    adata: AnnData,
    vf_key: str = "VecFld_morpho",
    key_added: str = "curvature",
    formula: int = 2,
    method: str = "analytical",
    nonrigid_only: bool = False,
    inplace: bool = True,
    device="cuda",
) -> Optional[AnnData]:
    """Curvature (parity: differential_geometry.py:116)."""
    adata = adata if inplace else adata.copy()
    vf = _get_vf(adata, vf_key, nonrigid_only, device)
    kur, kur_norm = vf.compute_curvature(formula=formula, method=method)
    adata.obsm[key_added] = kur
    adata.obs[key_added] = kur_norm
    return None if inplace else adata


def morphofield_curl(
    adata: AnnData,
    vf_key: str = "VecFld_morpho",
    key_added: str = "curl",
    method: str = "analytical",
    nonrigid_only: bool = False,
    inplace: bool = True,
    device="cuda",
) -> Optional[AnnData]:
    """Curl: `.obs` magnitude + `.obsm` vectors in 3-D, the scalar in `.obs`
    in 2-D (parity: differential_geometry.py:160-202)."""
    adata = adata if inplace else adata.copy()
    vf = _get_vf(adata, vf_key, nonrigid_only, device)
    curl = vf.compute_curl(method=method)
    if curl.ndim == 2:
        adata.obsm[key_added] = curl
        adata.obs[key_added] = np.linalg.norm(curl, axis=1)
    else:
        adata.obs[key_added] = curl
    return None if inplace else adata


def morphofield_torsion(
    adata: AnnData,
    vf_key: str = "VecFld_morpho",
    key_added: str = "torsion",
    method: str = "analytical",
    nonrigid_only: bool = False,
    inplace: bool = True,
    device="cuda",
) -> Optional[AnnData]:
    """Torsion: per-cell [D, D] torsion matrices in `.uns`, their norms in
    `.obs` (differential_geometry.py:205-247; matrix form per
    GPVectorField.py:74-95)."""
    adata = adata if inplace else adata.copy()
    vf = _get_vf(adata, vf_key, nonrigid_only, device)
    torsion_mat = vf.compute_torsion(method=method)
    adata.obs[key_added] = np.array([np.linalg.norm(i) for i in torsion_mat])
    adata.uns[key_added] = torsion_mat
    return None if inplace else adata


def morphofield_divergence(
    adata: AnnData,
    vf_key: str = "VecFld_morpho",
    key_added: str = "divergence",
    method: str = "analytical",
    vectorize_size: Optional[int] = 1000,
    nonrigid_only: bool = False,
    inplace: bool = True,
    device="cuda",
) -> Optional[AnnData]:
    """Divergence (parity: differential_geometry.py:250-295)."""
    adata = adata if inplace else adata.copy()
    vf = _get_vf(adata, vf_key, nonrigid_only, device)
    adata.obs[key_added] = vf.compute_divergence(method=method, vectorize_size=vectorize_size)
    return None if inplace else adata


def morphofield_jacobian(
    adata: AnnData,
    vf_key: str = "VecFld_morpho",
    key_added: str = "jacobian",
    method: str = "analytical",
    nonrigid_only: bool = False,
    inplace: bool = True,
    device="cuda",
) -> Optional[AnnData]:
    """Per-cell Jacobians: the [N, D, D] tensor in `.uns`, determinants in
    `.obs` (parity: differential_geometry.py:298-341)."""
    adata = adata if inplace else adata.copy()
    vf = _get_vf(adata, vf_key, nonrigid_only, device)
    J = vf.get_Jacobian(method=method)(vf.get_X())
    adata.uns[key_added] = J
    adata.obs[key_added + "_det"] = np.linalg.det(J)
    return None if inplace else adata
