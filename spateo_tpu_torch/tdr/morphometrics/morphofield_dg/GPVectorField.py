"""Differential geometry of learned vector fields, by autodiff on the device
(counterpart of `spateo_tpu.tdr.morphometrics.morphofield_dg.GPVectorField`;
reference spateo/tdr/morphometrics/morphofield_dg/GPVectorField.py:12-260:
acceleration :12, curvature :35, curl :55, torsion :74, divergence :97,
sensitivity :124, `Jacobian_GP_gaussian_kernel` :143, `GPVectorField` :193).

Every differential operator comes from `torch.func.jacfwd` of the
single-point field function, vmapped over the points, as the JAX package
does with `jax.jacfwd`; 'numerical' takes central differences of step 1e-2
in float32."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ....core.bridge import _to_device


def _field_fn_from_dict(vf_dict: dict, device="cuda") -> Callable:
    """Single-point field evaluation on `device` for either field flavour
    (a SparseVFC field, or a Morpho field under ``method="gaussian_process"``)."""
    T = lambda a: _to_device(np.asarray(a, dtype=np.float32), device)
    method = vf_dict.get("method", "sparsevfc")
    if method == "gaussian_process":
        norm = vf_dict["norm_dict"]
        mean_t, scale_t = T(norm["mean_transformed"]), T(norm["scale_transformed"])
        mean_f, scale_f = T(norm["mean_fixed"]), T(norm["scale_fixed"])
        inducing, Coff = T(vf_dict["inducing_variables"]), T(vf_dict["Coff"])
        R, t = T(vf_dict["R"]), T(vf_dict["t"])
        beta = float(vf_dict["beta"])
        nonrigid_only = bool(vf_dict.get("nonrigid_only", False))

        def fn(x):
            norm_x = (x - mean_t) / scale_t
            K = torch.exp(-beta * torch.sum((norm_x[None, :] - inducing) ** 2, dim=1))
            vel = K @ Coff
            if nonrigid_only:
                out = vel * scale_f + (scale_f - scale_t) * norm_x
            else:
                rigid = norm_x @ R.T + t
                out = (vel + rigid) * scale_f + mean_f - x
            return out / 10000.0

        return fn

    ctrl, C = T(vf_dict["X_ctrl"]), T(vf_dict["C"])
    beta = float(vf_dict["beta"])

    def fn(x):
        K = torch.exp(-beta * torch.sum((x[None, :] - ctrl) ** 2, dim=1))
        return K @ C

    return fn


def _on_points(f, device):
    """`f` of a [n, D] point tensor, called with a host array and returning one."""
    return lambda X: f(_to_device(np.atleast_2d(np.asarray(X, dtype=np.float32)), device)).cpu().numpy()


def compute_acceleration(vf, f_jac, X, Js=None, return_all: bool = False):
    """a = J v (parity: GPVectorField.py:12)."""
    X = np.asarray(X, np.float32)
    V = vf(X)
    J = f_jac(X)
    acc = np.einsum("nij,nj->ni", J, V)
    if return_all:
        return acc, np.linalg.norm(acc, axis=1)
    return acc


def compute_curvature(vf, f_jac, X, Js=None, formula: int = 2):
    """kappa = (J v x v) terms (parity: GPVectorField.py:35)."""
    X = np.asarray(X, np.float32)
    V = vf(X)
    a = compute_acceleration(vf, f_jac, X)
    v_norm2 = np.sum(V**2, axis=1, keepdims=True)
    if formula == 1:
        kur = a / np.maximum(v_norm2, 1e-12)
    else:
        proj = np.sum(a * V, axis=1, keepdims=True) * V / np.maximum(v_norm2, 1e-12)
        kur = (a - proj) / np.maximum(v_norm2, 1e-12)
    return kur, np.linalg.norm(kur, axis=1)


def compute_curl(f_jac, X):
    """Curl from the Jacobian: a vector in 3-D, the scalar z component in
    2-D (parity: GPVectorField.py:55)."""
    J = f_jac(np.asarray(X, np.float32))
    if J.shape[1] == 2:
        return J[:, 1, 0] - J[:, 0, 1]
    return np.stack([J[:, 2, 1] - J[:, 1, 2], J[:, 0, 2] - J[:, 2, 0], J[:, 1, 0] - J[:, 0, 1]], axis=1)


def compute_torsion(vf, f_jac, X):
    """Per-cell torsion matrices (parity: GPVectorField.py:74-95: the
    reference's tau_i = outer(v,a)·(J a)/||outer(v,a)||² vector
    row-broadcast into a [D, D] block)."""
    X = np.asarray(X, np.float32)
    if X.shape[1] != 3:
        raise ValueError("torsion is only defined in 3 dimensions.")
    V = vf(X)
    J = f_jac(X)
    a = np.einsum("nij,nj->ni", J, V)
    Ja = np.einsum("nij,nj->ni", J, a)
    outer = V[:, :, None] * a[:, None, :]
    vec = np.einsum("nij,nj->ni", outer, Ja)
    denom = np.maximum(np.sum(outer**2, axis=(1, 2)), 1e-12)
    tau_vec = vec / denom[:, None]
    return np.broadcast_to(tau_vec[:, None, :], (len(X), 3, 3)).copy()


def compute_divergence(f_jac, X: np.ndarray, Js=None, vectorize_size: Optional[int] = 1000) -> np.ndarray:
    """div = tr(J) in blocks of `vectorize_size` points (parity:
    GPVectorField.py:97); None takes all points at once."""
    X = np.asarray(X, np.float32)
    if vectorize_size is None:
        vectorize_size = len(X)
    out = np.zeros(len(X), np.float32)
    for s in range(0, len(X), vectorize_size):
        J = f_jac(X[s : s + vectorize_size])
        out[s : s + J.shape[0]] = np.trace(J, axis1=1, axis2=2)
    return out


def compute_sensitivity(f_jac, X):
    """Element-wise response sensitivity from the Jacobian (parity:
    GPVectorField.py:124): S_ij = |J_ij| / sum_k |J_ik|."""
    J = f_jac(np.asarray(X, np.float32))
    absJ = np.abs(J)
    return absJ / np.maximum(absJ.sum(axis=2, keepdims=True), 1e-12)


def Jacobian_GP_gaussian_kernel(X: np.ndarray, vf_dict: dict, vectorize: bool = False, device="cuda") -> np.ndarray:
    """Jacobian of the field at X by forward-mode autodiff (parity surface:
    GPVectorField.py:143)."""
    return _on_points(vmap(jacfwd(_field_fn_from_dict(vf_dict, device))), device)(X)


class GPVectorField:
    """Vector field + differential geometry on `device` (parity surface:
    GPVectorField.py:193)."""

    def __init__(self, device="cuda"):
        self.device = device
        self.vf_dict = {}

    def from_adata(self, adata, vf_key: str = "VecFld", nonrigid_only: bool = False):
        if vf_key not in adata.uns:
            raise KeyError(f"`{vf_key}` not found in `.uns`. Run a morphofield function first.")
        self.vf_dict = dict(adata.uns[vf_key])
        if nonrigid_only:
            self.vf_dict["nonrigid_only"] = True
        self._fn = _field_fn_from_dict(self.vf_dict, self.device)
        self._vf = vmap(self._fn)
        self._jac = vmap(jacfwd(self._fn))
        self.data = {"X": np.asarray(self.vf_dict.get("X")), "V": np.asarray(self.vf_dict.get("V"))}

    def get_data(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.data["X"], self.data["V"]

    def get_X(self):
        return self.data["X"]

    def get_V(self):
        return self.data["V"]

    def compute_velocity(self, X: np.ndarray) -> np.ndarray:
        return _on_points(self._vf, self.device)(X)

    def get_Jacobian(self, method: str = "analytical", **kwargs) -> Callable:
        """'analytical' = forward-mode autodiff (exact for any kernel);
        'numerical' = central finite differences of step `step` (default
        1e-2), the reference's numdifftools route (GPVectorField.py:236-249),
        kept so that the two schemes can be checked against each other."""
        if method == "numerical":
            step = kwargs.get("step", 1e-2)

            def num_jac(X):
                n, D = X.shape
                eye = torch.eye(D, dtype=X.dtype, device=X.device) * step
                plus = self._vf((X[:, None, :] + eye).reshape(n * D, D)).reshape(n, D, -1)  # f(x + h e_j)
                minus = self._vf((X[:, None, :] - eye).reshape(n * D, D)).reshape(n, D, -1)
                return ((plus - minus) / (2 * step)).transpose(1, 2)  # J_ij = d f_i / d x_j

            return _on_points(num_jac, self.device)
        return _on_points(self._jac, self.device)

    def compute_acceleration(self, X: Optional[np.ndarray] = None, method: str = "analytical", **kwargs):
        X = self.data["X"] if X is None else X
        return compute_acceleration(self.compute_velocity, self.get_Jacobian(method=method), X, **kwargs)

    def compute_curvature(self, X: Optional[np.ndarray] = None, formula: int = 2, method: str = "analytical",
                          **kwargs):
        X = self.data["X"] if X is None else X
        return compute_curvature(self.compute_velocity, self.get_Jacobian(method=method), X, formula=formula, **kwargs)

    def compute_curl(self, X: Optional[np.ndarray] = None, method: str = "analytical", **kwargs):
        X = self.data["X"] if X is None else X
        return compute_curl(self.get_Jacobian(method=method), X)

    def compute_torsion(self, X: Optional[np.ndarray] = None, method: str = "analytical", **kwargs) -> np.ndarray:
        X = self.data["X"] if X is None else X
        return compute_torsion(self.compute_velocity, self.get_Jacobian(method=method), X)

    def compute_divergence(self, X: Optional[np.ndarray] = None, method: str = "analytical", **kwargs) -> np.ndarray:
        X = self.data["X"] if X is None else X
        return compute_divergence(self.get_Jacobian(method=method), X, **kwargs)

    def compute_sensitivity(self, X: Optional[np.ndarray] = None, method: str = "analytical",
                            **kwargs) -> np.ndarray:
        X = self.data["X"] if X is None else X
        return compute_sensitivity(self.get_Jacobian(method=method), X)
